"""Plain PyTorch versions of the batch-reduce GEMMs.

``matmul_ref``:         C   = act(alpha * X @ W + beta * C0 + bias)
``brgemm_ref``:         C   = act(alpha * sum_i A_i @ B_i + beta * C0 + bias)
``batched_matmul_ref``: C_i = act(alpha * A_i @ B_i + bias), either operand
                        2-D and broadcast over the batch

with fp32 accumulation, as ``repro/kernels/brgemm/ref.py``: the
inputs may be bf16 or fp32, the product and the epilogue run in fp32, and
the result is cast to ``out_dtype`` (default: the input dtype).  The
epilogue order is the kernel's: alpha, beta * c0, bias, activation, cast.
This is the CPU path and, on the card, the version the CUDA kernel is held
against.  Upcasting to fp32 before the product makes every bf16 product
exact, so only the order of the fp32 sums differs from the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import fusion


def _finish(acc, c0, bias, alpha, beta, activation, out_dtype):
    acc = acc * alpha
    if c0 is not None and beta != 0.0:
        acc = acc + beta * c0.float()
    if bias is not None:
        acc = acc + bias.float()
    return fusion.apply(activation, acc).to(out_dtype)


def matmul_ref(x, w, bias=None, *, activation: str = "none",
               alpha: float = 1.0, beta: float = 0.0, c0=None,
               out_dtype=None):
    """x: (m, k), w: (k, n) -> (m, n)."""
    acc = torch.matmul(x.float(), w.float())
    return _finish(acc, c0, bias, alpha, beta, activation,
                   out_dtype or x.dtype)


def brgemm_ref(a, b, bias=None, *, activation: str = "none",
               alpha: float = 1.0, beta: float = 0.0, c0=None,
               out_dtype=None):
    """a: (B, m, k), b: (B, k, n) -> (m, n), summed over the batch."""
    acc = torch.einsum("imk,ikn->mn", a.float(), b.float())
    return _finish(acc, c0, bias, alpha, beta, activation,
                   out_dtype or a.dtype)


def batched_matmul_ref(a, b, bias=None, *, activation: str = "none",
                       alpha: float = 1.0, out_dtype=None):
    """a: (B, m, k) or (m, k); b: (B, k, n) or (k, n) -> (B, m, n)."""
    acc = torch.matmul(a.float(), b.float())
    return _finish(acc, None, bias, alpha, 0.0, activation,
                   out_dtype or a.dtype)

"""Plain PyTorch version of the batch-reduce GEMM.

``C = act(alpha * X @ W + beta * C0 + bias)`` with fp32 accumulation: the
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


def matmul_ref(x, w, bias=None, *, activation: str = "none",
               alpha: float = 1.0, beta: float = 0.0, c0=None,
               out_dtype=None):
    """x: (m, k), w: (k, n) -> (m, n)."""
    out_dtype = out_dtype or x.dtype
    acc = torch.matmul(x.float(), w.float()) * alpha
    if c0 is not None and beta != 0.0:
        acc = acc + beta * c0.float()
    if bias is not None:
        acc = acc + bias.float()
    return fusion.apply(activation, acc).to(out_dtype)

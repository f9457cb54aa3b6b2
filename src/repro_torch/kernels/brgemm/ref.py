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

``accum=torch.bfloat16`` is the reference's XLA path under bf16 accumulation
(``preferred_element_type=bf16``): the product rounded to bf16 once,
before the fp32 epilogue.  ``round_k`` instead gives the blockwise version
that the kernels are held against under bf16 accumulation: the fp32 sum
rounded to bf16 in place at the end of every ``round_k`` elements of k
(and at k's end), batch entry by batch entry for ``brgemm_ref``, as the
kernels round at the reference's block ends (``blocking.accum_block``).
Used by the tests and ``chip_smoke.py`` only.
"""
from __future__ import annotations

import torch

from repro_torch.core import fusion


def bf16_round(t):
    """fp32 ``t`` rounded to bf16 (to nearest even) and back."""
    return t.to(torch.bfloat16).float()


def _product(a, b, accum, round_k):
    """fp32 a @ b (batched as torch.matmul): rounded once to bf16 with
    ``accum`` bf16, or rounded in place every ``round_k`` of k."""
    a, b = a.float(), b.float()
    if not round_k:
        acc = torch.matmul(a, b)
        return bf16_round(acc) if accum == torch.bfloat16 else acc
    k = a.shape[-1]
    acc = None
    for k0 in range(0, max(k, 1), round_k):
        part = torch.matmul(a[..., k0:k0 + round_k], b[..., k0:k0 + round_k,
                                                        :])
        acc = bf16_round(part if acc is None else acc + part)
    return acc


def _finish(acc, c0, bias, alpha, beta, activation, out_dtype):
    acc = acc * alpha
    if c0 is not None and beta != 0.0:
        acc = acc + beta * c0.float()
    if bias is not None:
        acc = acc + bias.float()
    return fusion.apply(activation, acc).to(out_dtype)


def matmul_ref(x, w, bias=None, *, activation: str = "none",
               alpha: float = 1.0, beta: float = 0.0, c0=None,
               out_dtype=None, accum=torch.float32, round_k: int = 0):
    """x: (m, k), w: (k, n) -> (m, n)."""
    acc = _product(x, w, accum, round_k)
    return _finish(acc, c0, bias, alpha, beta, activation,
                   out_dtype or x.dtype)


def brgemm_ref(a, b, bias=None, *, activation: str = "none",
               alpha: float = 1.0, beta: float = 0.0, c0=None,
               out_dtype=None, accum=torch.float32, round_k: int = 0):
    """a: (B, m, k), b: (B, k, n) -> (m, n), summed over the batch."""
    if round_k:
        acc = a.new_zeros((a.shape[1], b.shape[2]), dtype=torch.float32)
        for i in range(a.shape[0]):
            for k0 in range(0, a.shape[2], round_k):
                acc = bf16_round(acc + a[i, :, k0:k0 + round_k].float()
                                 @ b[i, k0:k0 + round_k].float())
    else:
        acc = torch.einsum("imk,ikn->mn", a.float(), b.float())
        if accum == torch.bfloat16:
            acc = bf16_round(acc)
    return _finish(acc, c0, bias, alpha, beta, activation,
                   out_dtype or a.dtype)


def batched_matmul_ref(a, b, bias=None, *, activation: str = "none",
                       alpha: float = 1.0, out_dtype=None,
                       accum=torch.float32, round_k: int = 0):
    """a: (B, m, k) or (m, k); b: (B, k, n) or (k, n) -> (B, m, n)."""
    acc = _product(a, b, accum, round_k)
    return _finish(acc, None, bias, alpha, 0.0, activation,
                   out_dtype or a.dtype)

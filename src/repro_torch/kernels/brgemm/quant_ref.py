"""Plain PyTorch versions of the quantized batch-reduce GEMMs.

``matmul_q_ref``:         C   = act(alpha * (Xq @ Wq) * (sx x sw) + bias)
``brgemm_q_ref``:         C   = act(alpha * (sum_i Aq_i @ Bq_i) * (sa x sb)
                                    + bias), batch-shared scales
``batched_matmul_q_ref``: C_i = act(alpha * (Aq_i @ Bq_i) * (sa_i x sb_i)
                                    + bias), either operand 2-D and broadcast

as ``repro/kernels/brgemm/quant.py`` (``matmul_q_ref``, ``brgemm_q_ref``,
``batched_matmul_q_ref``) computes them, in the reference's epilogue order:
the product in fp32, times the scale outer product ``sx x sw``, times
alpha, plus bias, the activation, the cast.  The operands are already
quantized; int8 or fp8 is read from their dtype.

The int8 product is taken exactly in float64 on both devices and then
rounded to fp32: ``torch.matmul`` of int8 tensors returns int8 and wraps,
and on CUDA it has no int32 form.  Every sum fits (|sum| < k * 127^2 <
2^53), and float64 -> fp32 rounds as int32 -> fp32 does, so this equals the
kernel's int32 accumulator bit for bit.  fp8 is upcast to fp32 before the
product, as the reference's ``_ref_dot`` does: every fp8 value is exact in
fp32, so only the order of the fp32 sums differs from the kernel.
``batched_matmul_q_ref`` upcasts a few entries at a time
(``CHUNK_BYTES`` of the widened B), so a full-width expert stack needs no
float64 copy of itself; the entries are independent, so the values are
those of one product.
"""
from __future__ import annotations

import torch

from repro_torch.core import fusion

CHUNK_BYTES = 1 << 30


def _exact(t: torch.Tensor) -> torch.Tensor:
    return t.double() if t.dtype == torch.int8 else t.float()


def _finish(acc, row_scale, col_scale, bias, alpha, activation, out_dtype):
    scale = row_scale.float()[..., :, None] * col_scale.float()[..., None, :]
    acc = acc.float() * scale * alpha
    if bias is not None:
        acc = acc + bias.float()
    return fusion.apply(activation, acc).to(out_dtype)


def matmul_q_ref(xq, wq, sx, sw, bias=None, *, activation: str = "none",
                 alpha: float = 1.0, out_dtype=torch.float32):
    """xq: (m, k), wq: (k, n); sx: (m,), sw: (n,) fp32 -> (m, n)."""
    acc = torch.matmul(_exact(xq), _exact(wq))
    return _finish(acc, sx, sw, bias, alpha, activation, out_dtype)


def brgemm_q_ref(aq, bq, sa, sb, bias=None, *, activation: str = "none",
                 alpha: float = 1.0, out_dtype=torch.float32):
    """aq: (B, m, k), bq: (B, k, n); sa: (m,), sb: (n,) -> (m, n), summed
    over the batch."""
    acc = torch.einsum("imk,ikn->mn", _exact(aq), _exact(bq))
    return _finish(acc, sa, sb, bias, alpha, activation, out_dtype)


def batched_matmul_q_ref(aq, bq, sa, sb, bias=None, *,
                         activation: str = "none", alpha: float = 1.0,
                         out_dtype=torch.float32):
    """aq: (B, m, k) or (m, k); bq: (B, k, n) or (k, n); sa: (B, m) or (m,);
    sb: (B, n) or (n,) -> (B, m, n)."""
    nb = aq.shape[0] if aq.dim() == 3 else bq.shape[0]
    k, n = bq.shape[-2:]
    step = max(1, CHUNK_BYTES // (8 * k * n))
    if nb <= step:
        acc = torch.matmul(_exact(aq), _exact(bq))
        return _finish(acc, sa, sb, bias, alpha, activation, out_dtype)

    def entries(t, i, rank):
        return t[i:i + step] if t.dim() == rank else t

    return torch.cat([batched_matmul_q_ref(
        entries(aq, i, 3), entries(bq, i, 3), entries(sa, i, 2),
        entries(sb, i, 2), bias, activation=activation, alpha=alpha,
        out_dtype=out_dtype) for i in range(0, nb, step)])

"""Quantized-GEMM routing: the port of ``repro/kernels/brgemm/quant.py``.

It sits between the public entry points (``ops.py``) and the two versions
of each quantized GEMM: the Hopper kernel (``quant_kernel.py``, the
``"cuda"`` backend) and the plain version (``quant_ref.py``, the
``"torch"`` backend).  The backend is the one ``core/dispatch.py`` resolves
for the unquantized op; nothing falls back.  Unlike the reference, where
fp8 runs its kernel only on a TPU, int8, e4m3 and e5m2 all run the kernel
on the card (Hopper converts fp8 exactly); only mixed int8 / fp8 storage
is refused, as there.

Routing (``active_quant``): an explicit ``quant=`` argument wins, else the
ambient ``use(quant=...)`` context, else a calibrated
:class:`~repro_torch.core.quantize.QuantizedTensor` weight implies its own
config.  Activations are quantized dynamically per row (or per tensor);
weights per output channel (or per tensor), unless already calibrated.
Every quantized B is written K-major (``quantize(..., k_major=True)``, or
``quantize_weight``'s storage), the reference's values in the layout 8-bit
wgmma reads, so that ``brgemm`` and ``batched_matmul`` run the wgmma
mainloop as ``matmul`` does.

The quantized path is inference-only (no gradient; a call with autograd
on raises) and takes no ``c0`` / ``beta`` accumulation.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import dispatch
from repro_torch.core.quantize import (QuantConfig, QuantizedTensor,
                                       quantize, quantize_weight,
                                       storage_name)
from repro_torch.kernels.brgemm import quant_kernel as QK
from repro_torch.kernels.brgemm import quant_ref as QR


def active_quant(w, quant=None) -> QuantConfig | None:
    """The QuantConfig governing this call, or None for full precision.

    Precedence: explicit ``quant=`` argument > ``use(quant=...)`` context >
    the config a calibrated weight implies."""
    qcfg = dispatch.resolve_quant(quant)
    if qcfg is not None:
        return qcfg
    if isinstance(w, QuantizedTensor):
        name = storage_name(w.q.dtype)
        return QuantConfig(
            w_dtype=name, a_dtype=name,
            granularity=("per_channel" if w.scale.dim() == w.q.dim() - 1
                         else "per_tensor"))
    return None


def _resolve_backend(op: str, backend, qcfg: QuantConfig, tensor) -> str:
    if "int8" in (qcfg.w_dtype, qcfg.a_dtype) and qcfg.w_dtype != qcfg.a_dtype:
        raise NotImplementedError(
            f"mixed integer/float quant storage (w={qcfg.w_dtype}, "
            f"a={qcfg.a_dtype}) has no accumulator dtype; use matching "
            f"int8 or fp8 families")
    return dispatch.resolve(op, backend, tensor)


def _check_inference(op: str, *tensors):
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"quantized {op} is inference-only (no gradient); run it under "
            f"torch.no_grad() or torch.inference_mode()")


def _check_no_accum(op: str, c0, beta: float):
    if c0 is not None and float(beta) != 0.0:
        raise NotImplementedError(
            f"quantized {op} does not support c0/beta accumulation; "
            f"run the epilogue-accumulating call in full precision")


def _vector(s: torch.Tensor, n: int) -> torch.Tensor:
    """A scale as an (n,) vector: a scalar broadcast (a view, no copy)."""
    return s.reshape(-1).expand(n)


def _weight_qparams(w, qcfg: QuantConfig, *, batch_shared: bool = False):
    """Quantized storage and per-output-channel fp32 scales of a weight:
    ``(n,)`` for a 2-D weight (a per-tensor scale broadcast), ``(B, n)`` for
    stacked per-batch weights unless ``batch_shared`` (the brgemm
    reduction) requires one shared vector."""
    n = w.shape[-1]
    if isinstance(w, QuantizedTensor):
        if storage_name(w.q.dtype) != qcfg.w_dtype:
            raise ValueError(
                f"pre-quantized weight storage {w.q.dtype} does not match "
                f"QuantConfig.w_dtype={qcfg.w_dtype}")
        wq, sw = w.q, w.scale
    else:
        qt = quantize_weight(
            w, QuantConfig(w_dtype=qcfg.w_dtype, a_dtype=qcfg.a_dtype,
                           granularity=qcfg.granularity))
        wq, sw = qt.q, qt.scale
    if wq.dim() == 2:
        return wq, _vector(sw, n)
    if batch_shared:
        if sw.dim() != 0:
            raise ValueError(
                "brgemm sums int32 products across the whole (B, k) "
                "reduction, so weight scales must be batch-shared; "
                "calibrate stacked brgemm weights with per-tensor "
                "granularity, or pass the full-precision weight and let "
                "the op quantize dynamically")
        return wq, _vector(sw, n)
    nb = wq.shape[0]
    if sw.dim() == 0:
        return wq, sw.expand(nb, n)
    if sw.dim() == 1:                     # per-batch per-tensor (B,)
        return wq, sw[:, None].expand(nb, n)
    return wq, sw                         # (B, n)


def _quantize_act(x, qcfg: QuantConfig, *, axis):
    """Dynamic activation quantization; scales keep the unreduced dims."""
    if qcfg.a_granularity == "per_tensor":
        axis = None
    return quantize(x, qcfg.a_dtype, axis=axis)


def matmul_q(x, w, bias=None, c0=None, *, activation="none", alpha=1.0,
             beta=0.0, out_dtype=None, backend=None, qcfg: QuantConfig):
    """Quantized ``act(alpha * dequant(Xq @ Wq) + bias)``; x: (m, k)."""
    _check_no_accum("matmul", c0, beta)
    _check_inference("matmul", x, w, bias)
    out_dtype = out_dtype or x.dtype
    name = _resolve_backend("matmul", backend, qcfg, x)
    xq, sx = _quantize_act(x, qcfg, axis=(-1,))
    wq, sw = _weight_qparams(w, qcfg)
    fn = (functools.partial(QK.matmul_q_cuda, quant=qcfg) if name == "cuda"
          else QR.matmul_q_ref)
    return fn(xq, wq, _vector(sx, x.shape[0]), sw, bias,
              activation=activation, alpha=alpha, out_dtype=out_dtype)


def brgemm_q(a, b, bias=None, c0=None, *, activation="none", alpha=1.0,
             beta=0.0, out_dtype=None, backend=None, qcfg: QuantConfig):
    """Quantized batch-reduce GEMM, a: (B, m, k), b: (B, k, n) -> (m, n).

    Scales are batch-shared (absmax over the whole (B, k) panel per row and
    channel): the accumulator sums across the entire reduction before the
    one dequant, so per-batch scales would change the result."""
    _check_no_accum("brgemm", c0, beta)
    _check_inference("brgemm", a, b, bias)
    out_dtype = out_dtype or a.dtype
    name = _resolve_backend("brgemm", backend, qcfg, a)
    aq, sa = _quantize_act(a, qcfg, axis=(0, 2))
    if isinstance(b, QuantizedTensor):
        bq, sb = _weight_qparams(b, qcfg, batch_shared=True)
    else:
        w_axis = (0, 1) if qcfg.granularity == "per_channel" else None
        bq, sb = quantize(b, qcfg.w_dtype, axis=w_axis, k_major=True)
        sb = _vector(sb, b.shape[-1])
    fn = (functools.partial(QK.brgemm_q_cuda, quant=qcfg) if name == "cuda"
          else QR.brgemm_q_ref)
    return fn(aq, bq, _vector(sa, a.shape[1]), sb, bias,
              activation=activation, alpha=alpha, out_dtype=out_dtype)


def _quantize_act_groups(a, qcfg: QuantConfig, groups: int):
    """Per-tensor activation scales of a (B, G * c, k) operand whose rows
    fall into ``groups`` equal groups that the reference quantizes in
    calls of their own (its MoE's ``vmap`` over routing groups): one scale
    a group, over every entry's rows of it.  Returns (aq, (B, G * c)
    per-row scales)."""
    nb, m, k = a.shape
    if m % groups:
        raise ValueError(f"{m} rows do not fall into {groups} equal groups")
    c = m // groups
    aq, sg = quantize(a.reshape(nb, groups, c, k), qcfg.a_dtype,
                      axis=(0, 2, 3))                          # sg: (G,)
    return aq.reshape(nb, m, k), sg.repeat_interleave(c).expand(nb, m)


def batched_matmul_q(a, b, bias=None, *, activation="none", alpha=1.0,
                     out_dtype=None, backend=None, a_groups: int = 1,
                     qcfg: QuantConfig):
    """Quantized strided-batched GEMM, per-batch scales: each entry
    dequantizes on its own.

    Two 3-D operands take the scales of the reference's kernel path (a
    stacked weight's per-tensor scale is one per entry); with a 2-D
    broadcast operand, those of its ``_batched_ref_from_raw`` (one scale
    vector for the shared operand).  Both backends take both, so on the card
    a broadcast operand runs the kernel too, with batch stride 0.

    ``a_groups`` > 1 says that a 3-D A's rows hold that many routing
    groups folded together (the MoE's (E, G * cap, D) buffer), which the
    reference runs one call each: per-row activation scales are the same
    either way, and per-tensor ones are taken a group, across the entries,
    as those calls take them."""
    _check_inference("batched_matmul", a, b, bias)
    out_dtype = out_dtype or a.dtype
    name = _resolve_backend("batched_matmul", backend, qcfg, a)
    if a_groups > 1 and qcfg.a_granularity == "per_tensor":
        aq, sa = _quantize_act_groups(a, qcfg, a_groups)
    else:
        aq, sa = _quantize_act(a, qcfg, axis=(-1,))
        sa = sa.expand(a.shape[:-1])
    if (a.dim() == 3 and b.ndim == 3) or isinstance(b, QuantizedTensor):
        bq, sb = _weight_qparams(b, qcfg)
    else:
        w_axis = (-2,) if qcfg.granularity == "per_channel" else None
        bq, sb = quantize(b, qcfg.w_dtype, axis=w_axis, k_major=True)
        if sb.dim() == 0:
            sb = sb.expand(b.shape[-1])
    fn = (functools.partial(QK.batched_matmul_q_cuda, quant=qcfg)
          if name == "cuda" else QR.batched_matmul_q_ref)
    return fn(aq, bq, sa, sb, bias, activation=activation, alpha=alpha,
              out_dtype=out_dtype)

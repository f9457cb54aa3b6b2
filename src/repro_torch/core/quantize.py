"""Quantized execution config and the weight / activation quantizers.

The port of ``repro/core/quantize.py``, with its constants and its
arithmetic kept bit for bit:

  * :class:`QuantConfig` — weight / activation storage dtype (int8, or fp8
    e4m3 / e5m2), weight-scale and activation-scale granularity, and the
    calibration rule.  It rides on the execution context
    (``dispatch.use(quant=...)``).
  * :func:`quantize` / :func:`dequantize` — absmax scaling into int8 or fp8
    storage over the reduction axes the caller names: ``amax / QMAX`` first,
    then ``x / scale`` (a division, as in the reference), then, for int8,
    round half to even and clip to +-127.
  * :class:`QuantizedTensor` — a calibrated weight: an ``nn.Module`` holding
    the buffers ``q`` and ``scale``, so ``.to(device)`` and ``state_dict``
    carry it.  Like the reference's pytree node it shows the storage's
    ``shape`` / ``ndim`` / ``dtype``, so a GEMM call site reads its output
    width unchanged.
  * :func:`calibrate_params` — a calibrated copy of a model
    (``repro_torch.quant.calibrate_params`` is the public alias).

The GEMM entry points consume all of this (``kernels/brgemm/quant.py``).
"""
from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

# Max representable magnitude per storage dtype; the absmax scale is
# amax / QMAX so the largest entry lands exactly on the dtype's edge.
QMAX = {
    "int8": 127.0,
    "float8_e4m3fn": 448.0,
    "float8_e5m2": 57344.0,
}
STORAGE_DTYPES = tuple(sorted(QMAX))
TORCH_DTYPES = {
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
GRANULARITIES = ("per_channel", "per_tensor")
A_GRANULARITIES = ("per_row", "per_tensor")
CALIBRATIONS = ("absmax",)

# Scales smaller than this clamp (an all-zero channel) quantize to zeros
# instead of dividing by zero.
_SCALE_FLOOR = 1e-30


def storage_name(dtype: torch.dtype) -> str:
    """The QuantConfig name of a storage dtype (``torch.int8`` -> ``"int8"``)."""
    for name, dt in TORCH_DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"{dtype} is not a quantized storage dtype; expected "
                     f"one of {', '.join(STORAGE_DTYPES)}")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantized-execution config for the GEMM family.

    ``w_dtype`` / ``a_dtype`` name the weight / activation storage dtypes.
    ``granularity`` scopes the weight scales (``per_channel``: one fp32 scale
    per output channel, absmax over the contraction dim; ``per_tensor``: one
    for the operand); ``a_granularity`` the dynamic activation scales
    (``per_row``: one per GEMM row).  ``calibration`` names the scale rule.
    """
    w_dtype: str = "int8"
    a_dtype: str = "int8"
    granularity: str = "per_channel"
    a_granularity: str = "per_row"
    calibration: str = "absmax"

    def __post_init__(self):
        for field, value, allowed in (
                ("w_dtype", self.w_dtype, STORAGE_DTYPES),
                ("a_dtype", self.a_dtype, STORAGE_DTYPES),
                ("granularity", self.granularity, GRANULARITIES),
                ("a_granularity", self.a_granularity, A_GRANULARITIES),
                ("calibration", self.calibration, CALIBRATIONS)):
            if value not in allowed:
                raise ValueError(
                    f"QuantConfig.{field}={value!r}; expected one of "
                    f"{', '.join(allowed)}")

    def tag(self) -> str:
        """Stable string form (round-trips through ``as_quant_config``)."""
        return (f"{self.w_dtype}:{self.a_dtype}:{self.granularity}:"
                f"{self.a_granularity}:{self.calibration}")

    @property
    def integer(self) -> bool:
        """Whether the accumulator is integer (int8 storage) vs fp32."""
        return self.w_dtype == "int8" and self.a_dtype == "int8"


_SHORTHANDS = {
    "int8": QuantConfig(),
    "fp8": QuantConfig(w_dtype="float8_e4m3fn", a_dtype="float8_e4m3fn"),
}


def as_quant_config(spec) -> QuantConfig:
    """Normalize a quant spec: QuantConfig | dict | shorthand/tag string.

    Strings accept the shorthands ``"int8"`` / ``"fp8"``, a bare storage
    dtype name, or a full :meth:`QuantConfig.tag`.
    """
    if isinstance(spec, QuantConfig):
        return spec
    if isinstance(spec, dict):
        return QuantConfig(**spec)
    if isinstance(spec, str):
        if spec in _SHORTHANDS:
            return _SHORTHANDS[spec]
        if spec in QMAX:
            return QuantConfig(w_dtype=spec, a_dtype=spec)
        parts = spec.split(":")
        if len(parts) == 5:
            return QuantConfig(*parts)
        raise ValueError(
            f"unknown quant spec {spec!r}; expected 'int8', 'fp8', a "
            f"storage dtype ({', '.join(STORAGE_DTYPES)}), or a "
            f"QuantConfig tag")
    raise TypeError(
        f"quant must be a QuantConfig, dict, or string; got {type(spec)}")


# --------------------------------------------------------------------------
# quantize / dequantize
# --------------------------------------------------------------------------

def quantize(x, dtype: str = "int8", *, axis=None, k_major: bool = False):
    """Absmax-quantize ``x``; returns ``(q, scale)`` with fp32 scales.

    ``axis`` gives the reduction axes of the absmax (the dims one scale
    covers); ``None`` means one scale for the whole tensor.  The scale drops
    the reduced axes: for a weight ``(..., k, n)`` with ``axis=(-2,)`` it
    is ``(..., n)``.  ``q`` keeps ``x``'s strides (elementwise ops do), so a
    column-major ``table.T`` quantizes to a column-major ``q``; with
    ``k_major`` it is column-major over its last two dims whatever ``x``'s
    layout (the same values, written so by the cast that stores them:
    the layout the 8-bit wgmma mainloop reads a weight in, k contiguous).
    """
    if dtype not in QMAX:
        raise ValueError(f"unknown quant storage dtype {dtype!r}")
    x = torch.as_tensor(x)
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        x = x.float()
    if axis is None:
        dims = tuple(range(x.dim()))
    else:
        axis = (axis,) if isinstance(axis, int) else tuple(axis)
        dims = tuple(sorted(a % x.dim() for a in axis))
    # max |x| is exact in x's own dtype, and x / scale promotes x to fp32
    # exactly: the values of an fp32 copy, in fewer passes over x
    amax = torch.linalg.vector_norm(x, float("inf"), dim=dims,
                                    keepdim=True).float()
    scale = torch.clamp_min(amax, _SCALE_FLOOR) / QMAX[dtype]
    q = x / scale
    if dtype == "int8":
        q = q.round_().clamp_(-127.0, 127.0)
    if k_major:
        q = torch.empty_like(q.mT, dtype=TORCH_DTYPES[dtype],
                             memory_format=torch.contiguous_format
                             ).mT.copy_(q)
    else:
        q = q.to(TORCH_DTYPES[dtype])
    if axis is None:
        return q, scale.reshape(())
    return q, scale.squeeze(dims)


def dequantize(q, scale):
    """Inverse of :func:`quantize`: expand the dropped axes and rescale.

    ``scale.ndim == q.ndim - 1`` is per-channel over the last axis (the
    reduced axis was -2); ``q.ndim - 2`` is per-tensor over the trailing
    matrix dims; equal ranks multiply elementwise.
    """
    q32 = q.float()
    scale = scale.float()
    if scale.dim() == q32.dim() - 1:
        return q32 * scale[..., None, :]
    if scale.dim() == q32.dim() - 2:
        return q32 * scale[..., None, None]
    return q32 * scale


# --------------------------------------------------------------------------
# pre-quantized weights
# --------------------------------------------------------------------------

class QuantizedTensor(nn.Module):
    """A calibrated weight: quantized storage ``q`` and fp32 ``scale``,
    both buffers.  Shows ``shape`` / ``ndim`` / ``dtype`` of the storage.

    ``.to(device)`` moves it; a dtype cast of a model leaves the storage
    alone for int8 but would cast fp8 storage and the scales, so cast a
    model before calibrating it, not after."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.dim()

    @property
    def dtype(self):
        return self.q.dtype

    def dequantize(self):
        return dequantize(self.q, self.scale)

    def extra_repr(self):
        return (f"shape={tuple(self.q.shape)}, dtype={self.q.dtype}, "
                f"scale_shape={tuple(self.scale.shape)}")


# A stacked weight quantizes at most this many fp32 bytes of its entries
# at a time: each scale covers one entry at most, so the bits are those of
# one pass, and a full-width expert stack (DeepSeek-V3's 256 x 7168 x 2048
# is 15 GB in fp32) needs no fp32 copy of itself.
QUANT_CHUNK_BYTES = 1 << 28


def quantize_weight(w, quant) -> QuantizedTensor:
    """Calibrate one GEMM weight ``(..., k, n)`` under ``quant``.

    Per-channel scales reduce the contraction dim only, so stacked weights
    ``(L, k, n)`` get ``(L, n)`` scales.  The storage is K-major (a
    column-major ``(k, n)`` view, strides ``(1, k)``; the reference's
    values, laid out for the 8-bit wgmma mainloop): written so by the cast
    that stores it, so a weight quantized at every step (``decode_int8``)
    pays no extra pass for it.  A stacked weight is quantized a few entries
    at a time (``QUANT_CHUNK_BYTES``), into the same storage."""
    qcfg = as_quant_config(quant)
    if getattr(w, "ndim", 0) < 2:
        raise ValueError(f"GEMM weight must be >= 2-D; got shape "
                         f"{tuple(getattr(w, 'shape', ()))}")
    axis = (-2,) if qcfg.granularity == "per_channel" else (-2, -1)
    k, n = w.shape[-2:]
    step = max(1, QUANT_CHUNK_BYTES // max(1, 4 * k * n))
    with torch.no_grad():
        if w.dim() == 2 or w.shape[:-2].numel() <= step:
            return QuantizedTensor(*quantize(w, qcfg.w_dtype, axis=axis,
                                             k_major=True))
        flat = w.reshape(-1, k, n)
        q = torch.empty_like(flat.mT, dtype=TORCH_DTYPES[qcfg.w_dtype],
                             memory_format=torch.contiguous_format).mT
        scale = torch.empty(flat.shape[:1] + ((n,) if len(axis) == 1
                                              else ()),
                            dtype=torch.float32, device=w.device)
        for i in range(0, flat.shape[0], step):
            q[i:i + step], scale[i:i + step] = quantize(
                flat[i:i + step], qcfg.w_dtype, axis=axis, k_major=True)
    return QuantizedTensor(q.unflatten(0, w.shape[:-2]),
                           scale.unflatten(0, w.shape[:-2]))


# Param names never auto-quantized even though they start with "w": MLA's
# wkv_b is reshaped/einsum-ed outside the GEMM entry points.
CALIBRATE_DENYLIST = ("wkv_b",)


def default_calibrate_predicate(name: str, leaf) -> bool:
    """Quantize ``w*``-named 2-D+ parameters (GEMM weights by convention);
    ``name`` is the dotted parameter name, its last part the leaf's.
    Embedding tables, norm scales and biases keep full precision."""
    leaf_name = name.rsplit(".", 1)[-1]
    return (leaf_name.startswith("w") and leaf_name not in CALIBRATE_DENYLIST
            and getattr(leaf, "ndim", 0) >= 2)


def install(model: nn.Module, name: str, qt: QuantizedTensor) -> None:
    """Put ``qt`` in place of the parameter ``name`` (dotted) of ``model``.
    nn.Module refuses a non-Parameter under a registered parameter's name,
    so the parameter is unregistered first."""
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    del owner._parameters[leaf]
    setattr(owner, leaf, qt)


def calibrate_params(model: nn.Module, quant="int8", *, predicate=None):
    """A calibrated copy of ``model``: each parameter the predicate selects
    (default :func:`default_calibrate_predicate`) is replaced by a
    :class:`QuantizedTensor` (per-channel scales by default).

    The GEMM entry points see the quantized weights and run the quantized
    building block without any ``use(quant=...)`` context.  Parameters
    already calibrated (``QuantizedTensor`` buffers) are left alone.
    Calibration is inference-only: the quantized path has no gradient.
    The copy never holds a full-precision copy of a weight it replaces
    (each is quantized from ``model``'s own), so calibrating a model on
    the card costs its quantized weights' bytes, not its own again.
    """
    qcfg = as_quant_config(quant)
    pred = predicate if predicate is not None else default_calibrate_predicate
    chosen = [(name, p) for name, p in model.named_parameters()
              if pred(name, p)]
    # A parameter held by one module only is left out of the copy (an
    # empty stand-in until its quantized form is installed); one that is
    # shared keeps its copy, as the modules that share it do.
    owners = {}
    for _, p in model.named_parameters(remove_duplicate=False):
        owners[id(p)] = owners.get(id(p), 0) + 1
    memo = {id(p): nn.Parameter(p.new_empty(0), requires_grad=False)
            for _, p in chosen if owners[id(p)] == 1}
    out = copy.deepcopy(model, memo)
    for name, param in chosen:
        install(out, name, quantize_weight(param.detach(), qcfg))
    return out

"""Wrapper of the Hopper flash-attention forward kernel (``csrc/flash_fwd.cu``).

``flash_attention_cuda`` checks what the kernel takes, allocates the
outputs, and launches on the current stream; the library is built at first
use (``kernels/_build.py``).  ``flash_attention_cuda.launches`` counts the
launches and ``flash_attention_cuda.mainloops`` the calls by mainloop
(``reset_flash_counts`` zeroes both).  q, k and v are read through their
strides: the transposed views of the attention layer's head split need no
``.contiguous()`` copy.

``plan`` picks a call's mainloop: ``wgmma`` (TMA and wgmma, O in
registers) for bf16 views that TMA can describe, ``wmma`` for other bf16
views, ``simt`` (FMA, no TF32) for fp32.  That is the heuristic: the
wrapper takes its mainloop from ``dispatch.resolve_blocks`` under the
reference's triple (tq, tk, d), whose grid is that one plan (the kernels
take no other tile at run time), so a measured policy returns it
unmeasured.

The kernel takes the head sizes of ``FWD_HEAD_DIMS``, pairs (q and k's,
v's): one size for all three (RecurrentGemma's 256 the widest), or MLA's
(192, 128).  Another pair (the
reduced MLA's (24, 16)) is zero-padded up to the first pair that holds it,
and the output sliced back: zero columns of q and k add nothing to a
score, and the scale is the unpadded size's unless the caller passes one.
A pair that no instantiation holds raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import blocking, dispatch
from repro_torch.core.blocking import AttnGeometry, PlanSchema
from repro_torch.kernels import _build

# (q / k, v) head sizes instantiated, the forward's and the backward's
FWD_HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (192, 128), (256, 256))
MAINLOOPS = ("wgmma", "wmma", "simt")
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.repro_flash_fwd.argtypes = ([_P] * 5 + [_I] * 7 + [_LL] * 9
                                    + [_I, _I, _F, _I, _I, _P])
    lib.repro_flash_fwd.restype = ctypes.c_int
    lib.repro_flash_fwd_wgmma.argtypes = ([_P] * 5 + [_I] * 7 + [_LL] * 9
                                          + [_I, _I, _F, _I, _P])
    lib.repro_flash_fwd_wgmma.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _strides(t: torch.Tensor, name: str) -> list[int]:
    """(batch, head, time) strides in elements; 16-byte rows required."""
    vec = 16 // t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16:
        raise ValueError(f"flash_attention_cuda needs {name} with unit "
                         f"head_dim stride and a 16-byte aligned base")
    out = []
    for dim in range(3):
        s = t.stride(dim) if t.size(dim) > 1 else 0   # any stride is valid
        if s % vec:
            raise ValueError(f"flash_attention_cuda needs {name}'s strides "
                             f"in multiples of {vec} elements, got "
                             f"{t.stride()}")
        out.append(s)
    return out


def _tma_legal(t: torch.Tensor) -> bool:
    """TMA can read a (B, H, T, d) bf16 view as a 4-D map over (d, t, h, b):
    16-byte aligned base, unit d stride, (b, h, t) strides in multiples of
    8 elements (16 bytes) where the dimension has more than one entry, and
    rows that do not overlap (a t stride that covers d), as matmul's plan
    asks of a row stride."""
    return (t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
            and t.stride(3) == 1
            and all(t.stride(i) % 8 == 0 for i in range(3) if t.size(i) > 1)
            and (t.size(2) <= 1 or t.stride(2) >= t.size(3)))


def plan(is_bf16: bool, tma: bool) -> str:
    """The mainloop of a call (one of MAINLOOPS): wgmma for bf16 that TMA
    can describe, wmma for other bf16, simt for fp32."""
    if not is_bf16:
        return "simt"
    return "wgmma" if tma else "wmma"


def _heuristic(tq, tk, d, dtype, g: AttnGeometry) -> str:
    return plan(blocking.dtype_name(dtype) == "bfloat16", g.tma)


def _schema() -> PlanSchema:
    """The flash kernels' schema (the backward's is alike): the heuristic
    its own grid."""
    return PlanSchema(
        heuristic=_heuristic,
        candidates=lambda *args: [_heuristic(*args)],
        geometry=lambda tq, tk, d, dt: AttnGeometry(
            blocking.dtype_name(dt) == "bfloat16" and d % 8 == 0))


blocking.register_schema("flash_attention", _schema())


def resolve_mainloop(op: str, q, k, views, explicit=None) -> str:
    """The mainloop of a flash call (``op`` ``flash_attention`` or
    ``flash_attention_bwd``) through ``dispatch.resolve_blocks``; an
    explicit one the views cannot take raises.  No key at all stays off
    wgmma."""
    is_bf16 = q.dtype == torch.bfloat16
    tma = k.size(2) > 0 and all(_tma_legal(t) for t in views)
    mainloop = dispatch.resolve_blocks(
        op, q.size(2), k.size(2), q.size(3), q.dtype, backend="cuda",
        plan=explicit, geometry=AttnGeometry(tma))
    allowed = ({"wgmma", "wmma"} if tma else {"wmma"}) if is_bf16 \
        else {"simt"}
    if mainloop not in allowed:
        raise ValueError(f"{op}: mainloop {mainloop!r} cannot run these "
                         f"views; they take {sorted(allowed)}")
    return mainloop


def head_dims(d: int, dv: int) -> tuple[int, int]:
    """The instantiated (q/k, v) head sizes that run a (d, dv) call, forward
    or backward: the first pair of FWD_HEAD_DIMS that holds both."""
    for pair in FWD_HEAD_DIMS:
        if d <= pair[0] and dv <= pair[1]:
            return pair
    raise ValueError(f"flash attention head sizes (q/k {d}, v {dv}) fit no "
                     f"instantiation of {FWD_HEAD_DIMS}")


def _padded(q, k, v):
    """q, k and v as the kernel runs them: zero-padded in the head
    dimension up to ``head_dims``' pair where theirs is not one."""
    dp, dvp = head_dims(q.size(3), v.size(3))
    if dp != q.size(3):
        q = F.pad(q, (0, dp - q.size(3)))
        k = F.pad(k, (0, dp - k.size(3)))
    if dvp != v.size(3):
        v = F.pad(v, (0, dvp - v.size(3)))
    return q, k, v


def plan_call(q, k, v) -> str:
    """The plan of ``flash_attention_cuda(q, k, v)`` from the views' type,
    strides and alignment (padded as the wrapper pads them) under the
    active block policy (the kernel itself is not touched)."""
    q, k, v = _padded(q, k, v)
    return resolve_mainloop("flash_attention", q, k, (q, k, v))


def _tma_strides(t: torch.Tensor) -> list[int]:
    """(batch, head, time) strides for a tensor map: a dimension of one
    entry is read at 0 alone, so its stride, which PyTorch may give any
    value, becomes one TMA takes: the span of the tensor, in 8s."""
    span = -(-max(t.stride(i) * t.size(i) for i in range(4)) // 8) * 8
    return [t.stride(i) if t.size(i) > 1 else span for i in range(3)]


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         scale: float | None = None,
                         return_residuals: bool = False,
                         plan: str | None = None, round_k: int = 0):
    """q: (B, Hq, Tq, d); k: (B, Hkv, Tk, d); v: (B, Hkv, Tk, dv) -> o
    (B, Hq, Tq, dv).

    fp32 or bf16; (d, dv) a pair of FWD_HEAD_DIMS, or one padded up to
    one; ``scale`` defaults to ``d ** -0.5``.  With ``return_residuals``
    also returns lse = m + log l, fp32 (B, Hq, Tq), ``NEG_INF`` for empty
    rows.  ``plan``: the mainloop to run, else the block policy's pick.
    ``round_k``: bf16 accumulation, O rounded to bf16 in place after each
    ``round_k`` keys (a multiple of 64) and after the last
    (``blocking.accum_block``); 0, fp32 accumulation.
    """
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention_cuda takes fp32 or bf16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError("flash_attention_cuda takes 4-D q, k and v, k and v "
                         "of one (batch, heads, time)")
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    dv = v.size(3)
    if k.size(0) != b or k.size(3) != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention_cuda shapes q {tuple(q.shape)} "
                         f"and k {tuple(k.shape)} do not match")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = scale if scale is not None else d ** -0.5
    q, k, v = _padded(q, k, v)
    dp, dvp = q.size(3), v.size(3)
    strides = _strides(q, "q") + _strides(k, "k") + _strides(v, "v")
    o = torch.empty((b, hq, tq, dvp), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
           if return_residuals else None)
    if o.numel():
        mainloop = resolve_mainloop("flash_attention", q, k, (q, k, v), plan)
        lib = _lib()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                b, hq, hkv, tq, tk, dp, dvp)
        tail = (int(causal), -1 if window is None else int(window),
                float(scale))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mainloop == "wgmma":
            tma = _tma_strides(q) + _tma_strides(k) + _tma_strides(v)
            rc = lib.repro_flash_fwd_wgmma(*args, *tma, *tail, int(round_k),
                                           stream)
        else:
            rc = lib.repro_flash_fwd(*args, *strides, *tail,
                                     int(q.dtype == torch.bfloat16),
                                     int(round_k), stream)
        if rc != 0:
            raise RuntimeError(
                f"flash_attention kernel launch failed: CUDA error {rc} "
                f"({lib.repro_cuda_error_string(rc).decode()})")
        flash_attention_cuda.launches += 1
        flash_attention_cuda.mainloops[mainloop] += 1
    if dvp != dv:
        o = o[..., :dv]
    return (o, lse) if return_residuals else o


def reset_flash_counts():
    """Zero ``flash_attention_cuda``'s launches and calls by mainloop."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.mainloops = dict.fromkeys(MAINLOOPS, 0)


reset_flash_counts()

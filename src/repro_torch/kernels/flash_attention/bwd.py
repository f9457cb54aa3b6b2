"""Wrappers of the Hopper flash-attention backward kernels.

The sources are their own kernel family, ``kernels/flash_attention_bwd/
csrc/flash_bwd.cu``, so that their nvcc runs beside the forward's rather
than after it; the library is built at first use (``kernels/_build.py``).

``flash_attention_bwd_cuda`` makes two launches per call (dQ with delta
fused in, then dK / dV) and counts one call in
``flash_attention_bwd_cuda.launches``, and the call by mainloop in
``flash_attention_bwd_cuda.mainloops`` (``reset_flash_bwd_counts`` zeroes
both); ``delta_rowsum_cuda`` launches the standalone delta pass and counts
it in ``delta_rowsum_cuda.launches``.  q, k, v, y and dy are read through
their (batch, head, time) strides, so the attention layer's transposed
views need no ``.contiguous()`` copy.

``plan_call`` picks a call's mainloop as the forward's plan does:
``wgmma`` (TMA and wgmma, the gradients in registers) for bf16 q, k, v, y
and dy that TMA can describe, ``wmma`` for other bf16 views, ``simt``
(FMA, no TF32) for fp32, through ``dispatch.resolve_blocks`` under op
``flash_attention_bwd`` (a grid of that one plan).

The kernels take the forward's head-size pairs (``FWD_HEAD_DIMS``: q and
k's, v's, so y's and dy's): one size for all, RecurrentGemma's 256 the
widest, or MLA's (192, 128).  Another pair (the reduced MLA's (24, 16)) is
zero-padded up to the first pair that holds it, as the forward pads it:
zero columns of q and k add nothing to a score, of v, y and dy nothing to
dP or delta, and their gradients' columns, sliced off, are zero.  The
scale is the unpadded size's unless the caller passes one.  A pair that
no instantiation holds raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import blocking
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (FWD_HEAD_DIMS,
                                                       MAINLOOPS, _schema,
                                                       _strides,
                                                       _tma_strides,
                                                       resolve_mainloop)
from repro_torch.kernels.flash_attention.kernel import _padded as _fwd_padded

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.c_longlong * 15
# The v head sizes of the pairs: delta's row lengths.
V_DIMS = tuple(sorted({dv for _, dv in FWD_HEAD_DIMS}))


@functools.cache
def _lib():
    lib = _build.load("flash_attention_bwd")
    lib.repro_flash_bwd.argtypes = ([_P] * 10 + [_I] * 7
                                    + [_P, _I, _I, _F, _I, _I, _P])
    lib.repro_flash_bwd.restype = ctypes.c_int
    lib.repro_flash_bwd_wgmma.argtypes = ([_P] * 10 + [_I] * 7
                                          + [_P, _I, _I, _F, _P, _I, _P])
    lib.repro_flash_bwd_wgmma.restype = ctypes.c_int
    lib.repro_delta_rowsum.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _I,
                                       _P]
    lib.repro_delta_rowsum.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(rc: int, what: str, lib) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({lib.repro_cuda_error_string(rc).decode()})")


def _check_rows(name, t, shape, like):
    if tuple(t.shape) != shape or t.dtype != like.dtype or t.device != \
            like.device:
        raise ValueError(f"flash_attention_bwd_cuda needs {name} of shape "
                         f"{shape}, typed and placed like q, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _padded(q, k, v, y, dy):
    """The five views as the kernels run them: q, k and v padded as the
    forward pads them (``kernel._padded``), y and dy to v's size."""
    dv = v.size(3)
    q, k, v = _fwd_padded(q, k, v)
    if v.size(3) != dv:
        y, dy = (F.pad(t, (0, v.size(3) - dv)) for t in (y, dy))
    return q, k, v, y, dy


blocking.register_schema("flash_attention_bwd", _schema())


def plan_call(q, k, v, y, dy) -> str:
    """The plan of ``flash_attention_bwd_cuda(q, k, v, y, lse, dy)`` from
    the views' type, strides and alignment (padded as the wrapper pads
    them) under the active block policy (the kernels are not touched); no
    key at all stays off wgmma."""
    q, k, v, y, dy = _padded(q, k, v, y, dy)
    return resolve_mainloop("flash_attention_bwd", q, k, (q, k, v, y, dy))


def flash_attention_bwd_cuda(q, k, v, y, lse, dy, *, causal: bool = True,
                             window: int | None = None,
                             scale: float | None = None,
                             return_delta: bool = False,
                             plan: str | None = None, round_k: int = 0):
    """(dq, dk, dv) from the forward's residuals, on the card.

    q: (B, Hq, Tq, d); k: (B, Hkv, Tk, d); v: (B, Hkv, Tk, dv); y, dy:
    (B, Hq, Tq, dv); fp32 or bf16 of one dtype; (d, dv) a pair of
    ``FWD_HEAD_DIMS``, or one padded up to one.  Tq and Tk may differ.
    lse: fp32 (B, Hq, Tq), as ``flash_attention_cuda(...,
    return_residuals=True)`` returns it.  The gradients come back in the
    inputs' dtype, contiguous (of a padded pair: the padded gradients
    sliced back); with ``return_delta`` also the fused fp32 (B, Hq, Tq)
    delta.  ``scale`` defaults to ``d ** -0.5`` of the unpadded d.
    ``plan``: the mainloop to run, else the block policy's pick.
    ``round_k``: bf16 accumulation, dQ rounded to bf16 in place after each
    ``round_k`` keys and dK, dV after each ``round_k`` q rows of a q-head
    (a multiple of 64; ``blocking.accum_block``), and after the last; 0,
    fp32 accumulation.
    """
    if not (q.is_cuda and all(t.device == q.device
                              for t in (k, v, y, lse, dy))):
        raise ValueError("flash_attention_bwd_cuda needs every input on one "
                         "CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention_bwd_cuda takes fp32 or bf16 q, k, "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError("flash_attention_bwd_cuda takes 4-D q, k and v, k "
                         "and v of one (batch, heads, time)")
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    d_v = v.size(3)
    if k.size(0) != b or k.size(3) != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention_bwd_cuda shapes q "
                         f"{tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _check_rows("y", y, (b, hq, tq, d_v), q)
    _check_rows("dy", dy, (b, hq, tq, d_v), q)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, tq) or \
            not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd_cuda needs a contiguous fp32 "
                         f"lse of shape {(b, hq, tq)}")
    scale = scale if scale is not None else d ** -0.5
    q, k, v, y, dy = _padded(q, k, v, y, dy)
    dp, dvp = q.size(3), v.size(3)
    strides = _STRIDES(*(_strides(q, "q") + _strides(k, "k")
                         + _strides(v, "v") + _strides(y, "y")
                         + _strides(dy, "dy")))
    # The kernels write every row of every output; with no query or no key
    # there is nothing to launch and the gradients are zero.
    alloc = torch.empty_like if q.numel() and k.numel() else torch.zeros_like
    dq, dk, dv = (alloc(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    delta = alloc(lse)
    if q.numel() and k.numel():
        mainloop = resolve_mainloop("flash_attention_bwd", q, k,
                                    (q, k, v, y, dy), plan)
        lib = _lib()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(),
                dy.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, tq,
                tk, dp, dvp)
        tail = (int(causal), -1 if window is None else int(window),
                float(scale))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mainloop == "wgmma":
            tma = _STRIDES(*(s for t in (q, k, v, y, dy)
                             for s in _tma_strides(t)))
            # (lse * log2 e, delta) of every row, Tq padded to the 64-row
            # tile: kernel A writes it, kernel B reads a tile's in one copy.
            stats = torch.empty(b * hq * -(-tq // 64) * 128,
                                dtype=torch.float32, device=q.device)
            rc = lib.repro_flash_bwd_wgmma(*args, tma, *tail,
                                           stats.data_ptr(), int(round_k),
                                           stream)
        else:
            rc = lib.repro_flash_bwd(*args, strides, *tail,
                                     int(q.dtype == torch.bfloat16),
                                     int(round_k), stream)
        _check(rc, "flash_attention_bwd", lib)
        flash_attention_bwd_cuda.launches += 1
        flash_attention_bwd_cuda.mainloops[mainloop] += 1
    if dp != d:
        dq, dk = dq[..., :d], dk[..., :d]
    if dvp != d_v:
        dv = dv[..., :d_v]
    return (dq, dk, dv, delta) if return_delta else (dq, dk, dv)


def reset_flash_bwd_counts():
    """Zero ``flash_attention_bwd_cuda``'s calls and calls by mainloop."""
    flash_attention_bwd_cuda.launches = 0
    flash_attention_bwd_cuda.mainloops = dict.fromkeys(MAINLOOPS, 0)


reset_flash_bwd_counts()


def delta_rowsum_cuda(y, dy):
    """``rowsum(dy * y)`` in fp32 on the card: (B, H, T, d) -> (B, H, T)."""
    if not (y.is_cuda and dy.device == y.device):
        raise ValueError("delta_rowsum_cuda needs y and dy on one CUDA "
                         "device")
    if y.dtype not in (torch.float32, torch.bfloat16) or y.dim() != 4:
        raise TypeError(f"delta_rowsum_cuda takes 4-D fp32 or bf16 y, got "
                        f"{y.dtype} {tuple(y.shape)}")
    if dy.shape != y.shape or dy.dtype != y.dtype:
        raise ValueError("delta_rowsum_cuda needs dy shaped and typed like y")
    b, h, t, d = y.shape
    if d not in V_DIMS:
        raise ValueError(f"delta_rowsum_cuda head_dim must be one of "
                         f"{V_DIMS}, got {d}")
    strides = _STRIDES(*(_strides(y, "y") + _strides(dy, "dy")), *([0] * 9))
    delta = torch.empty((b, h, t), dtype=torch.float32, device=y.device)
    if delta.numel():
        lib = _lib()
        _check(lib.repro_delta_rowsum(
            y.data_ptr(), dy.data_ptr(), delta.data_ptr(), b, h, t, d,
            strides, int(y.dtype == torch.bfloat16),
            torch.cuda.current_stream(y.device).cuda_stream),
            "delta_rowsum", lib)
        delta_rowsum_cuda.launches += 1
    return delta


delta_rowsum_cuda.launches = 0

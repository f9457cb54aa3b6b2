"""Wrapper of the Hopper flash-attention forward kernel (``csrc/flash_fwd.cu``).

``flash_attention_cuda`` checks what the kernel takes, allocates the
outputs, and launches on the current stream; the library is built at first
use (``kernels/_build.py``).  ``flash_attention_cuda.launches`` counts the
launches.  q, k and v are read through their strides: the transposed views
of the attention layer's head split need no ``.contiguous()`` copy.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.repro_flash_fwd.argtypes = ([_P] * 5 + [_I] * 6 + [_LL] * 9
                                    + [_I, _I, _F, _I, _P])
    lib.repro_flash_fwd.restype = ctypes.c_int
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


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         scale: float | None = None,
                         return_residuals: bool = False):
    """q: (B, Hq, Tq, d); k, v: (B, Hkv, Tk, d) -> o (B, Hq, Tq, d).

    fp32 or bf16, d in (32, 64, 128).  With ``return_residuals`` also
    returns lse = m + log l, fp32 (B, Hq, Tq), ``NEG_INF`` for empty rows.
    """
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention_cuda takes fp32 or bf16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash_attention_cuda takes 4-D q and equal-shape "
                         "4-D k, v")
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    if k.size(0) != b or k.size(3) != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention_cuda shapes q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda head_dim must be one of "
                         f"{HEAD_DIMS}, got {d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    strides = _strides(q, "q") + _strides(k, "k") + _strides(v, "v")
    scale = scale if scale is not None else d ** -0.5
    o = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
           if return_residuals else None)
    if o.numel():
        lib = _lib()
        rc = lib.repro_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, hq, hkv, tq, tk, d, *strides, int(causal),
            -1 if window is None else int(window), float(scale),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"flash_attention kernel launch failed: CUDA error {rc} "
                f"({lib.repro_cuda_error_string(rc).decode()})")
        flash_attention_cuda.launches += 1
    return (o, lse) if return_residuals else o


flash_attention_cuda.launches = 0

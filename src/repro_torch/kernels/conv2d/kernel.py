"""Wrapper of the Hopper direct-convolution kernel (``csrc/conv2d.cu``).

``conv2d_cuda`` checks what the kernel takes, allocates the output, and
launches on the current stream; the library is built at first use
(``kernels/_build.py``).  ``conv2d_cuda.launches`` counts the launches,
forward and backward-by-data alike (both run this kernel).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import fusion
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d.ref import out_size

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("conv2d")
    lib.repro_conv2d.argtypes = [_P, _P, _P, _P] + [_I] * 17 + [_P]
    lib.repro_conv2d.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def conv2d_cuda(x, w, bias=None, *, stride: int = 1, padding: int = 0,
                activation: str = "none", out_dtype=None):
    """``act(conv(x, w) + bias)`` on the card, NHWC x RSCK -> NPQK.

    x: (N, H, W, C) and w: (R, S, C, K), both contiguous, fp32 or bf16 of
    one dtype; bias: (K,) contiguous, fp32 or x's dtype.  The input is
    padded by ``padding`` on every side (zeros, never materialized).
    Returns a contiguous (N, P, Q, K) of ``out_dtype`` (default x's dtype).
    """
    out_dtype = out_dtype or x.dtype
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("conv2d_cuda needs x and w on the same CUDA device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv2d_cuda takes fp32 or bf16 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"conv2d_cuda out_dtype must be fp32 or bf16, got "
                        f"{out_dtype}")
    if x.dim() != 4 or w.dim() != 4 or x.size(3) != w.size(2):
        raise ValueError(f"conv2d_cuda needs NHWC x and RSCK w with one C, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_cuda needs contiguous x and w")
    if stride < 1 or padding < 0:
        raise ValueError(f"conv2d_cuda stride {stride}, padding {padding}")
    n, h, wi, c = x.shape
    r, s, _, k = w.shape
    p, q = out_size(h, r, stride, padding), out_size(wi, s, stride, padding)
    if p < 1 or q < 1:
        raise ValueError(f"conv2d_cuda: a {r}x{s} window does not fit "
                         f"{h}x{wi} padded by {padding}")
    if bias is not None:
        if bias.device != x.device or bias.dtype not in (torch.float32,
                                                         x.dtype):
            raise TypeError(f"conv2d_cuda bias must be fp32 or {x.dtype} on "
                            f"{x.device}")
        if tuple(bias.shape) != (k,) or not bias.is_contiguous():
            raise ValueError(f"conv2d_cuda bias must be contiguous ({k},), "
                             f"got {tuple(bias.shape)}")
    if max(x.numel(), w.numel(), n * p * q * k) >= 2 ** 31:
        raise ValueError("conv2d_cuda indexes pixels and channels with int")
    out = torch.empty((n, p, q, k), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    is_bf16 = x.dtype == torch.bfloat16
    lib = _lib()
    rc = lib.repro_conv2d(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        n, h, wi, c, k, r, s, p, q, stride, padding,
        fusion.code(activation), int(is_bf16),
        int(out_dtype == torch.float32),
        int(bias is not None and bias.dtype == torch.float32),
        int(is_bf16 and c % 8 == 0 and x.data_ptr() % 16 == 0),
        int(is_bf16 and k % 8 == 0 and w.data_ptr() % 16 == 0),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv2d kernel launch failed: CUDA error {rc} "
                           f"({lib.repro_cuda_error_string(rc).decode()})")
    conv2d_cuda.launches += 1
    return out


conv2d_cuda.launches = 0

"""Wrapper of the Hopper GEMM kernel (``csrc/matmul.cu``).

``matmul_cuda`` checks what the kernel takes, allocates the output, and
launches on the current stream; the library is built at first use
(``kernels/_build.py``).  ``matmul_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import fusion
from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


@functools.cache
def _lib():
    lib = _build.load("brgemm")
    lib.repro_matmul.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL,
                                 _I, _I, _LL, _F, _F, _I, _I, _I, _I, _I, _I,
                                 _I, _P]
    lib.repro_matmul.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _row_stride(t: torch.Tensor) -> int:
    # A single row may carry any stride; the kernel only needs a valid one.
    return t.stride(0) if t.size(0) > 1 else t.size(1)


def _aligned(t: torch.Tensor, ld: int) -> bool:
    """16-byte vector loads are safe: aligned base, rows of 8 bf16."""
    return t.data_ptr() % 16 == 0 and ld % 8 == 0


def _layout(t: torch.Tensor, name: str) -> tuple[int, int]:
    """(trans, ld) of a 2-D operand read in place: row-major (trans 0, ld
    the row stride) or column-major (trans 1, ld the column stride)."""
    rows, cols = t.shape
    if t.stride(1) == 1 or cols == 1:
        return 0, _row_stride(t)
    if t.stride(0) == 1 or rows == 1:
        return 1, t.stride(1)
    raise ValueError(f"matmul_cuda needs {name} row- or column-major, got "
                     f"strides {t.stride()}")


def matmul_cuda(x, w, bias=None, c0=None, *, activation: str = "none",
                alpha: float = 1.0, beta: float = 0.0, out_dtype=None):
    """``act(alpha * x @ w + beta * c0 + bias)`` on the card.

    x: (m, k) and w: (k, n), each either row-major or column-major (as
    ``x.T`` and ``table.T`` are), read in place.  bias: (n,) contiguous;
    c0: (m, n) with unit column stride; both fp32 or x's dtype.  Returns a
    contiguous (m, n) of ``out_dtype`` (fp32 or bf16; default x's dtype).
    """
    out_dtype = out_dtype or x.dtype
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("matmul_cuda needs x and w on the same CUDA device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"matmul_cuda takes fp32 or bf16 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"matmul_cuda out_dtype must be fp32 or bf16, got "
                        f"{out_dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.size(1) != w.size(0):
        raise ValueError(f"matmul_cuda shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    m, k = x.shape
    n = w.size(1)
    x_trans, ldx = _layout(x, "x")
    w_trans, ldw = _layout(w, "w")
    for name, t, shape in (("bias", bias, (n,)), ("c0", c0, (m, n))):
        if t is None:
            continue
        if t.device != x.device or t.dtype not in (torch.float32, x.dtype):
            raise TypeError(f"matmul_cuda {name} must be fp32 or {x.dtype} "
                            f"on {x.device}")
        if tuple(t.shape) != shape or t.stride(-1) != 1:
            raise ValueError(f"matmul_cuda {name} must be {shape} with unit "
                             f"last stride, got {tuple(t.shape)}")
    has_c0 = c0 is not None and beta != 0.0
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    is_bf16 = x.dtype == torch.bfloat16
    lib = _lib()
    rc = lib.repro_matmul(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        c0.data_ptr() if has_c0 else None,
        out.data_ptr(), m, n, k, ldx, ldw, x_trans, w_trans,
        _row_stride(c0) if has_c0 else 0, float(alpha), float(beta),
        fusion.code(activation), int(is_bf16),
        int(out_dtype == torch.float32),
        int(bias is not None and bias.dtype == torch.float32),
        int(has_c0 and c0.dtype == torch.float32),
        int(is_bf16 and _aligned(x, ldx)), int(is_bf16 and _aligned(w, ldw)),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {rc} "
                           f"({lib.repro_cuda_error_string(rc).decode()})")
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0

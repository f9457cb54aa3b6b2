"""Wrappers of the Hopper GEMM kernels.

``matmul_cuda`` launches ``csrc/matmul.cu``; ``brgemm_stacked_cuda`` and
``batched_matmul_cuda`` launch ``kernels/brgemm_batched/csrc/batched.cu``,
a family of its own so that its nvcc runs beside matmul's.  Each checks
what its kernel takes, allocates the output, and launches on the current
stream; the libraries are built at first use (``kernels/_build.py``).
``<wrapper>.launches`` counts each wrapper's launches.

``plan`` decides how ``matmul_cuda`` runs a call: its mainloop (``wgmma``
for bf16 operands that TMA can describe, ``wmma`` for other bf16 operands,
``simt`` for fp32), its tile, and how many runs of k (``splits``) the
reduction is cut into so that few output tiles still fill the card.
``plan_batched`` decides ``batched_matmul_cuda``'s mainloop and tile the
same way (one run of k: the batch fills the card), and ``plan_stacked``
``brgemm_stacked_cuda``'s, splitting the flattened (entry, k-slice) axis
as ``plan`` splits k.  ``.mainloops`` of each of the three wrappers counts
its calls by mainloop, ``.split_launches`` of ``matmul_cuda`` and
``brgemm_stacked_cuda`` the calls that also launched the split-K
reduction; ``reset_matmul_counts`` zeroes them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import fusion
from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

MAINLOOPS = ("wgmma", "wmma", "simt")   # matmul.cu's Mainloop codes
SMS = 132                               # an H100 SXM's multiprocessors
# Per mainloop: (tile rows for m > 64, tile columns, k a slice, blocks an
# SM that a split aims at).  wgmma's tile has 64 rows where m <= 64; two
# of its blocks fit an SM, but one wave of split blocks ran faster than two
# or four on an H100 (matmul_sweep.py --variants): each split adds
# partials to write and add again.
_TILES = {"wgmma": (128, 128, 64, 1), "wmma": (64, 64, 32, 4),
          "simt": (64, 64, 16, 4)}
# A split walks at least this much of k, so that its partials stay small
# against its products; decode's k = 576 ran no faster split.
MIN_SPLIT_K = 512


@dataclasses.dataclass(frozen=True)
class Plan:
    mainloop: str      # one of MAINLOOPS
    bm: int            # tile rows
    bk: int            # k a slice
    splits: int        # runs of k, each its own blocks; 1: no split
    chunk: int         # slices a run
    tiles: int         # output tiles


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, is_bf16: bool, tma: bool) -> Plan:
    """How ``matmul_cuda`` runs an (m, k) @ (k, n) product.

    ``tma``: both bf16 operands can be described to TMA (16-byte aligned
    base, a row stride that is a multiple of 8 elements and covers a row).
    k is split only while the tiles alone leave SMs idle, into equal runs
    of whole slices, no shorter than MIN_SPLIT_K, until the blocks fill the
    SMs once.
    """
    mainloop = ("simt" if not is_bf16 else "wgmma" if tma and k > 0
                else "wmma")
    bm, bn, bk, per_sm = _TILES[mainloop]
    if mainloop == "wgmma" and m <= 64:
        bm = 64
    tiles = -(-m // bm) * -(-n // bn)
    splits, chunk = _split(tiles, -(-k // bk), bk, per_sm)
    return Plan(mainloop, bm, bk, splits, chunk, tiles)


def _split(tiles: int, slices: int, bk: int, per_sm: int) -> tuple[int, int]:
    """(splits, chunk): ``slices`` slices of a reduction cut into equal runs
    of ``chunk`` whole slices, no shorter than MIN_SPLIT_K, while ``tiles``
    output tiles alone leave SMs idle, until the blocks fill them once."""
    splits = max(1, min(SMS * per_sm // tiles, slices // (MIN_SPLIT_K // bk)))
    chunk = max(1, -(-slices // splits))
    return max(1, -(-slices // chunk)), chunk


@functools.cache
def _lib():
    lib = _build.load("brgemm")
    lib.repro_matmul.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL,
                                 _I, _I, _LL, _F, _F, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _P, _P]
    lib.repro_matmul.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _batched_lib():
    lib = _build.load("brgemm_batched")
    operands = [_P, _LL, _LL, _I, _I] * 2
    lib.repro_brgemm_stacked.argtypes = operands + [
        _P, _P, _LL, _P, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _P, _P]
    lib.repro_batched_matmul.argtypes = operands + [
        _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P]
    for fn in (lib.repro_brgemm_stacked, lib.repro_batched_matmul):
        fn.restype = ctypes.c_int
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
    raise ValueError(f"the GEMM kernels need {name} row- or column-major, "
                     f"got strides {t.stride()}")


def _operand(t: torch.Tensor, name: str) -> tuple[int, int, bool, bool]:
    """(trans, ld, vec, tma) of a GEMM operand: its layout, whether the wmma
    body's 16-byte loads are safe (bf16), and whether TMA can describe it
    (those loads are, and the row stride covers the row it steps over)."""
    trans, ld = _layout(t, name)
    vec = t.dtype == torch.bfloat16 and _aligned(t, ld)
    return trans, ld, vec, vec and ld >= t.size(trans ^ 1)


@functools.lru_cache(maxsize=4096)
def plan_batched(m: int, n: int, k: int, is_bf16: bool, tma: bool) -> Plan:
    """How ``batched_matmul_cuda`` runs a (B, m, k) @ (B, k, n) product:
    ``plan``'s mainloop and tile for one entry, and one run of k (the
    entries fill the card; no split).  ``tiles``: output tiles an entry."""
    p = plan(m, n, k, is_bf16, tma)
    return dataclasses.replace(p, splits=1, chunk=max(1, -(-k // p.bk)))


@functools.lru_cache(maxsize=4096)
def plan_stacked(nb: int, m: int, n: int, k: int, is_bf16: bool,
                 tma: bool) -> Plan:
    """How ``brgemm_stacked_cuda`` runs sum_i (m, k) @ (k, n) over ``nb``
    entries: ``plan``'s mainloop and tile for one entry.  On wgmma the
    reduction is the flattened (entry, k-slice) axis of nb * ceil(k / bk)
    slices, split as ``plan`` splits k; the wmma and simt tiles walk it
    whole, in one block an output tile.  ``chunk``: slices a split."""
    p = plan(m, n, k, is_bf16, tma and nb > 0)
    slices = nb * -(-k // p.bk)
    if p.mainloop != "wgmma":
        return dataclasses.replace(p, splits=1, chunk=max(1, slices))
    splits, chunk = _split(p.tiles, slices, p.bk, _TILES["wgmma"][3])
    return dataclasses.replace(p, splits=splits, chunk=chunk)


def plan_call(x: torch.Tensor, w: torch.Tensor) -> Plan:
    """The plan of ``matmul_cuda(x, w)``, from the operands' shapes, type,
    layouts and alignment (the kernel itself is not touched)."""
    return plan(x.size(0), w.size(1), x.size(1), x.dtype == torch.bfloat16,
                _operand(x, "x")[3] and _operand(w, "w")[3])


def _check_dtypes(name, a, b, out_dtype):
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"{name} needs its operands on one CUDA device")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"{name} takes fp32 or bf16 operands of one dtype, "
                        f"got {a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"{name} out_dtype must be fp32 or bf16, got "
                        f"{out_dtype}")


def _epilogue_operand(name, t, shape, like):
    if t is None:
        return
    if t.device != like.device or t.dtype not in (torch.float32, like.dtype):
        raise TypeError(f"{name} must be fp32 or {like.dtype} on "
                        f"{like.device}")
    if tuple(t.shape) != shape or t.stride(-1) != 1:
        raise ValueError(f"{name} must be {shape} with unit last stride, got "
                         f"{tuple(t.shape)}")


def _raise_on(rc, lib, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.repro_cuda_error_string(rc).decode()})")


def matmul_cuda(x, w, bias=None, c0=None, *, activation: str = "none",
                alpha: float = 1.0, beta: float = 0.0, out_dtype=None):
    """``act(alpha * x @ w + beta * c0 + bias)`` on the card.

    x: (m, k) and w: (k, n), each either row-major or column-major (as
    ``x.T`` and ``table.T`` are), read in place.  bias: (n,) contiguous;
    c0: (m, n) with unit column stride; both fp32 or x's dtype.  Returns a
    contiguous (m, n) of ``out_dtype`` (fp32 or bf16; default x's dtype).
    """
    out_dtype = out_dtype or x.dtype
    _check_dtypes("matmul_cuda", x, w, out_dtype)
    if x.dim() != 2 or w.dim() != 2 or x.size(1) != w.size(0):
        raise ValueError(f"matmul_cuda shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    m, k = x.shape
    n = w.size(1)
    x_trans, ldx, vec_x, tma_x = _operand(x, "x")
    w_trans, ldw, vec_w, tma_w = _operand(w, "w")
    _epilogue_operand("bias", bias, (n,), x)
    _epilogue_operand("c0", c0, (m, n), x)
    has_c0 = c0 is not None and beta != 0.0
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    is_bf16 = x.dtype == torch.bfloat16
    p = plan(m, n, k, is_bf16, tma_x and tma_w)
    ws = (torch.empty(p.splits * m * n, dtype=torch.float32, device=x.device)
          if p.splits > 1 else None)
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
        int(vec_x), int(vec_w), MAINLOOPS.index(p.mainloop), p.bm, p.splits,
        p.chunk, ws.data_ptr() if ws is not None else None,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, lib, "matmul")
    matmul_cuda.launches += 1
    matmul_cuda.mainloops[p.mainloop] += 1
    matmul_cuda.split_launches += p.splits > 1
    return out


def reset_matmul_counts(fn=None):
    """Zero the counters of ``matmul_cuda``, ``batched_matmul_cuda`` and
    ``brgemm_stacked_cuda`` (or those of a stand-in ``fn`` bound to
    matmul's name, alone)."""
    for f in (fn,) if fn is not None else (matmul_cuda, batched_matmul_cuda,
                                           brgemm_stacked_cuda):
        f.launches = f.split_launches = 0
        f.mainloops = dict.fromkeys(MAINLOOPS, 0)


def _batched_operand(t: torch.Tensor, name: str) -> list:
    """[ptr, batch stride, ld, trans, vec] of a (B, r, c) operand read in
    place, or of a 2-D (r, c) one broadcast over the batch (stride 0)."""
    mat = t[0] if t.dim() == 3 else t
    trans, ld = _layout(mat, name)
    bstride = t.stride(0) if t.dim() == 3 and t.size(0) > 1 else 0
    vec = (t.dtype == torch.bfloat16 and _aligned(t, ld)
           and bstride % 8 == 0)
    return [t.data_ptr(), bstride, ld, trans, int(vec)]


def _batched_tma(t: torch.Tensor, operand: list) -> bool:
    """TMA can describe a batched operand: matmul's rule for one entry
    (``_operand``), and entries that lie apart: a batch stride that is a
    multiple of 8 elements and covers an entry (0 for one entry or a
    broadcast: a 2-D map)."""
    _, bstride, ld, trans, vec = operand
    mat = t[0] if t.dim() == 3 else t
    return bool(vec) and ld >= mat.size(trans ^ 1) and (
        bstride == 0 or bstride >= mat.size(trans) * ld)


def plan_batched_call(a: torch.Tensor, b: torch.Tensor) -> Plan:
    """The plan of ``batched_matmul_cuda(a, b)``, from the operands' shapes,
    type, layouts and alignment (the kernel itself is not touched)."""
    oa, ob = _batched_operand(a, "a"), _batched_operand(b, "b")
    return plan_batched(a.size(-2), b.size(-1), a.size(-1),
                        a.dtype == torch.bfloat16,
                        _batched_tma(a, oa) and _batched_tma(b, ob))


def plan_stacked_call(a: torch.Tensor, b: torch.Tensor) -> Plan:
    """The plan of ``brgemm_stacked_cuda(a, b)``, from the operands' shapes,
    type, layouts and alignment (the kernel itself is not touched)."""
    oa, ob = _batched_operand(a, "a"), _batched_operand(b, "b")
    return plan_stacked(a.size(0), a.size(1), b.size(2), a.size(2),
                        a.dtype == torch.bfloat16,
                        _batched_tma(a, oa) and _batched_tma(b, ob))


def _flags(a, out_dtype, *epilogue):
    return [int(a.dtype == torch.bfloat16), int(out_dtype == torch.float32),
            *(int(t is not None and t.dtype == torch.float32)
              for t in epilogue)]


def brgemm_stacked_cuda(a, b, bias=None, c0=None, *,
                        activation: str = "none", alpha: float = 1.0,
                        beta: float = 0.0, out_dtype=None):
    """``act(alpha * sum_i a[i] @ b[i] + beta * c0 + bias)`` on the card.

    a: (B, m, k) and b: (B, k, n), each entry row- or column-major with any
    batch stride, read in place.  bias: (n,) contiguous; c0: (m, n) with
    unit column stride; both fp32 or a's dtype.  Returns a contiguous
    (m, n) of ``out_dtype`` (fp32 or bf16; default a's dtype).
    """
    out_dtype = out_dtype or a.dtype
    _check_dtypes("brgemm_stacked_cuda", a, b, out_dtype)
    if a.dim() != 3 or b.dim() != 3 or a.size(0) != b.size(0) \
            or a.size(2) != b.size(1):
        raise ValueError(f"brgemm_stacked_cuda shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    nb, m, k = a.shape
    n = b.size(2)
    _epilogue_operand("bias", bias, (n,), a)
    _epilogue_operand("c0", c0, (m, n), a)
    has_c0 = c0 is not None and beta != 0.0
    c0 = c0 if has_c0 else None
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    oa, ob = _batched_operand(a, "a"), _batched_operand(b, "b")
    p = plan_stacked(nb, m, n, k, a.dtype == torch.bfloat16,
                     _batched_tma(a, oa) and _batched_tma(b, ob))
    ws = (torch.empty(p.splits * m * n, dtype=torch.float32, device=a.device)
          if p.splits > 1 else None)
    lib = _batched_lib()
    rc = lib.repro_brgemm_stacked(
        *oa, *ob, bias.data_ptr() if bias is not None else None,
        c0.data_ptr() if has_c0 else None, _row_stride(c0) if has_c0 else 0,
        out.data_ptr(), nb, m, n, k, float(alpha), float(beta),
        fusion.code(activation), *_flags(a, out_dtype, bias, c0),
        MAINLOOPS.index(p.mainloop), p.bm, p.splits, p.chunk,
        ws.data_ptr() if ws is not None else None,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, lib, "brgemm_stacked")
    brgemm_stacked_cuda.launches += 1
    brgemm_stacked_cuda.mainloops[p.mainloop] += 1
    brgemm_stacked_cuda.split_launches += p.splits > 1
    return out


def batched_matmul_cuda(a, b, bias=None, *, activation: str = "none",
                        alpha: float = 1.0, out_dtype=None):
    """``act(alpha * a[i] @ b[i] + bias)`` for each i, on the card.

    a: (B, m, k) or a 2-D (m, k) broadcast over the batch; b: (B, k, n) or
    a 2-D (k, n) broadcast; not both 2-D.  Each entry row- or column-major
    (as ``swapaxes(-1, -2)`` views are) with any batch stride, read in
    place.  bias: (n,) contiguous, fp32 or a's dtype.  Returns a contiguous
    (B, m, n) of ``out_dtype`` (default a's dtype).
    """
    out_dtype = out_dtype or a.dtype
    _check_dtypes("batched_matmul_cuda", a, b, out_dtype)
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) \
            or a.dim() + b.dim() == 4 or a.size(-1) != b.size(-2) \
            or (a.dim() == b.dim() == 3 and a.size(0) != b.size(0)):
        raise ValueError(f"batched_matmul_cuda shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain (one operand may "
                         f"be 2-D)")
    nb = a.size(0) if a.dim() == 3 else b.size(0)
    m, k = a.shape[-2:]
    n = b.size(-1)
    _epilogue_operand("bias", bias, (n,), a)
    out = torch.empty((nb, m, n), dtype=out_dtype, device=a.device)
    if nb == 0 or m == 0 or n == 0:
        return out
    oa, ob = _batched_operand(a, "a"), _batched_operand(b, "b")
    p = plan_batched(m, n, k, a.dtype == torch.bfloat16,
                     _batched_tma(a, oa) and _batched_tma(b, ob))
    lib = _batched_lib()
    rc = lib.repro_batched_matmul(
        *oa, *ob, bias.data_ptr() if bias is not None else None,
        out.data_ptr(), nb, m, n, k, float(alpha), fusion.code(activation),
        *_flags(a, out_dtype, bias), MAINLOOPS.index(p.mainloop), p.bm,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, lib, "batched_matmul")
    batched_matmul_cuda.launches += 1
    batched_matmul_cuda.mainloops[p.mainloop] += 1
    return out


reset_matmul_counts()

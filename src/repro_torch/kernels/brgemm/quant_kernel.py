"""Wrappers of the quantized Hopper GEMM kernels (``kernels/brgemm_quant``).

``matmul_q_cuda``, ``brgemm_q_cuda`` and ``batched_matmul_q_cuda`` launch
the kernels of ``brgemm_quant/csrc/quant.cu``.  Each checks what the
kernels take (int8 operands, or fp8 e4m3 / e5m2 ones; fp32 scales; bf16 or
fp32 out), allocates the output, and launches on the current stream; the
library is built at first use (``kernels/_build.py``).  Operands are read
in place, each matrix row- or column-major with any batch stride; scales
through their strides, so an expanded per-tensor scale is never copied.

``plan_q`` decides how ``matmul_q_cuda`` runs a call: on the shared wgmma +
TMA mainloop (``wgmma``: native 8-bit wgmma for int8 on 128 or 64 x 128
tiles, fp8 widened exactly to f16 for f16 wgmma on 64 x 128 tiles, k split
where the tiles alone leave SMs idle) where both operands are K-major and
TMA can describe them (xq row-major, wq column-major: the calibrated
storage of ``core/quantize.py::quantize_weight`` and the LM head's
``table.T``), else on the first kernel's 64 x 64 wmma tiles (``wmma``).
``plan_q_stacked`` decides ``brgemm_q_cuda``'s the same way, the batch
folded into the reduction and its (entry, 128-element slice) axis split as
``plan_q`` splits k, and ``plan_q_batched`` ``batched_matmul_q_cuda``'s,
one entry a block, one split: each entry of aq row-major and of bq
column-major (a 2-D operand broadcast over the batch alike).  Those are
the heuristic: each wrapper takes its plan from ``dispatch.resolve_blocks``
(op ``matmul``, ``brgemm`` or ``batched_matmul``, the weights' storage
dtype and the quant tag in the key, as the reference's quantized entry
points resolve theirs), which returns the explicit ``plan=``, else the
block policy's pick, else the heuristic's; ``candidate_plans_q`` is the
grid a measured policy searches.  The plans decide before the launch;
nothing falls back.  ``<wrapper>.launches``
counts each wrapper's launches, ``.mainloops`` its calls by mainloop and
``.split_launches`` those that also launched the split-K reduction
(``reset_quant_counts`` zeroes them).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import blocking, dispatch, fusion
from repro_torch.core.blocking import GemmGeometry, Plan, PlanSchema
from repro_torch.core.quantize import QuantConfig, storage_name
from repro_torch.kernels import _build
from repro_torch.kernels.brgemm.kernel import (PER_SM, SMS, _layout,
                                               _raise_on, _split)

# Storage dtype -> the kernel's format code (quant.cu, enum Fmt).
FORMATS = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
_OUT = (torch.float32, torch.bfloat16)
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

MAINLOOPS = ("wgmma", "wmma")    # the wrappers' mainloops
BK = 128                          # the wgmma mainloop's k a slice: 128 bytes
# A split walks at least this much of k.  matmul's bf16 runs of 512 are
# 1 KB a row; an 8-bit run of 1024 is the same bytes.  fp8, whose slices
# a block widens to f16 before its products, splits down to one slice.
MIN_SPLIT_K = 1024
MIN_SPLIT_K_FP8 = BK


@functools.cache
def _lib():
    lib = _build.load("brgemm_quant")
    operand = [_P, _LL, _LL, _I, _I]
    scales = [_P, _LL, _LL]
    lib.repro_quant_gemm.argtypes = (operand * 2 + scales * 2 + [
        _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P])
    lib.repro_quant_gemm.restype = ctypes.c_int
    lib.repro_matmul_q.argtypes = [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P,
                                   _P, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _P, _P]
    lib.repro_brgemm_q.argtypes = [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _P,
                                   _LL, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _P, _P]
    lib.repro_batched_matmul_q.argtypes = [
        _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _I,
        _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P]
    for fn in (lib.repro_matmul_q, lib.repro_brgemm_q,
               lib.repro_batched_matmul_q):
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _operand(t: torch.Tensor, name: str) -> list:
    """[ptr, batch stride, ld, trans, vec] of a (B, r, c) operand read in
    place, or of a 2-D (r, c) one broadcast over the batch (stride 0).
    vec: the kernel's wide loads (16 bytes of int8, 8 of fp8) are aligned."""
    mat = t[0] if t.dim() == 3 else t
    trans, ld = _layout(mat, name)
    bstride = t.stride(0) if t.dim() == 3 and t.size(0) > 1 else 0
    width = 16 if t.dtype == torch.int8 else 8
    vec = all(v % width == 0 for v in (t.data_ptr(), ld, bstride))
    return [t.data_ptr(), bstride, ld, trans, int(vec)]


def _scales(s: torch.Tensor, name: str, like: torch.Tensor, shape) -> list:
    """[ptr, batch stride, stride] of an fp32 scale vector (``shape[-1]``
    entries), one per batch entry when ``shape`` is 2-D, read in place."""
    if s.device != like.device or s.dtype != torch.float32:
        raise TypeError(f"{name} must be fp32 on {like.device}, got "
                        f"{s.dtype} on {s.device}")
    if tuple(s.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(s.shape)}")
    if s.dim() == 1:
        return [s.data_ptr(), 0, s.stride(0)]
    return [s.data_ptr(), s.stride(0), s.stride(1)]


def _check(name, a, b, bias, out_dtype, n):
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"{name} needs its operands on one CUDA device")
    if a.dtype not in FORMATS or b.dtype not in FORMATS or (
            (a.dtype == torch.int8) != (b.dtype == torch.int8)):
        raise TypeError(f"{name} takes int8 operands, or fp8 (e4m3 / e5m2) "
                        f"ones, got {a.dtype} and {b.dtype}")
    if out_dtype not in _OUT:
        raise TypeError(f"{name} out_dtype must be fp32 or bf16, got "
                        f"{out_dtype}")
    if bias is not None and (
            bias.device != a.device or bias.dtype not in _OUT
            or tuple(bias.shape) != (n,) or bias.stride(0) != 1):
        raise ValueError(f"{name} bias must be a contiguous fp32 or bf16 "
                         f"({n},) on {a.device}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _flags(aq, bq, out, bias) -> list:
    return [FORMATS[aq.dtype], FORMATS[bq.dtype],
            int(out.dtype == torch.float32),
            int(bias is not None and bias.dtype == torch.float32)]


def _launch(name, a, b, sa, sb, bias, out, nb, m, n, k, stacked, alpha,
            activation):
    lib = _lib()
    rc = lib.repro_quant_gemm(
        *_operand(a, "a"), *_operand(b, "b"), *sa, *sb,
        _ptr(bias), out.data_ptr(), nb, m, n, k, int(stacked), float(alpha),
        fusion.code(activation), *_flags(a, b, out, bias),
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(rc, lib, name)


@functools.lru_cache(maxsize=4096)
def plan_q(m: int, n: int, k: int, tma: bool, fp8: bool = False) -> Plan:
    """How ``matmul_q_cuda`` runs an (m, k) @ (k, n) 8-bit product.

    ``tma``: xq is row-major and wq column-major (K-major both, as 8-bit
    wgmma needs), each with a 16-byte aligned base and a row stride that
    is a multiple of 16 elements and covers a row.  Calls TMA cannot read
    take the 64 x 64 wmma tiles, k whole.  The rest take the wgmma
    mainloop, int8 and fp8 (``fp8``: widened to f16 in the kernel) alike:
    64-row tiles where m <= 64 or the operands are fp8, k cut as
    ``kernel.plan`` cuts bf16's (equal runs of whole 128-element slices,
    no shorter than MIN_SPLIT_K, or MIN_SPLIT_K_FP8, while the tiles
    alone leave SMs idle, until the blocks fill them once: two blocks an
    SM for fp8)."""
    if not tma or k == 0:
        return Plan("wmma", 64, 64, 1, max(1, -(-k // 64)),
                    -(-m // 64) * -(-n // 64))
    bm = 64 if m <= 64 or fp8 else 128
    tiles = -(-m // bm) * -(-n // 128)
    splits, chunk = _split(tiles, -(-k // BK), BK, 2 if fp8 else 1,
                           MIN_SPLIT_K_FP8 if fp8 else MIN_SPLIT_K)
    return Plan("wgmma", bm, BK, splits, chunk, tiles)


def _k_major(t: torch.Tensor, row_major: bool) -> tuple[int, int, bool]:
    """(batch stride, ld, ok) of an operand read K-major, k along the rows
    of each entry (``row_major``, as xq and aq) or along its columns (as wq
    and bq): a (B, r, c) operand, or a 2-D one (batch stride 0; read by
    every entry where the other operand is 3-D).  ld: the stride between
    an entry's runs of k.  ok: TMA can read it so (k contiguous, 16-byte
    aligned base, ld a multiple of 16 elements that covers a run, entries
    apart by a multiple of 16 elements that covers an entry: a 3-D map)."""
    mat = t[0] if t.dim() == 3 else t
    rows, cols = mat.shape
    outer, inner = (rows, cols) if row_major else (cols, rows)
    unit = (mat.stride(1) if row_major else mat.stride(0)) == 1 or inner == 1
    ld = (mat.stride(0) if row_major else mat.stride(1)) if outer > 1 \
        else inner
    bstride = t.stride(0) if t.dim() == 3 and t.size(0) > 1 else 0
    return bstride, ld, bool(
        unit and t.data_ptr() % 16 == 0 and ld % 16 == 0 and ld >= inner
        and bstride % 16 == 0 and (bstride == 0 or bstride >= outer * ld))


def _q_operands(a, b) -> tuple[list, bool]:
    """([a's batch stride, lda, b's batch stride, ldb], tma): a read K-major
    along its rows and b along its columns (``_k_major``), and whether the
    wgmma mainloop can take both."""
    sa, lda, oka = _k_major(a, True)
    sb, ldb, okb = _k_major(b, False)
    return [sa, lda, sb, ldb], oka and okb


def _quant(aq, bq, quant):
    """The call's quant config: the caller's, else the storage dtypes'
    with the default scales (``QuantConfig``)."""
    if quant is not None:
        return quant
    return QuantConfig(w_dtype=storage_name(bq.dtype),
                       a_dtype=storage_name(aq.dtype))


def _q_plan(op, aq, bq, explicit=None, quant=None):
    """(plan, [a's batch stride, lda, b's batch stride, ldb]) of a
    quantized call, its triple one entry's."""
    strides, tma = _q_operands(aq, bq)
    nb = 1 if op == "matmul" else (aq.size(0) if aq.dim() == 3
                                   else bq.size(0))
    p = dispatch.resolve_blocks(
        op, aq.size(-2), bq.size(-1), aq.size(-1), bq.dtype, backend="cuda",
        plan=explicit, geometry=GemmGeometry(tma, nb, False, True),
        quant=_quant(aq, bq, quant))
    if explicit is None and dispatch.localising():
        p = blocking.fit_plan(p, (nb if op == "brgemm" else 1)
                              * -(-aq.size(-1) // p.bk))
    return p, strides


def plan_q_call(xq: torch.Tensor, wq: torch.Tensor) -> Plan:
    """The plan of ``matmul_q_cuda(xq, wq, ...)``, from the operands'
    shapes, layouts and alignment under the active block policy (the
    kernel itself is not touched)."""
    return _q_plan("matmul", xq, wq)[0]


@functools.lru_cache(maxsize=4096)
def plan_q_stacked(nb: int, m: int, n: int, k: int, tma: bool,
                   fp8: bool = False) -> Plan:
    """How ``brgemm_q_cuda`` runs sum_i (m, k) @ (k, n) over ``nb``
    entries: ``plan_q``'s mainloop and tile for one entry.  On wgmma the
    reduction is the flattened (entry, 128-element slice) axis of nb *
    ceil(k / 128) slices, split as ``plan_q`` splits k (runs no shorter
    than MIN_SPLIT_K, or MIN_SPLIT_K_FP8); the wmma tiles walk it whole, in
    one block an output tile.  ``chunk``: slices a split."""
    p = plan_q(m, n, k, tma and nb > 0, fp8)
    slices = nb * -(-k // p.bk)
    if p.mainloop != "wgmma":
        return dataclasses.replace(p, splits=1, chunk=max(1, slices))
    splits, chunk = _split(p.tiles, slices, BK, 2 if fp8 else 1,
                           MIN_SPLIT_K_FP8 if fp8 else MIN_SPLIT_K)
    return dataclasses.replace(p, splits=splits, chunk=chunk)


@functools.lru_cache(maxsize=4096)
def plan_q_batched(nb: int, m: int, n: int, k: int, tma: bool,
                   fp8: bool = False) -> Plan:
    """How ``batched_matmul_q_cuda`` runs a (B, m, k) @ (B, k, n) product
    over ``nb`` entries: ``plan_q``'s mainloop and tile for one entry, and
    one run of k (the entries fill the card; no split).  64-row tiles also
    where the entries' 128-row tiles would leave SMs idle: such a call
    takes a block's latency, which more, shorter blocks cut (B = 32, m = n
    = k = 128: 0.0111 → 0.0081 ms on an H100, PERF.md).  ``tiles``:
    output tiles an entry."""
    p = plan_q(m, n, k, tma, fp8)
    if p.mainloop == "wgmma" and p.bm == 128 and nb * p.tiles < SMS:
        p = dataclasses.replace(p, bm=64, tiles=-(-m // 64) * -(-n // 128))
    return dataclasses.replace(p, splits=1, chunk=max(1, -(-k // p.bk)))


def plan_q_stacked_call(aq: torch.Tensor, bq: torch.Tensor) -> Plan:
    """The plan of ``brgemm_q_cuda(aq, bq, ...)``, from the operands'
    shapes, layouts and alignment under the active block policy."""
    return _q_plan("brgemm", aq, bq)[0]


def plan_q_batched_call(aq: torch.Tensor, bq: torch.Tensor) -> Plan:
    """The plan of ``batched_matmul_q_cuda(aq, bq, ...)``, from the
    operands' shapes, layouts and alignment under the active block
    policy."""
    return _q_plan("batched_matmul", aq, bq)[0]


def candidate_plans_q(op: str, m: int, n: int, k: int, tma: bool,
                      fp8: bool = False, nb: int = 1) -> list[Plan]:
    """The plans a measured policy searches for a quantized ``op``
    (``matmul``, ``brgemm`` over ``nb`` entries or ``batched_matmul``),
    heuristic first: on the wgmma mainloop (TMA reads both operands
    K-major) its tile rows (64 or 128 for int8, 64 for fp8) and the split
    counts ``_split`` gives at PER_SM blocks an SM (``batched_matmul``
    never splits); otherwise the one wmma plan.  Every one is a plan
    ``quant.cu`` takes at run time."""
    heuristic = {"matmul": lambda: plan_q(m, n, k, tma, fp8),
                 "brgemm": lambda: plan_q_stacked(nb, m, n, k, tma, fp8),
                 "batched_matmul": lambda: plan_q_batched(
                     nb, m, n, k, tma, fp8)}[op]()
    out = [heuristic]
    if heuristic.mainloop != "wgmma":
        return out
    slices = -(-k // BK) * (nb if op == "brgemm" else 1)
    for bm in (64,) if fp8 else (64, 128):
        tiles = -(-m // bm) * -(-n // 128)
        for per_sm in PER_SM:
            if op == "batched_matmul":
                splits, chunk = 1, max(1, slices)
            else:
                splits, chunk = _split(tiles, slices, BK, per_sm,
                                       MIN_SPLIT_K_FP8 if fp8
                                       else MIN_SPLIT_K)
            p = Plan("wgmma", bm, BK, splits, chunk, tiles)
            if p not in out:
                out.append(p)
    return out


def _is_fp8(dtype) -> bool:
    return blocking.dtype_name(dtype) != "int8"


def _plain_geometry(m, n, k, dtype) -> GemmGeometry:
    """xq row-major, wq column-major (K-major both), contiguous: TMA reads
    rows of 16 bytes."""
    return GemmGeometry(k % 16 == 0, 1, False, True)


for _op, _heuristic in (
        ("matmul", lambda m, n, k, dt, g: plan_q(m, n, k, g.tma,
                                                 _is_fp8(dt))),
        ("brgemm", lambda m, n, k, dt, g: plan_q_stacked(
            g.nb, m, n, k, g.tma, _is_fp8(dt))),
        ("batched_matmul", lambda m, n, k, dt, g: plan_q_batched(
            g.nb, m, n, k, g.tma, _is_fp8(dt)))):
    blocking.register_schema(_op, PlanSchema(
        heuristic=_heuristic,
        candidates=lambda m, n, k, dt, g, _op=_op: candidate_plans_q(
            _op, m, n, k, g.tma, _is_fp8(dt), g.nb),
        geometry=_plain_geometry), quant=True)


def _count(fn, p: Plan):
    fn.launches += 1
    fn.mainloops[p.mainloop] += 1
    fn.split_launches += p.splits > 1


def _workspace(p: Plan, m: int, n: int, like: torch.Tensor):
    """The (splits, m, n) partials of a split plan: int32 for int8, fp32
    for fp8; None for one split."""
    if p.splits == 1:
        return None
    return torch.empty(p.splits * m * n, device=like.device,
                       dtype=torch.int32 if like.dtype == torch.int8
                       else torch.float32)


def matmul_q_cuda(xq, wq, sx, sw, bias=None, *, activation: str = "none",
                  alpha: float = 1.0, out_dtype=torch.float32,
                  plan: Plan | None = None, quant=None):
    """``act(alpha * (xq @ wq) * (sx x sw) + bias)`` on the card.

    xq: (m, k), wq: (k, n), both int8 or both fp8 (each operand e4m3 or
    e5m2), each row- or column-major; xq row-major and wq column-major run
    the wgmma mainloop (``plan_q``).  sx: (m,), sw: (n,) fp32, any stride;
    bias: (n,) contiguous fp32 or bf16.  Returns a contiguous (m, n) of
    ``out_dtype``.  ``plan``: run so, else the block policy's pick, keyed
    by ``quant`` (the caller's ``QuantConfig``; default the storage
    dtypes').
    """
    _check("matmul_q_cuda", xq, wq, bias, out_dtype, wq.shape[-1])
    if xq.dim() != 2 or wq.dim() != 2 or xq.size(1) != wq.size(0):
        raise ValueError(f"matmul_q_cuda shapes {tuple(xq.shape)} @ "
                         f"{tuple(wq.shape)} do not chain")
    m, k = xq.shape
    n = wq.size(1)
    sa = _scales(sx, "sx", xq, (m,))
    sb = _scales(sw, "sw", xq, (n,))
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m == 0 or n == 0:
        return out
    p, (_, ldx, _, ldw) = _q_plan("matmul", xq, wq, plan, quant)
    if p.mainloop == "wgmma":
        ws = _workspace(p, m, n, xq)
        lib = _lib()
        rc = lib.repro_matmul_q(
            xq.data_ptr(), ldx, wq.data_ptr(), ldw, sa[0], sa[2], sb[0],
            sb[2], _ptr(bias), out.data_ptr(), m, n, k, float(alpha),
            fusion.code(activation), *_flags(xq, wq, out, bias), p.bm,
            p.splits, p.chunk, _ptr(ws),
            torch.cuda.current_stream(xq.device).cuda_stream)
        _raise_on(rc, lib, "matmul_q")
    else:
        _launch("matmul_q", xq, wq, sa, sb, bias, out, 1, m, n, k, True,
                alpha, activation)
    _count(matmul_q_cuda, p)
    return out


def brgemm_q_cuda(aq, bq, sa, sb, bias=None, *, activation: str = "none",
                  alpha: float = 1.0, out_dtype=torch.float32,
                  plan: Plan | None = None, quant=None):
    """``act(alpha * (sum_i aq[i] @ bq[i]) * (sa x sb) + bias)`` on the card.

    aq: (B, m, k), bq: (B, k, n), each entry row- or column-major with any
    batch stride; entries of aq row-major and of bq column-major run the
    wgmma mainloop (``plan_q_stacked``).  sa: (m,), sb: (n,) fp32,
    batch-shared.  Returns a contiguous (m, n) of ``out_dtype``.  ``plan``
    and ``quant``: as ``matmul_q_cuda``'s.
    """
    _check("brgemm_q_cuda", aq, bq, bias, out_dtype, bq.shape[-1])
    if aq.dim() != 3 or bq.dim() != 3 or aq.size(0) != bq.size(0) \
            or aq.size(2) != bq.size(1):
        raise ValueError(f"brgemm_q_cuda shapes {tuple(aq.shape)} @ "
                         f"{tuple(bq.shape)} do not chain")
    nb, m, k = aq.shape
    n = bq.size(2)
    sr = _scales(sa, "sa", aq, (m,))
    sc = _scales(sb, "sb", aq, (n,))
    out = torch.empty((m, n), dtype=out_dtype, device=aq.device)
    if nb == 0:
        raise ValueError("brgemm_q_cuda needs at least one batch entry")
    if m == 0 or n == 0:
        return out
    p, strides = _q_plan("brgemm", aq, bq, plan, quant)
    if p.mainloop == "wgmma":
        ws = _workspace(p, m, n, aq)
        lib = _lib()
        rc = lib.repro_brgemm_q(
            aq.data_ptr(), *strides[:2], bq.data_ptr(), *strides[2:],
            sr[0], sr[2], sc[0], sc[2], _ptr(bias), out.data_ptr(), nb,
            m, n, k, float(alpha), fusion.code(activation),
            *_flags(aq, bq, out, bias), p.bm, p.splits, p.chunk, _ptr(ws),
            torch.cuda.current_stream(aq.device).cuda_stream)
        _raise_on(rc, lib, "brgemm_q")
    else:
        _launch("brgemm_q", aq, bq, sr, sc, bias, out, nb, m, n, k, True,
                alpha, activation)
    _count(brgemm_q_cuda, p)
    return out


def batched_matmul_q_cuda(aq, bq, sa, sb, bias=None, *,
                          activation: str = "none", alpha: float = 1.0,
                          out_dtype=torch.float32, plan: Plan | None = None,
                          quant=None):
    """``act(alpha * (aq[i] @ bq[i]) * (sa[i] x sb[i]) + bias)`` for each i.

    aq: (B, m, k) or a 2-D (m, k) broadcast over the batch; bq: (B, k, n)
    or a 2-D (k, n); not both 2-D.  Entries of aq row-major and of bq
    column-major run the wgmma mainloop (``plan_q_batched``).  sa: (B, m)
    or (m,); sb: (B, n) or (n,) (a 1-D scale row is shared by every
    entry).  Returns a contiguous (B, m, n) of ``out_dtype``.  ``plan``
    and ``quant``: as ``matmul_q_cuda``'s.
    """
    _check("batched_matmul_q_cuda", aq, bq, bias, out_dtype, bq.shape[-1])
    if aq.dim() not in (2, 3) or bq.dim() not in (2, 3) \
            or aq.dim() + bq.dim() == 4 or aq.size(-1) != bq.size(-2) \
            or (aq.dim() == bq.dim() == 3 and aq.size(0) != bq.size(0)):
        raise ValueError(f"batched_matmul_q_cuda shapes {tuple(aq.shape)} @ "
                         f"{tuple(bq.shape)} do not chain (one operand may "
                         f"be 2-D)")
    nb = aq.size(0) if aq.dim() == 3 else bq.size(0)
    m, k = aq.shape[-2:]
    n = bq.size(-1)
    sr = _scales(sa, "sa", aq, (nb, m) if sa.dim() == 2 else (m,))
    sc = _scales(sb, "sb", aq, (nb, n) if sb.dim() == 2 else (n,))
    out = torch.empty((nb, m, n), dtype=out_dtype, device=aq.device)
    if nb == 0 or m == 0 or n == 0:
        return out
    p, strides = _q_plan("batched_matmul", aq, bq, plan, quant)
    if p.mainloop == "wgmma":
        lib = _lib()
        rc = lib.repro_batched_matmul_q(
            aq.data_ptr(), *strides[:2], bq.data_ptr(), *strides[2:], *sr,
            *sc, _ptr(bias), out.data_ptr(), nb, m, n, k, float(alpha),
            fusion.code(activation), *_flags(aq, bq, out, bias), p.bm,
            torch.cuda.current_stream(aq.device).cuda_stream)
        _raise_on(rc, lib, "batched_matmul_q")
    else:
        _launch("batched_matmul_q", aq, bq, sr, sc, bias, out, nb, m, n, k,
                False, alpha, activation)
    _count(batched_matmul_q_cuda, p)
    return out


def reset_quant_counts():
    """Zero the counters of the three quantized GEMM wrappers."""
    for f in (matmul_q_cuda, brgemm_q_cuda, batched_matmul_q_cuda):
        f.launches = f.split_launches = 0
        f.mainloops = dict.fromkeys(MAINLOOPS, 0)


reset_quant_counts()

"""The quantized batched GEMMs' plans, their wgmma walks and their routing's
K-major B, on the CPU.

``plan_q_stacked`` and ``plan_q_batched`` (``kernels/brgemm/quant_kernel.py``)
are plain Python: at the four cases of the quantized ``brgemm`` /
``batched_matmul`` path (chip_smoke.py's BRGEMM_CASES), with the operands
laid out as the path hands them over (activations row-major, B K-major),
both run the wgmma mainloop in int8 and e4m3; rows that are not 16-byte
aligned (the smoke's ragged (5, 70, 100, 130)) and an N-major B run the
64 x 64 wmma tiles.  The stacked plan's splits cover every (entry,
128-element slice) of the folded reduction exactly once.

Numpy models of what the wgmma kernels compute under a plan are held
against the reference's Pallas kernels in interpret mode: the STACKED walk
of ``brgemm_q`` (each entry's k in slices of 128, the ragged tail
zero-filled, a slice's products summed exactly and rounded once, int32 for
s8 and fp32 for fp8, in slice order; the splits' partials added in split
order; the dequant in fp32) against ``brgemm_q_pallas``, s8 bit for bit
with no bias and alpha 1, 1e-6 with them, fp8 within 1e-5
(test_torch_matmul_q.py's bands); the PER_ENTRY walk of
``batched_matmul_q`` with its scales read through entry strides, as the
kernel's ``DequantEntry`` reads them ((B, m) / (B, n), or a shared 1-D row
at entry stride 0), against ``batched_matmul_q_pallas`` given the scales
expanded.  tests/test_torch_gpu.py and chip_smoke.py hold the kernels
themselves on the card.

The routing (``kernels/brgemm/quant.py``) hands both kernels a K-major B
whose bits are the reference quantizer's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as JQ
from repro.kernels.brgemm import quant_kernel as JQK
from repro_torch import quant
from repro_torch.core.quantize import QuantConfig
from repro_torch.kernels.brgemm import quant as Q
from repro_torch.kernels.brgemm import quant_kernel as QK
from repro_torch.kernels.brgemm import quant_ref as QR
from repro_torch.kernels.brgemm.quant_kernel import (BK, MIN_SPLIT_K,
                                                     MIN_SPLIT_K_FP8,
                                                     plan_q_batched,
                                                     plan_q_batched_call,
                                                     plan_q_stacked,
                                                     plan_q_stacked_call)

FORMATS = ("int8", "float8_e4m3fn")
# chip_smoke.py's BRGEMM_CASES, (B, m, k, n)
CASES = [(16, 64, 64, 64), (32, 128, 128, 128), (64, 64, 256, 64),
         (8, 4096, 1024, 1024)]
TORCH_DTYPES = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _laid_out(nb, m, k, n, fmt):
    """aq (nb, m, k) row-major and bq (nb, k, n) K-major, as the path lays
    them out (test_routing_hands_k_major_b_with_reference_bits holds the
    path to it), without the cost of quantizing the largest case."""
    dtype = TORCH_DTYPES[fmt]
    return (torch.empty(nb, m, k, dtype=dtype),
            torch.empty(nb, n, k, dtype=dtype).mT)


# --------------------------------------------------------------------------
# the plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("nb,m,k,n", CASES)
def test_plans_run_the_paths_cases_on_wgmma(nb, m, k, n, fmt):
    aq, bq = _laid_out(nb, m, k, n, fmt)
    fp8 = fmt != "int8"
    p = plan_q_stacked_call(aq, bq)
    assert p == plan_q_stacked(nb, m, n, k, True, fp8)
    assert p.mainloop == "wgmma" and p.bk == BK == 128
    assert p.bm == (64 if m <= 64 or fp8 else 128)
    assert p.tiles == -(-m // p.bm) * -(-n // 128)
    assert p.splits == 1 or p.chunk * BK >= (MIN_SPLIT_K_FP8 if fp8
                                             else MIN_SPLIT_K)
    q = plan_q_batched_call(aq, bq)
    assert q == plan_q_batched(nb, m, n, k, True, fp8)
    # 64-row tiles also where the entries' 128-row tiles leave SMs idle
    # (B32 m128: 32 blocks); the large case keeps 128 rows for int8
    assert q.bm == (128 if (nb, m) == (8, 4096) and not fp8 else 64)
    assert (q.mainloop, q.splits, q.chunk) == ("wgmma", 1, -(-k // BK))
    assert q.tiles == -(-m // q.bm) * -(-n // 128)
    # a 2-D operand broadcast over the batch: a 2-D map, the same plan
    assert plan_q_batched_call(aq[0], bq) == q
    assert plan_q_batched_call(aq, bq[0]) == q


@pytest.mark.parametrize("fmt", FORMATS)
def test_plans_put_what_tma_cannot_read_on_wmma(fmt):
    # the smoke's ragged case: rows of 100 bytes
    aq, bq = _laid_out(5, 70, 100, 130, fmt)
    assert plan_q_stacked_call(aq, bq).mainloop == "wmma"
    assert plan_q_batched_call(aq, bq).mainloop == "wmma"
    p = plan_q_stacked_call(aq, bq)
    assert (p.splits, p.chunk) == (1, 5 * -(-100 // p.bk))
    # an N-major B, handed straight to the wrapper
    aq, bq = _laid_out(4, 96, 128, 80, fmt)
    n_major = bq.contiguous()
    assert plan_q_stacked_call(aq, n_major).mainloop == "wmma"
    assert plan_q_batched_call(aq, n_major).mainloop == "wmma"
    assert plan_q_batched_call(aq, n_major[0]).mainloop == "wmma"
    # a column-major activation
    a_col = aq.mT.contiguous().mT
    assert plan_q_stacked_call(a_col, bq).mainloop == "wmma"
    # entries that overlap, or lie apart by a stride TMA cannot step
    buf = torch.empty(96 * 128 + 48, dtype=aq.dtype)
    overlap = buf.as_strided((4, 96, 128), (16, 128, 1))
    assert plan_q_batched_call(overlap, bq).mainloop == "wmma"
    odd = torch.empty(4, 96 * 128 + 8, dtype=aq.dtype)[:, :96 * 128]
    assert plan_q_batched_call(odd.view(4, 96, 128), bq).mainloop == "wmma"
    assert plan_q_stacked_call(aq, bq).mainloop == "wgmma"
    assert plan_q_stacked(0, 64, 64, 64, True).mainloop == "wmma"
    assert plan_q_stacked(4, 64, 64, 0, True).mainloop == "wmma"


def _split_slices(p, nb, k):
    slices = nb * -(-k // p.bk)
    return [list(range(s * p.chunk, min((s + 1) * p.chunk, slices)))
            for s in range(p.splits)]


@pytest.mark.parametrize("fp8", [False, True], ids=["int8", "fp8"])
@pytest.mark.parametrize("nb,m,k,n", CASES + [(7, 16, 320, 24),
                                              (3, 8, 4096, 128)])
def test_stacked_splits_cover_every_slice_once(nb, m, k, n, fp8):
    p = plan_q_stacked(nb, m, n, k, True, fp8)
    runs = _split_slices(p, nb, k)
    flat = [j for run in runs for j in run]
    assert flat == list(range(nb * -(-k // BK)))
    assert all(runs)                       # no empty split
    if p.tiles == 1 and nb * -(-k // BK) * BK >= 2 * (
            MIN_SPLIT_K_FP8 if fp8 else MIN_SPLIT_K):
        assert p.splits > 1                # one tile: the reduction splits
    # no more blocks than the card holds at once (two an SM for fp8)
    assert p.splits == 1 or p.splits * p.tiles <= 132 * (2 if fp8 else 1)


# --------------------------------------------------------------------------
# the STACKED walk against brgemm_q_pallas
# --------------------------------------------------------------------------

def _exact(t: torch.Tensor):
    return (t.numpy().astype(np.int64) if t.dtype == torch.int8
            else t.double().numpy())


def stacked_q_model(aq, bq, sa, sb, p, bias=None, *, alpha=1.0):
    """What the wgmma kernel computes for brgemm_q under plan ``p``, in
    numpy: the reduction is the flattened (entry, slice) axis, slice j
    entry j // kslices and k (j % kslices) * 128 .. of it (the ragged tail
    zero-filled: cut at k); each slice's products summed exactly and
    rounded once (int32; fp32 for fp8), in slice order within a split;
    the splits' partials added in split order; then the dequant in fp32,
    each step rounded on its own."""
    a, b = _exact(aq), _exact(bq)
    integer = aq.dtype == torch.int8
    kind = np.int32 if integer else np.float32
    k = a.shape[2]
    kslices = -(-k // p.bk)
    acc = None
    for run in _split_slices(p, a.shape[0], k):
        part = np.zeros((a.shape[1], b.shape[2]), kind)
        for j in run:
            e, cut = j // kslices, slice((j % kslices) * p.bk,
                                         (j % kslices + 1) * p.bk)
            part = part + (a[e][:, cut] @ b[e][cut]).astype(kind)
        acc = part if acc is None else acc + part
    out = (acc.astype(np.float32) * (sa.numpy()[:, None] * sb.numpy()[None])
           ) * np.float32(alpha)
    return out if bias is None else out + bias


def _stacked_inputs(nb, m, k, n, fmt):
    a, b = _randn(nb, m, k, seed=1), _randn(nb, k, n, seed=2,
                                            scale=(nb * k) ** -0.5)
    ja, jsa = JQ.quantize(jnp.asarray(a), fmt, axis=(0, 2))
    jb, jsb = JQ.quantize(jnp.asarray(b), fmt, axis=(0, 1))
    aq, sa = quant.quantize(torch.from_numpy(a), fmt, axis=(0, 2))
    bq, sb = quant.quantize(torch.from_numpy(b), fmt, axis=(0, 1),
                            k_major=True)
    return (aq, bq, sa, sb), (ja, jb, jsa, jsb)


def _held(got, want, fmt, plain):
    if fmt == "int8" and plain:
        np.testing.assert_array_equal(got, want)
    else:
        band = 1e-6 if fmt == "int8" else 1e-5
        np.testing.assert_allclose(got, want, atol=band, rtol=band)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("epilogue", ["plain", "bias alpha"])
@pytest.mark.parametrize("nb,m,k,n", [(7, 16, 320, 24), (3, 8, 64, 40)],
                         ids=["split mid-entry", "ragged k 64"])
def test_stacked_walk_matches_pallas_interpret(nb, m, k, n, fmt, epilogue):
    (aq, bq, sa, sb), (ja, jb, jsa, jsb) = _stacked_inputs(nb, m, k, n, fmt)
    p = plan_q_stacked_call(aq, bq)
    assert p.mainloop == "wgmma"
    if (nb, k) == (7, 320):
        # 21 slices of 128, 3 an entry: the int8 runs of 11 end inside
        # entry 3; fp8 runs one slice each
        assert (p.splits, p.chunk) == ((2, 11) if fmt == "int8" else (21, 1))
    kw = {} if epilogue == "plain" else dict(alpha=0.75)
    bias = None if epilogue == "plain" else _randn(n, seed=3)
    got = stacked_q_model(aq, bq, sa, sb, p, bias, **kw)
    want = np.asarray(JQK.brgemm_q_pallas(
        ja, jb, jsa, jsb, None if bias is None else jnp.asarray(bias),
        interpret=True, **kw))
    _held(got, want, fmt, epilogue == "plain")
    # the plain version the card holds the kernel against agrees too
    ref = QR.brgemm_q_ref(aq, bq, sa, sb, None if bias is None
                          else torch.from_numpy(bias), **kw).numpy()
    _held(ref, want, fmt, epilogue == "plain")


# --------------------------------------------------------------------------
# the PER_ENTRY walk's per-entry dequant against batched_matmul_q_pallas
# --------------------------------------------------------------------------

def _entry_scales(s: torch.Tensor, nb: int) -> torch.Tensor:
    """A scale as DequantEntry reads it: (nb, L) through the wrapper's
    entry and element strides (QK._scales: entry stride 0 for a 1-D row
    shared by every entry)."""
    length = s.shape[-1]
    _, bstride, stride = QK._scales(s, "s", s, tuple(s.shape))
    return s.as_strided((nb, length), (bstride, stride))


def per_entry_q_model(aq, bq, sa, sb, nb, bias=None, *, alpha=1.0):
    """What the wgmma kernel computes for batched_matmul_q: entry z's
    product (a 2-D operand read by every entry) over its k in slices of
    128, summed as stacked_q_model sums one entry, then entry z's dequant
    with row scale (z, r) and column scale (z, c) read through their entry
    strides."""
    a = _exact(aq) if aq.dim() == 3 else np.broadcast_to(
        _exact(aq), (nb, *aq.shape))
    b = _exact(bq) if bq.dim() == 3 else np.broadcast_to(
        _exact(bq), (nb, *bq.shape))
    kind = np.int32 if aq.dtype == torch.int8 else np.float32
    k = a.shape[2]
    sr, sc = _entry_scales(sa, nb).numpy(), _entry_scales(sb, nb).numpy()
    out = []
    for z in range(nb):
        acc = np.zeros((a.shape[1], b.shape[2]), kind)
        for s in range(-(-k // BK)):
            cut = slice(s * BK, (s + 1) * BK)
            acc = acc + (a[z][:, cut] @ b[z][cut]).astype(kind)
        o = (acc.astype(np.float32) * (sr[z][:, None] * sc[z][None])
             ) * np.float32(alpha)
        out.append(o if bias is None else o + bias)
    return np.stack(out)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("bcast", ["none", "a", "b"])
@pytest.mark.parametrize("epilogue", ["plain", "bias alpha"])
def test_per_entry_dequant_matches_pallas_interpret(fmt, bcast, epilogue):
    nb, m, k, n = 3, 16, 320, 24
    a = _randn(m, k, seed=4) if bcast == "a" else _randn(nb, m, k, seed=4)
    b = (_randn(k, n, seed=5, scale=k ** -0.5) if bcast == "b"
         else _randn(nb, k, n, seed=5, scale=k ** -0.5))
    aq, sa = quant.quantize(torch.from_numpy(a), fmt, axis=(-1,))
    bq, sb = quant.quantize(torch.from_numpy(b), fmt, axis=(-2,),
                            k_major=True)
    assert plan_q_batched_call(aq, bq).mainloop == "wgmma"
    # a shared operand's scale row is 1-D: entry stride 0
    assert (sa.dim(), sb.dim()) == (1 if bcast == "a" else 2,
                                    1 if bcast == "b" else 2)
    kw = {} if epilogue == "plain" else dict(alpha=1.5)
    bias = None if epilogue == "plain" else _randn(n, seed=6)
    got = per_entry_q_model(aq, bq, sa, sb, nb, bias, **kw)
    ja, jsa = JQ.quantize(jnp.asarray(a), fmt, axis=(-1,))
    jb, jsb = JQ.quantize(jnp.asarray(b), fmt, axis=(-2,))
    want = np.asarray(JQK.batched_matmul_q_pallas(
        jnp.broadcast_to(ja, (nb, m, k)), jnp.broadcast_to(jb, (nb, k, n)),
        jnp.broadcast_to(jsa, (nb, m)), jnp.broadcast_to(jsb, (nb, n)),
        None if bias is None else jnp.asarray(bias), interpret=True, **kw))
    _held(got, want, fmt, epilogue == "plain")


# --------------------------------------------------------------------------
# the routing's K-major B
# --------------------------------------------------------------------------

def _bits(t):
    if isinstance(t, torch.Tensor):
        return (t.numpy() if t.dtype == torch.int8
                else t.view(torch.uint8).numpy())
    t = np.asarray(t)
    return t if t.dtype == np.int8 else t.view(np.uint8)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("op", ["brgemm", "batched", "batched A bcast",
                                "batched B bcast"])
def test_routing_hands_k_major_b_with_reference_bits(monkeypatch, fmt, op):
    """quant.brgemm_q / batched_matmul_q hand the kernel (here its plain
    version, which the CPU runs) a K-major B, strides (.., 1, k), whose
    bits are the JAX quantizer's; the operands then plan onto wgmma."""
    nb, m, k, n = 4, 32, 64, 48
    a = _randn(m, k, seed=7) if op == "batched A bcast" else \
        _randn(nb, m, k, seed=7)
    b = _randn(k, n, seed=8) if op == "batched B bcast" else \
        _randn(nb, k, n, seed=8)
    seen = {}

    def spy(aq, bq, sa, sb, *args, **kw):
        seen.update(aq=aq, bq=bq)
        return real(aq, bq, sa, sb, *args, **kw)

    qcfg = QuantConfig(w_dtype=fmt, a_dtype=fmt)
    name = "brgemm_q_ref" if op == "brgemm" else "batched_matmul_q_ref"
    real = getattr(QR, name)
    monkeypatch.setattr(QR, name, spy)
    fn = Q.brgemm_q if op == "brgemm" else Q.batched_matmul_q
    with torch.no_grad():
        fn(torch.from_numpy(a), torch.from_numpy(b), backend="torch",
           qcfg=qcfg)
    bq = seen["bq"]
    assert bq.shape == b.shape and bq.stride()[-2:] == (1, k)
    jcfg = JQ.QuantConfig(w_dtype=fmt, a_dtype=fmt)
    if op == "brgemm":
        want = JQ.quantize(jnp.asarray(b), fmt, axis=(0, 1))[0]
    elif op == "batched":           # stacked weights: quantize_weight
        want = JQ.quantize_weight(jnp.asarray(b), jcfg).q
    else:
        want = JQ.quantize(jnp.asarray(b), fmt, axis=(-2,))[0]
    np.testing.assert_array_equal(_bits(bq), _bits(want))
    plan = (plan_q_stacked_call if op == "brgemm"
            else plan_q_batched_call)(seen["aq"], bq)
    assert plan.mainloop == "wgmma"


def test_wrappers_count_by_mainloop():
    QK.reset_quant_counts()
    for fn in (QK.matmul_q_cuda, QK.brgemm_q_cuda, QK.batched_matmul_q_cuda):
        assert fn.launches == fn.split_launches == 0
        assert fn.mainloops == {"wgmma": 0, "wmma": 0}
    aq, bq = _laid_out(2, 8, 64, 16, "int8")
    with pytest.raises(ValueError, match="CUDA device"):
        QK.brgemm_q_cuda(aq, bq, torch.ones(8), torch.ones(16))
    with pytest.raises(ValueError, match="CUDA device"):
        QK.batched_matmul_q_cuda(aq, bq, torch.ones(2, 8), torch.ones(16))
    assert QK.brgemm_q_cuda.launches == QK.batched_matmul_q_cuda.launches == 0

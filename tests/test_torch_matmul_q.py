"""The quantized GEMM's plan, its split-K sum and the K-major calibrated
storage, on the CPU.

``plan_q`` (``kernels/brgemm/quant_kernel.py``) is plain Python: at every
``matmul_q`` shape of the quantized serving path (smollm-135m at
chip_smoke.py's sizes: prefill m = 8 x 512, decode m = 8, the LM head of
``decode_int8``) the operands as the path hands them over (activations
row-major, weights K-major) run the wgmma mainloop, whatever their
format and output dtype (fp8 on 64-row tiles, split down to single
slices); an N-major weight, a column-major activation or a
row stride TMA cannot step through runs the 64 x 64 wmma tiles.

A plain model of what the wgmma kernel computes under a plan (int32 sums
of s8 products; fp8's exact products summed in fp32, a 128-element slice
at a time, in slice order; each split's partial over its
run of slices, the partials added in split order, then the dequant
epilogue once, in fp32 with the reference's rounding) is held against the
reference's ``matmul_q_pallas`` in interpret mode, split and unsplit: s8
bit for bit with no bias and alpha 1 (the int32 sum is exact and the
epilogue's two products round alike), 1e-6 with alpha and bias
(test_torch_quant.py's int8 band); fp8 within 1e-5 (fp32 sums in other
orders; that file's fp8 band).  The kernel widens fp8 exactly to f16 and
sums its products in fp32 as the model does; tests/test_torch_gpu.py and
chip_smoke.py hold it on the card.

The calibrated storage is K-major (strides (1, k)) with the reference's
values bit for bit: ``quantize_weight``, ``calibrate_params`` and a
calibrated tree carried through ``interop``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quantize as JQ
from repro.kernels.brgemm import quant_kernel as JQK
from repro.models import api as japi
from repro_torch import configs, interop, quant
from repro_torch.core.quantize import QuantConfig, QuantizedTensor
from repro_torch.kernels.brgemm import quant as Q
from repro_torch.kernels.brgemm.quant_kernel import (BK, MAINLOOPS,
                                                     MIN_SPLIT_K,
                                                     MIN_SPLIT_K_FP8, plan_q,
                                                     plan_q_call)

STORAGE = ("int8", "float8_e4m3fn", "float8_e5m2")
CFG = configs.get("smollm-135m")
D, DQ, DKV, FF, V = (CFG.d_model, CFG.n_heads * CFG.dh,
                     CFG.n_kv_heads * CFG.dh, CFG.d_ff, CFG.vocab)
# (name, m, k, n) of matmul_q on the quantized serving path
SHAPES = [(f"{phase}.{name}", m, k, n)
          for phase, m in (("prefill", 8 * 512), ("decode", 8))
          for name, k, n in (("q", D, DQ), ("kv", D, DKV), ("o", DQ, D),
                             ("gate_up", D, FF), ("down", FF, D))]
SHAPES.append(("decode.lm_head", 8, D, V))


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _path_operands(m, k, n, fmt, head=False):
    """xq (m, k) and wq (k, n) as the quantized path hands them over:
    activations quantized per row, row-major; the weight through
    quantize_weight (K-major), or the head's table.T (K-major already)."""
    xq, sx = quant.quantize(torch.zeros(m, k), fmt, axis=(-1,))
    w = torch.zeros(n, k).T if head else torch.zeros(k, n)
    qt = quant.quantize_weight(w, QuantConfig(w_dtype=fmt, a_dtype=fmt))
    return xq, qt.q


@pytest.mark.parametrize("fmt", STORAGE)
@pytest.mark.parametrize("name,m,k,n", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_runs_the_paths_calls_on_wgmma(name, m, k, n, fmt):
    xq, wq = _path_operands(m, k, n, fmt, head=name.endswith("lm_head"))
    assert wq.stride() == (1, k)
    fp8 = fmt != "int8"
    p = plan_q_call(xq, wq)
    assert p == plan_q(m, n, k, True, fp8)
    assert p.mainloop == "wgmma" and p.bk == BK == 128
    assert p.bm == (64 if m <= 64 or fp8 else 128)   # fp8: widened, 64 rows
    assert p.tiles == -(-m // p.bm) * -(-n // 128)
    # no run shorter than MIN_SPLIT_K (fp8: one slice); the runs cover k,
    # the last not empty
    slices = -(-k // BK)
    assert p.splits * p.chunk >= slices > (p.splits - 1) * p.chunk
    assert p.splits == 1 or p.chunk * BK >= (MIN_SPLIT_K_FP8 if fp8
                                             else MIN_SPLIT_K)


@pytest.mark.parametrize("fmt", STORAGE)
def test_plan_mainloop_follows_layout_not_format(fmt):
    xq, wq = _path_operands(96, 256, 200, fmt)
    assert plan_q_call(xq, wq).mainloop == "wgmma"
    n_major = wq.contiguous()                     # (k, n) row-major
    assert plan_q_call(xq, n_major).mainloop == "wmma"
    x_col = xq.T.contiguous().T                   # column-major activation
    assert plan_q_call(x_col, wq).mainloop == "wmma"
    xr, wr = _path_operands(77, 100, 133, fmt)    # rows 100 apart
    assert plan_q_call(xr, wr).mainloop == "wmma"
    # a base 1 byte off 16
    buf = torch.zeros(96 * 256 + 1, dtype=xq.dtype)
    assert plan_q_call(buf[1:].view(96, 256), wq).mainloop == "wmma"
    assert set(MAINLOOPS) == {"wgmma", "wmma"}


def test_plan_splits_long_reductions_over_few_tiles():
    # one output tile, k = 4096: 32 slices in runs of MIN_SPLIT_K
    p = plan_q(8, 128, 4096, True)
    assert (p.tiles, p.splits, p.chunk) == (1, 4096 // MIN_SPLIT_K,
                                            MIN_SPLIT_K // BK)
    # many tiles: no split
    assert plan_q(4096, 1536, 4096, True).splits == 1
    # the wmma tiles walk k whole
    assert plan_q(8, 128, 4096, False).splits == 1
    # fp8 splits down to single slices, two blocks an SM
    p = plan_q(8, 128, 4096, True, True)
    assert (p.bm, p.splits, p.chunk) == (64, 4096 // BK, 1)
    assert plan_q(8, 576, 576, True, True).splits == 576 // BK + 1


def splitk_q_model(xq, wq, sx, sw, p, bias=None, *, alpha=1.0):
    """What the wgmma kernel computes under plan ``p``, in numpy: split s
    sums slices s * p.chunk .. of p.bk elements of k, each slice's
    products summed exactly and rounded once (int32 for s8; fp32 for fp8,
    as the kernel adds each slice sum into fp32 registers), in slice
    order; the splits' partials added in split order; then the dequant in
    fp32, each step rounded on its own: acc * (sx * sw), * alpha, + bias."""
    integer = xq.dtype == torch.int8
    x = xq.numpy().astype(np.int64) if integer else xq.double().numpy()
    w = wq.numpy().astype(np.int64) if integer else wq.double().numpy()
    kind = np.int32 if integer else np.float32
    slices = -(-x.shape[1] // p.bk)
    acc = None
    for s in range(p.splits):
        part = np.zeros((x.shape[0], w.shape[1]), kind)
        for j in range(s * p.chunk, min((s + 1) * p.chunk, slices)):
            cut = slice(j * p.bk, (j + 1) * p.bk)
            part = part + (x[:, cut] @ w[cut]).astype(kind)
        acc = part if acc is None else acc + part
    acc = acc.astype(np.float32)
    scale = sx.numpy()[:, None] * sw.numpy()[None, :]
    out = (acc * scale) * np.float32(alpha)
    if bias is not None:
        out = out + bias
    return out


def _model_against_pallas(fmt, epilogue, m, k, n, p):
    x, w = _randn(m, k, seed=1), _randn(k, n, seed=2, scale=k ** -0.5)
    jx, jsx = JQ.quantize(jnp.asarray(x), fmt, axis=(-1,))
    jw, jsw = JQ.quantize(jnp.asarray(w), fmt, axis=(-2,))
    xq, sx = quant.quantize(torch.from_numpy(x), fmt, axis=(-1,))
    wq, sw = quant.quantize(torch.from_numpy(w), fmt, axis=(-2,),
                            k_major=True)
    kw = {} if epilogue == "plain" else dict(alpha=0.75)
    bias = None if epilogue == "plain" else _randn(n, seed=3)
    got = splitk_q_model(xq, wq, sx, sw, p, bias, **kw)
    want = np.asarray(JQK.matmul_q_pallas(
        jx, jw, jsx, jsw, None if bias is None else jnp.asarray(bias),
        interpret=True, **kw))
    if fmt == "int8" and epilogue == "plain":
        np.testing.assert_array_equal(got, want)
    else:
        band = 1e-6 if fmt == "int8" else 1e-5
        np.testing.assert_allclose(got, want, atol=band, rtol=band)


@pytest.mark.parametrize("fmt", STORAGE)
@pytest.mark.parametrize("epilogue", ["plain", "bias alpha"])
def test_split_sum_matches_pallas_interpret(fmt, epilogue):
    m, k, n = 8, 4096, 128
    p = plan_q(m, n, k, True, fmt != "int8")
    assert p.splits > 1
    _model_against_pallas(fmt, epilogue, m, k, n, p)


@pytest.mark.parametrize("fmt", STORAGE)
def test_slice_sums_match_pallas_interpret(fmt):
    """k = 576, the path's d_model: five 128-element slices (the last
    ragged), in one split (int8) or one split a slice (fp8)."""
    m, k, n = 72, 576, 128
    p = plan_q(m, n, k, True, fmt != "int8")
    assert (p.mainloop, p.splits, p.chunk) == (
        ("wgmma", 1, 5) if fmt == "int8" else ("wgmma", 5, 1))
    _model_against_pallas(fmt, "plain", m, k, n, p)


# --------------------------------------------------------------------------
# the K-major calibrated storage
# --------------------------------------------------------------------------

def _bits(a):
    if isinstance(a, torch.Tensor):
        return (a.numpy() if a.dtype == torch.int8
                else a.view(torch.uint8).numpy())
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.view(np.uint8)


@pytest.mark.parametrize("fmt", STORAGE)
@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor"])
@pytest.mark.parametrize("shape", [(40, 24), (3, 40, 24)],
                         ids=["2d", "stacked"])
def test_quantize_weight_is_k_major_with_reference_bits(fmt, granularity,
                                                        shape):
    w = _randn(*shape, seed=4)
    spec = dict(w_dtype=fmt, a_dtype=fmt, granularity=granularity)
    want = JQ.quantize_weight(jnp.asarray(w), JQ.QuantConfig(**spec))
    got = quant.quantize_weight(torch.from_numpy(w), QuantConfig(**spec))
    k, n = shape[-2:]
    assert got.q.stride()[-2:] == (1, k) and got.q.shape == shape
    np.testing.assert_array_equal(_bits(got.q), _bits(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_dynamic_weight_quantization_is_k_major():
    """decode_int8 quantizes each weight at every step through
    quantize_weight: its storage is K-major too, and the head's table.T,
    K-major already, stays so."""
    qcfg = QuantConfig()
    w = torch.from_numpy(_randn(64, 48, seed=5))
    wq, sw = Q._weight_qparams(w, qcfg)
    assert wq.stride() == (1, 64) and sw.shape == (48,)
    table = torch.from_numpy(_randn(100, 64, seed=6))
    wq, _ = Q._weight_qparams(table.T, qcfg)
    assert wq.stride() == (1, 64)
    np.testing.assert_array_equal(
        wq.numpy(), quant.quantize(table.T, "int8", axis=(-2,))[0].numpy())


@pytest.mark.parametrize("spec", ["int8", "fp8"])
def test_calibrated_and_carried_storage_is_k_major(spec):
    jcfg = jconfigs.get("smollm-135m").reduced()
    tcfg = configs.get("smollm-135m").reduced()
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    model = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    jcal = JQ.calibrate_params(jparams, spec)
    carried = interop.params_from_numpy(jax.tree.map(np.asarray, jcal),
                                        tcfg, device="cpu")
    own = quant.calibrate_params(model, spec)
    for cal in (own, carried):
        leaves = [(name, mod) for name, mod in cal.named_modules()
                  if isinstance(mod, QuantizedTensor)]
        assert len(leaves) == 7 * tcfg.n_layers
        for name, qt in leaves:
            assert qt.q.stride() == (1, qt.q.shape[0]), name
    np.testing.assert_array_equal(_bits(own.blocks[0].mlp.w_down.q),
                                  _bits(carried.blocks[0].mlp.w_down.q))

"""The port's quantized building block against the JAX package's.

Inputs are made with numpy from fixed seeds and handed to both packages.

* ``quantize`` must give the reference's bits (``q`` and ``scale``): int8,
  e4m3 and e5m2; per channel, per tensor and per row; an all-zero channel.
* The plain quantized GEMMs (``quant_ref.py``) against the reference's
  Pallas kernels in interpret mode and its XLA references, on the same
  quantized operands.  Bands: int8 with fp32 out and no activation, atol =
  rtol = 1e-6 (both take the exact integer sum and the same fp32
  epilogue; observed 0); int8 with an activation 1e-5 (the frameworks'
  tanh / exp differ by an ulp); fp8, 1e-5 (fp32 sums in other orders).
* Calibration carried through ``interop`` keeps the reference's bits, and
  the port's own ``calibrate_params`` gives them too.
* The reduced smollm ``Engine`` under ``decode_quant="int8"`` and on
  calibrated int8 weights gives the reference's greedy tokens, fp32.
* Routing: the ambient c0/beta degrade, the explicit-quant raise, the
  mixed int8/fp8 raise, the autograd raise, ``backend="cuda"`` on CPU
  tensors.
* The attention fault repaired in the same slice: ``mha_ref`` on a row with
  no valid key gives the reference's mean of V.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import dispatch as jdispatch
from repro.core import quantize as JQ
from repro.kernels.brgemm import matmul as jmatmul
from repro.kernels.brgemm import quant as JQR
from repro.kernels.brgemm import quant_kernel as JQK
from repro.kernels.flash_attention import ref as jflash_ref
from repro.models import api as japi
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch import interop, quant
from repro_torch.core import dispatch
from repro_torch.core.quantize import TORCH_DTYPES
from repro_torch.kernels.brgemm import (batched_matmul, batched_matmul_q_cuda,
                                        batched_matmul_q_ref, brgemm,
                                        brgemm_q_cuda, brgemm_q_ref, matmul,
                                        matmul_q_cuda, matmul_q_ref)
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.serve import Engine, ServeConfig

STORAGE = ("int8", "float8_e4m3fn", "float8_e5m2")
MAX_LEN = 32


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _bits(a):
    """A quantized array's storage bits as a numpy array (torch or jax)."""
    if isinstance(a, torch.Tensor):
        return (a.numpy() if a.dtype == torch.int8
                else a.view(torch.uint8).numpy())
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.view(np.uint8)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --------------------------------------------------------------------------
# quantize
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", STORAGE)
@pytest.mark.parametrize("axis", [(-2,), None, (-1,)],
                         ids=["per_channel", "per_tensor", "per_row"])
def test_quantize_matches_reference_bits(dtype, axis):
    w = _randn(40, 24, seed=1)
    jq, js = JQ.quantize(jnp.asarray(w), dtype, axis=axis)
    tq, ts = quant.quantize(torch.from_numpy(w), dtype, axis=axis)
    assert tq.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", STORAGE)
def test_quantize_zero_channel_matches_reference(dtype):
    w = _randn(16, 4, seed=3)
    w[:, 2] = 0.0
    jq, js = JQ.quantize(jnp.asarray(w), dtype, axis=(-2,))
    tq, ts = quant.quantize(torch.from_numpy(w), dtype, axis=(-2,))
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = quant.dequantize(tq, ts).numpy()
    assert np.isfinite(deq).all() and (deq[:, 2] == 0.0).all()


def test_quantize_keeps_a_column_major_layout():
    table = torch.from_numpy(_randn(50, 8, seed=4))
    q, scale = quant.quantize(table.T, "int8", axis=(-2,))
    assert q.stride() == (1, 8) and scale.shape == (50,)


def test_quant_config_and_specs_match_reference():
    for spec in ("int8", "fp8", "float8_e5m2",
                 "int8:int8:per_tensor:per_tensor:absmax"):
        j, t = JQ.as_quant_config(spec), quant.as_quant_config(spec)
        assert j.tag() == t.tag() and j.integer == t.integer
        assert quant.as_quant_config(t.tag()) == t
    with pytest.raises(ValueError, match="w_dtype"):
        quant.QuantConfig(w_dtype="int4")
    with pytest.raises(ValueError, match="storage dtype"):
        quant.quantize(torch.ones(4, 4), "int4")
    with pytest.raises(ValueError, match=">= 2-D"):
        quant.quantize_weight(torch.ones(8), "int8")


def test_resolve_quant_precedence_and_nesting():
    assert dispatch.resolve_quant() is None
    with dispatch.use(quant="int8"):
        assert dispatch.resolve_quant() == quant.QuantConfig()
        assert dispatch.resolve_quant("fp8").w_dtype == "float8_e4m3fn"
        with dispatch.use(quant="fp8"):
            assert dispatch.resolve_quant().w_dtype == "float8_e4m3fn"
        with dispatch.use(backend="torch"):      # quant inherited
            assert dispatch.resolve_quant() == quant.QuantConfig()
        assert dispatch.resolve_quant() == quant.QuantConfig()
    assert dispatch.resolve_quant() is None
    with pytest.raises(ValueError), dispatch.use(quant="int4"):
        pass


# --------------------------------------------------------------------------
# the plain quantized GEMMs against the reference's kernels and refs
# --------------------------------------------------------------------------

def _operands(dtype, a_shape, b_shape, a_axis, b_axis, seed):
    a, b = _randn(*a_shape, seed=seed), _randn(*b_shape, seed=seed + 1)
    ja = JQ.quantize(jnp.asarray(a), dtype, axis=a_axis)
    jb = JQ.quantize(jnp.asarray(b), dtype, axis=b_axis)
    ta = quant.quantize(torch.from_numpy(a), dtype, axis=a_axis)
    tb = quant.quantize(torch.from_numpy(b), dtype, axis=b_axis)
    return ja, jb, ta, tb


def _band(dtype, activation):
    if dtype == "int8" and activation == "none":
        return dict(atol=1e-6, rtol=1e-6)
    return dict(atol=1e-5, rtol=1e-5)


EPILOGUES = [("none", 1.0, False), ("gelu", 1.5, True), ("silu", 0.5, True)]


@pytest.mark.parametrize("dtype", STORAGE)
@pytest.mark.parametrize("activation,alpha,with_bias", EPILOGUES,
                         ids=[e[0] for e in EPILOGUES])
def test_matmul_q_ref_matches_reference(dtype, activation, alpha, with_bias):
    (jx, jsx), (jw, jsw), (tx, tsx), (tw, tsw) = _operands(
        dtype, (24, 48), (48, 40), (-1,), (-2,), seed=10)
    bias = _randn(40, seed=12) if with_bias else None
    kw = dict(activation=activation, alpha=alpha)
    jbias = jnp.asarray(bias) if with_bias else None
    qcfg = JQ.as_quant_config(dtype)
    want_xla = JQR.matmul_q_ref(jx, jw, jsx, jsw, jbias, qcfg=qcfg,
                                out_dtype=jnp.float32, **kw)
    got = matmul_q_ref(tx, tw, tsx, tsw, _t(bias) if with_bias else None,
                       **kw)
    band = _band(dtype, activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), **band)
    # the reference's Pallas kernel, interpreted
    want_pallas = JQK.matmul_q_pallas(jx, jw, jsx, jsw, jbias,
                                      interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **band)


@pytest.mark.parametrize("dtype", STORAGE)
def test_brgemm_q_ref_matches_reference(dtype):
    # batch-shared scales: activations over (B, k), weights over (B, k)
    (ja, jsa), (jb, jsb), (ta, tsa), (tb, tsb) = _operands(
        dtype, (3, 16, 32), (3, 32, 24), (0, 2), (0, 1), seed=20)
    qcfg = JQ.as_quant_config(dtype)
    want = JQR.brgemm_q_ref(ja, jb, jsa, jsb, qcfg=qcfg)
    got = brgemm_q_ref(ta, tb, tsa, tsb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_band(dtype, "none"))
    want = JQK.brgemm_q_pallas(ja, jb, jsa, jsb, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_band(dtype, "none"))


@pytest.mark.parametrize("dtype", STORAGE)
@pytest.mark.parametrize("a_shape", [(3, 16, 32), (16, 32)],
                         ids=["3d", "a_broadcast"])
def test_batched_matmul_q_ref_matches_reference(dtype, a_shape):
    (ja, jsa), (jb, jsb), (ta, tsa), (tb, tsb) = _operands(
        dtype, a_shape, (3, 32, 8), (-1,), (-2,), seed=30)
    qcfg = JQ.as_quant_config(dtype)
    want = JQR.batched_matmul_q_ref(ja, jb, jsa, jsb, qcfg=qcfg)
    got = batched_matmul_q_ref(ta, tb, tsa, tsb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_band(dtype, "none"))
    if len(a_shape) == 3:    # the Pallas kernel takes 3-D operands only
        want = JQK.batched_matmul_q_pallas(ja, jb, jsa, jsb, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **_band(dtype, "none"))


# --------------------------------------------------------------------------
# the public entry points against the reference's
# --------------------------------------------------------------------------

QUANTS = ["int8", "fp8", "float8_e5m2",
          "int8:int8:per_tensor:per_tensor:absmax"]


@pytest.mark.parametrize("spec", QUANTS)
def test_entry_points_match_reference(spec):
    from repro.kernels.brgemm import batched_matmul as jbatched
    from repro.kernels.brgemm import brgemm as jbrgemm
    x, w, bias = _randn(2, 12, 48, seed=40), _randn(48, 24, seed=41), \
        _randn(24, seed=42)
    a, b = _randn(3, 16, 32, seed=43), _randn(3, 32, 24, seed=44)
    band = dict(atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        got = matmul(_t(x), _t(w), _t(bias), activation="gelu", quant=spec)
        want = jmatmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                       activation="gelu", quant=spec, backend="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **band)
        assert got.shape == (2, 12, 24)
        got = brgemm(_t(a), _t(b), quant=spec)
        want = jbrgemm(jnp.asarray(a), jnp.asarray(b), quant=spec,
                       backend="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **band)
        # two 3-D operands: the reference's kernel path's scales
        b3 = b[:, :, :8]
        jdispatch.clear_tuning_cache()
        got = batched_matmul(_t(a), _t(b3), quant=spec)
        want = jbatched(jnp.asarray(a), jnp.asarray(b3), quant=spec,
                        backend=("pallas" if "int8" in spec else "xla"))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **band)
        # a 2-D broadcast operand: its _batched_ref_from_raw scales
        got = batched_matmul(_t(a[0]), _t(b3), quant=spec)
        want = jbatched(jnp.asarray(a[0]), jnp.asarray(b3), quant=spec,
                        backend="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **band)


def test_calibrated_weight_matches_dynamic_quant_exactly():
    x, w = _t(_randn(8, 32, seed=34)), _t(_randn(32, 16, seed=35))
    with torch.no_grad():
        dyn = matmul(x, w, quant="int8")
        cal = matmul(x, quant.quantize_weight(w, "int8"))   # no context
    torch.testing.assert_close(dyn, cal, atol=0, rtol=0)


def test_quantized_tensor_is_a_module():
    qt = quant.quantize_weight(_t(_randn(16, 8, seed=5)), "fp8")
    assert qt.shape == (16, 8) and qt.ndim == 2
    assert qt.dtype == torch.float8_e4m3fn
    state = qt.state_dict()
    assert set(state) == {"q", "scale"} and state["scale"].shape == (8,)
    assert qt.to("cpu").q.dtype == torch.float8_e4m3fn


# --------------------------------------------------------------------------
# routing rules
# --------------------------------------------------------------------------

def test_ambient_quant_degrades_accumulator_chains_explicit_raises():
    x, w, c0 = _t(_randn(8, 16, seed=24)), _t(_randn(16, 8, seed=25)), \
        _t(_randn(8, 8, seed=26))
    want = matmul(x, w, None, c0, beta=1.0)
    with torch.no_grad(), dispatch.use(quant="int8"):
        got = matmul(x, w, None, c0, beta=1.0)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        # a calibrated weight in a chain runs dequantized
        qt = quant.quantize_weight(w, "int8")
        got = matmul(x, qt, None, c0, beta=1.0)
        torch.testing.assert_close(got, matmul(x, qt.dequantize(), None, c0,
                                               beta=1.0), atol=0, rtol=0)
    with torch.no_grad(), pytest.raises(NotImplementedError):
        matmul(x, w, None, c0, beta=1.0, quant="int8")
    a, b = _t(_randn(2, 8, 16, seed=27)), _t(_randn(2, 16, 8, seed=28))
    with torch.no_grad(), pytest.raises(NotImplementedError):
        brgemm(a, b, None, c0, beta=1.0, quant="int8")


def test_mixed_int8_fp8_families_unsupported():
    x, w = _t(_randn(8, 16, seed=22)), _t(_randn(16, 8, seed=23))
    mixed = quant.QuantConfig(w_dtype="int8", a_dtype="float8_e4m3fn")
    with torch.no_grad(), pytest.raises(NotImplementedError):
        matmul(x, w, quant=mixed)


def test_quantized_call_with_autograd_raises():
    x = _t(_randn(4, 16, seed=6)).requires_grad_()
    w = _t(_randn(16, 8, seed=7))
    with pytest.raises(NotImplementedError, match="inference-only"):
        matmul(x, w, quant="int8")
    with pytest.raises(NotImplementedError, match="inference-only"):
        batched_matmul(x[None], w[None], quant="int8")


def test_stacked_brgemm_weight_needs_batch_shared_scales():
    b = quant.quantize_weight(_t(_randn(2, 16, 8, seed=8)), "int8")
    with torch.no_grad(), pytest.raises(ValueError, match="batch-shared"):
        brgemm(_t(_randn(2, 4, 16, seed=9)), b)


def test_cuda_backend_on_cpu_tensors_raises():
    x, w = _t(_randn(4, 16, seed=1)), _t(_randn(16, 8, seed=2))
    a, b = _t(_randn(2, 4, 16, seed=3)), _t(_randn(2, 16, 8, seed=4))
    with torch.no_grad():
        for call in (lambda: matmul(x, w, quant="int8", backend="cuda"),
                     lambda: brgemm(a, b, quant="fp8", backend="cuda"),
                     lambda: batched_matmul(a, b, quant="int8",
                                            backend="cuda")):
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                call()
        with dispatch.use(backend="cuda", quant="int8"), \
                pytest.raises(ValueError):
            matmul(x, w)
    # The wrappers refuse CPU tensors before building anything.
    xq, sx = quant.quantize(x, "int8", axis=(-1,))
    wq, sw = quant.quantize(w, "int8", axis=(-2,))
    counters = (matmul_q_cuda, brgemm_q_cuda, batched_matmul_q_cuda)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError):
        matmul_q_cuda(xq, wq, sx, sw)
    with pytest.raises(ValueError):
        brgemm_q_cuda(xq[None], wq[None], sx, sw)
    with pytest.raises(ValueError):
        batched_matmul_q_cuda(xq[None], wq[None], sx[None], sw[None])
    assert [c.launches for c in counters] == before


# --------------------------------------------------------------------------
# calibration and serving, end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    jcfg = jconfigs.get("smollm-135m").reduced()
    tcfg = tconfigs.get("smollm-135m").reduced()
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = interop.params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, jparams, model


def _quantized(model):
    return {n: m for n, m in model.named_modules()
            if isinstance(m, quant.QuantizedTensor)}


@pytest.mark.parametrize("spec", ["int8", "fp8"])
def test_calibration_matches_reference_bits(dense, spec):
    jcfg, tcfg, jparams, model = dense
    jcal = JQ.calibrate_params(jparams, spec)
    carried = interop.params_from_numpy(
        jax.tree.map(np.asarray, jcal), tcfg, device="cpu")
    own = quant.calibrate_params(model, spec)
    assert not _quantized(model)                  # a copy, model untouched
    for cal in (carried, own):
        q = _quantized(cal)
        # 7 GEMM weights a layer; the tied table and the norms stay
        assert len(q) == 7 * tcfg.n_layers
        assert cal.embed.table.dtype == torch.float32
        for i in range(tcfg.n_layers):
            for path, attr in (("attn", "wq"), ("attn", "wo"),
                               ("mlp", "w_gate"), ("mlp", "w_down")):
                ref = jcal["blocks"][path][attr]
                qt = q[f"blocks.{i}.{path}.{attr}"]
                np.testing.assert_array_equal(_bits(qt.q),
                                              _bits(np.asarray(ref.q)[i]))
                np.testing.assert_array_equal(qt.scale.numpy(),
                                              np.asarray(ref.scale)[i])
    assert quant.calibrate_params(own, spec).blocks[0].attn.wq.q.equal(
        own.blocks[0].attn.wq.q)                  # idempotent


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("tier", ["decode_int8", "calibrated_int8",
                                  "calibrated_fp8"])
def test_engine_greedy_matches_reference(dense, tier):
    jcfg, tcfg, jparams, model = dense
    toks = _tokens(tcfg, 2, 9, seed=5)
    if tier == "decode_int8":
        jeng = JEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN),
                       decode_quant="int8")
        teng = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN),
                      device="cpu", decode_quant="int8")
    else:
        spec = tier.split("_")[1]
        jeng = JEngine(jcfg, JQ.calibrate_params(jparams, spec),
                       JServeConfig(max_len=MAX_LEN))
        teng = Engine(tcfg, quant.calibrate_params(model, spec),
                      ServeConfig(max_len=MAX_LEN), device="cpu")
    want = jeng.generate({"tokens": jnp.asarray(toks)}, n_tokens=8,
                         stop_tokens=())
    got = teng.generate({"tokens": torch.from_numpy(toks)}, n_tokens=8,
                        stop_tokens=())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_quant_tiers(dense):
    _, tcfg, _, model = dense
    toks = {"tokens": torch.from_numpy(_tokens(tcfg, 2, 6, seed=6))}
    scfg = ServeConfig(max_len=MAX_LEN)
    full = Engine(tcfg, model, scfg, device="cpu")
    tier = Engine(tcfg, model, scfg, device="cpu", quant="int8")
    assert tier.decode_quant == quant.QuantConfig()   # defaults to quant
    mixed = Engine(tcfg, model, scfg, device="cpu", decode_quant="fp8")
    assert mixed.quant is None
    for eng in (full, tier, mixed):
        out = eng.generate(toks, n_tokens=4, stop_tokens=())
        assert out.shape == (2, 4)
    with pytest.raises(ValueError):
        Engine(tcfg, model, scfg, device="cpu", quant="int4")


# --------------------------------------------------------------------------
# the attention fault repaired in this slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_ref_row_with_no_valid_key_matches_reference(dtype):
    # non-causal, windowed, Tq > Tk: q rows at q_pos >= Tk + window - 1 see
    # no key; the reference's mha_ref gives them the mean of V.
    q, k, v = (_randn(1, 2, 12, 32, seed=50), _randn(1, 1, 6, 32, seed=51),
               _randn(1, 1, 6, 32, seed=52))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jflash_ref.mha_ref(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              causal=False, window=3)
    got, lse = mha_ref(*(_t(a).to(dtype) for a in (q, k, v)), causal=False,
                       window=3, return_lse=True)
    want = np.asarray(want.astype(jnp.float32))
    empty = np.arange(12) >= 6 + 3 - 1
    assert empty.any() and (~empty).any()
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2 if
                               dtype == torch.bfloat16 else 1e-5, rtol=1e-5)
    mean = np.broadcast_to(v.mean(axis=2)[0, 0], (2, empty.sum(), 32))
    np.testing.assert_allclose(got.float().numpy()[0][:, empty], mean,
                               atol=1e-2 if dtype == torch.bfloat16 else 1e-6)
    assert (lse[0][:, empty] == -1e30).all()

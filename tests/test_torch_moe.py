"""The port's Mixture-of-Experts layer and grok-1-314b against the JAX
package, on the CPU.

Weights made by the reference from a fixed key and handed over as numpy
arrays (``interop``); the port on its ``torch`` backend, the reference under
``repro.use(backend="xla")`` (its expert GEMMs then the one einsum over
groups, the same contraction as its Pallas path's ``vmap``).  Routing is
held exactly: the chosen expert ids first (a tie order could differ), then
which choices fit their expert's capacity; gates, outputs and the aux
losses within atol = rtol = 1e-4 (fp32 both sides, two frameworks' sum
orders), the band of ``test_torch_dense_variants.py``.  Greedy tokens must
match exactly.  Prefill + decode against the train forward under dropless
capacity (factor = n_experts), as ``tests/test_arch_smoke.py`` does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import configs as jconfigs
from repro.layers import moe as jmoe
from repro.models import api as japi
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro.serve import PoolConfig as JPoolConfig
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch import interop, quant
from repro_torch.core import brgemm
from repro_torch.layers import moe
from repro_torch.models import api as tapi
from repro_torch.serve import (ContinuousEngine, Engine, PoolConfig, Request,
                               ServeConfig)

BAND = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 48
# The continuous runs: prompts long enough that capacity binds at prefill
# (reduced grok: 4 experts, top-2, capacity int(0.625 n) rounded up to 4s,
# at least 8), and more requests than slots, so slots free and refill.
PROMPT_LENS = [30, 5, 24, 1, 17, 11]
MAX_TOKENS = [6, 9, 4, 7, 5, 8]
POOLS = {
    "slotted": {},
    "paged": {"page_size": 8},
    "chunked": {"page_size": 4, "prefill_chunk": 8},
    "int8": {"page_size": 8, "kv_quant": "int8"},
}

# (name, MoECfg overrides, (B, T)): prefill groups without and with drops,
# decode's one global group, the shared expert.
CASES = [
    ("no_drops", dict(capacity_factor=4.0), (2, 12)),
    ("forced_drops", dict(capacity_factor=0.5), (2, 12)),
    ("decode_global_group", dict(capacity_factor=0.5), (6, 1)),
    ("shared_expert", dict(n_shared=1), (3, 10)),
]


def _moe_pair(overrides, seed=0):
    cfg = jmoe.MoECfg(d_model=32, d_ff=24, n_experts=4, top_k=2,
                      **overrides)
    jp = jmoe.init(jax.random.PRNGKey(seed), cfg)
    tcfg = moe.MoECfg(**dataclasses.asdict(cfg))
    layer = moe.MoE(tcfg)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            node = jp
            for key in name.split("."):
                node = node[key]
            p.copy_(torch.tensor(np.asarray(node)))
    return cfg, jp, tcfg, layer


def _x(shape, seed=1, d=32):
    return np.random.default_rng(seed).standard_normal(
        (*shape, d)).astype(np.float32)


def test_capacity_matches_reference():
    cfg = jmoe.MoECfg(d_model=8, d_ff=8, n_experts=8, top_k=2)
    tcfg = moe.MoECfg(d_model=8, d_ff=8, n_experts=8, top_k=2)
    for n in (1, 2, 3, 7, 16, 33, 512, 4096):
        assert moe.capacity(tcfg, n) == jmoe.capacity(cfg, n)
    ds = moe.MoECfg(d_model=8, d_ff=8, n_experts=256, top_k=8)
    assert moe.capacity(ds, 512) == 20 and moe.capacity(ds, 1) == 4


@pytest.mark.parametrize("name,overrides,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_routing_matches_reference(name, overrides, shape):
    """Ids first, then keep and slots exactly; logits, probs and gates in
    the band."""
    cfg, jp, tcfg, layer = _moe_pair(overrides)
    b, t = shape
    x = _x(shape)
    g, n = moe.groups(tcfg, b, t)
    assert (g, n) == ((b, t) if t > 1 else (1, b))
    cap = moe.capacity(tcfg, n)
    want = jmoe._route(jp, jnp.asarray(x).reshape(g, n, -1), cfg, cap,
                       "xla")
    with torch.no_grad():
        got = moe.route(layer.router, torch.from_numpy(x).reshape(g, n, -1),
                        tcfg, cap)
    logits, probs, gates, ids, keep, pos = got
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want[5]))
    for a, w in zip((logits, probs, gates), want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **BAND)
    dropped = 1.0 - keep.float().mean().item()
    assert (dropped > 0) == (name == "forced_drops")


@pytest.mark.parametrize("name,overrides,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_moe_apply_matches_reference(name, overrides, shape):
    cfg, jp, tcfg, layer = _moe_pair(overrides)
    x = _x(shape)
    with repro.use(backend="xla"):
        want, waux = jmoe.apply(jp, jnp.asarray(x), cfg)
    with torch.no_grad():
        got, aux = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    assert sorted(aux) == sorted(waux)
    for key in aux:
        np.testing.assert_allclose(float(aux[key]), float(waux[key]), **BAND)


def test_decode_row_groups_route_each_row_alone():
    """row_groups: each row its own group of one token (the reference's
    vmap of a batch-1 decode): no drops, each row's output its own decode
    at batch 1."""
    cfg, jp, tcfg, layer = _moe_pair(dict(capacity_factor=0.5))
    x = _x((5, 1))
    with torch.no_grad():
        both, aux = layer(torch.from_numpy(x), row_groups=True)
        assert float(aux["dropped_fraction"]) == 0.0
        for r in range(5):
            one, _ = layer(torch.from_numpy(x[r:r + 1]))
            np.testing.assert_allclose(both[r:r + 1].numpy(), one.numpy(),
                                       **BAND)
            with repro.use(backend="xla"):
                want, _ = jmoe.apply(jp, jnp.asarray(x[r:r + 1]), cfg)
            np.testing.assert_allclose(one.numpy(), np.asarray(want), **BAND)


def test_expert_gemms_fold_groups_into_rows(monkeypatch):
    """Three batched_matmul calls a forward, (E, G * cap, D) operands, silu
    fused into the gate's; the router one matmul to fp32; the shared
    expert three matmul."""
    _, _, tcfg, layer = _moe_pair(dict(n_shared=1))
    calls = []
    real_b, real_m = brgemm.batched_matmul, brgemm.matmul

    def spy_b(a, b, *args, **kw):
        calls.append(("batched", tuple(a.shape), tuple(b.shape),
                      kw.get("activation", "none")))
        return real_b(a, b, *args, **kw)

    def spy_m(x, w, *args, **kw):
        calls.append(("matmul", tuple(w.shape),
                      kw.get("out_dtype") == torch.float32))
        return real_m(x, w, *args, **kw)

    monkeypatch.setattr(brgemm, "batched_matmul", spy_b)
    monkeypatch.setattr(brgemm, "matmul", spy_m)
    b, t = 3, 10
    cap = moe.capacity(tcfg, t)
    with torch.no_grad():
        layer(torch.from_numpy(_x((b, t))))
    e, d, f = 4, 32, 24
    assert calls == [
        ("matmul", (d, e), True),
        ("batched", (e, b * cap, d), (e, d, f), "silu"),
        ("batched", (e, b * cap, d), (e, d, f), "none"),
        ("batched", (e, b * cap, f), (e, f, d), "none"),
        ("matmul", (d, f), False), ("matmul", (d, f), False),
        ("matmul", (f, d), False)]


# ==========================================================================
# grok-1-314b, reduced
# ==========================================================================

def _pair(name, **overrides):
    jcfg = dataclasses.replace(jconfigs.get(name).reduced(), **overrides)
    tcfg = dataclasses.replace(tconfigs.get(name).reduced(), **overrides)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree, interop.params_from_numpy(
        tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def grok():
    return _pair("grok-1-314b")


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t)).astype(np.int32)


def test_grok_config_is_the_references():
    jcfg, tcfg = jconfigs.get("grok-1-314b"), tconfigs.get("grok-1-314b")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert tcfg.param_counts() == jcfg.param_counts()


def test_grok_forward_and_loss_match_reference(grok):
    jcfg, tcfg, jparams, _, model = grok
    toks, labels = _tokens(tcfg, 2, 20), _tokens(tcfg, 2, 20, seed=1)
    labels[1, :4] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    with repro.use(backend="xla"):
        want, waux = japi.forward(jparams, jb, jcfg)
        wloss, wmetrics = japi.loss_fn(jparams, jb, jcfg)
    with torch.no_grad():
        got, aux = tapi.forward(model, tb, tcfg)
        loss, metrics = tapi.loss_fn(model, tb, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    assert float(waux["dropped_fraction"]) > 0      # capacity binds
    for key in waux:
        np.testing.assert_allclose(float(aux[key]), float(waux[key]), **BAND)
    assert sorted(metrics) == sorted(wmetrics)
    for key in wmetrics:
        np.testing.assert_allclose(float(metrics[key]), float(wmetrics[key]),
                                   **BAND)


def test_grok_loss_gradients_flow_to_every_weight(grok):
    """The torch backend differentiates the MoE (the router through the
    gates and the balance terms)."""
    _, tcfg, _, _, model = grok
    toks = torch.from_numpy(_tokens(tcfg, 2, 12))
    loss, _ = tapi.loss_fn(model, {"tokens": toks, "labels": toks}, tcfg)
    loss.backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("name", ["grok-1-314b", "deepseek-v3-671b"])
def test_prefill_decode_matches_forward(name):
    """Dropless capacity: prefill + stepwise decode == the train forward."""
    _, tcfg, _, _, model = _pair(name, moe_capacity_factor=4.0)
    toks = torch.from_numpy(_tokens(tcfg, 2, 16, seed=3))
    t_pre = 12
    with torch.inference_mode():
        full, _ = tapi.forward(model, {"tokens": toks}, tcfg)
        cache = tapi.init_cache(tcfg, 2, 16, device="cpu")
        logits, cache = tapi.prefill(model, {"tokens": toks[:, :t_pre]},
                                     tcfg, cache)
        np.testing.assert_allclose(logits.numpy(), full[:, t_pre - 1].numpy(),
                                   rtol=2e-3, atol=2e-3)
        for i in range(t_pre, 16):
            logits, cache = tapi.decode_step(model, toks[:, i:i + 1], tcfg,
                                             cache, i)
            np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(),
                                       rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("prompt", [1, 20])
def test_grok_engine_greedy_matches_reference(grok, prompt):
    """Prefill groups by row (capacity binds at 20 tokens), decode one
    global group of the batch."""
    jcfg, tcfg, jparams, _, model = grok
    toks = _tokens(tcfg, 3, prompt, seed=prompt)
    with repro.use(backend="xla"):
        want = JEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN)).generate(
            {"tokens": jnp.asarray(toks)}, n_tokens=10, stop_tokens=())
    got = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN),
                 device="cpu").generate({"tokens": torch.from_numpy(toks)},
                                        n_tokens=10, stop_tokens=())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _requests(cfg, cls):
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(0, cfg.vocab, n).tolist(), max_tokens=m,
                stop_tokens=()) for n, m in zip(PROMPT_LENS, MAX_TOKENS)]


@pytest.fixture(scope="module")
def grok_reference(grok):
    """The reference engine's greedy tokens, one run per pool."""
    jcfg, tcfg, jparams, _, _ = grok
    with repro.use(backend="xla"):
        return {name: JContinuousEngine(
            jcfg, jparams, JPoolConfig(n_slots=4, max_len=MAX_LEN,
                                       **kw)).serve(
                _requests(tcfg, JRequest))
            for name, kw in POOLS.items()}


@pytest.mark.parametrize("pool", list(POOLS))
def test_grok_continuous_greedy_matches_reference(grok, grok_reference,
                                                  pool):
    """Four slots, six requests: slots free and refill, and a step's free
    slots decode garbage beside live ones (routed apart).  int8 pages:
    the reference's own paged test lets one request differ (a rounding
    near-tie); here every request matches."""
    _, tcfg, _, _, model = grok
    ce = ContinuousEngine(tcfg, model, PoolConfig(n_slots=4, max_len=MAX_LEN,
                                                  **POOLS[pool]),
                          device="cpu")
    assert ce.paged == (pool != "slotted")
    got = ce.serve(_requests(tcfg, Request))
    assert got == grok_reference[pool]
    assert ce.pool.n_free == ce.pool.n_slots
    assert ce.pool.alloc_count == ce.pool.free_count == len(PROMPT_LENS)


def test_grok_params_round_trip(grok):
    _, tcfg, _, tree, model = grok
    assert sorted(tree["blocks"]["moe"]) == ["router", "w_down", "w_gate",
                                             "w_up"]
    back = interop.params_to_numpy(model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat[path], leaf)
    names = dict(model.named_parameters())
    assert names["blocks.0.moe.w_gate"].shape == (
        tcfg.n_experts, tcfg.d_model, tcfg.moe_d_ff)


def test_grok_init_params_scales():
    cfg = tconfigs.get("grok-1-314b").reduced()
    model = tapi.init_params(cfg, device="cpu")
    moe_ = model.blocks[0].moe
    for w, fan_in in ((moe_.w_gate, cfg.d_model), (moe_.w_down,
                                                   cfg.moe_d_ff),
                      (moe_.router, cfg.d_model)):
        assert abs(float(w.detach().std()) - fan_in ** -0.5) < 0.02


def test_quant_tiers_refused(grok, monkeypatch):
    """Nothing of the quant tiers is refused on an MoE config any longer:
    both engines serve ``quant`` and ``decode_quant`` tiers and calibrated
    weights, the experts on the quantized batched GEMM (each tier's tokens
    are held against the reference's in ``test_torch_quant_families.py``)."""
    from repro_torch.kernels.brgemm import quant as Q
    _, tcfg, _, _, model = grok
    calls = []
    real = Q.batched_matmul_q

    def spy(*args, **kw):
        calls.append(kw["qcfg"])
        return real(*args, **kw)

    monkeypatch.setattr(Q, "batched_matmul_q", spy)
    scfg = ServeConfig(max_len=MAX_LEN)
    toks = {"tokens": torch.from_numpy(_tokens(tcfg, 2, 6))}
    for kw in ({"decode_quant": "int8"}, {"quant": "int8"}):
        calls.clear()
        out = Engine(tcfg, model, scfg, device="cpu", **kw).generate(
            toks, n_tokens=3, stop_tokens=())
        assert out.shape == (2, 3)
        # 3 expert GEMMs a layer a forward: every forward under "quant",
        # the two decode forwards under "decode_quant"
        forwards = 3 if "quant" in kw else 2
        assert len(calls) == 3 * tcfg.n_layers * forwards
        ce = ContinuousEngine(tcfg, model, PoolConfig(n_slots=2,
                                                      max_len=MAX_LEN),
                              device="cpu", **kw)
        got = ce.serve([Request(prompt=[3, 1, 4, 1, 5], max_tokens=3,
                                stop_tokens=())])
        assert len(got[0]) == 3 and ce.pool.n_free == ce.pool.n_slots
    calls.clear()
    out = Engine(tcfg, quant.calibrate_params(model, "int8"), scfg,
                 device="cpu").generate(toks, n_tokens=3, stop_tokens=())
    assert out.shape == (2, 3)
    assert len(calls) == 3 * tcfg.n_layers * 3
    assert all(c == quant.QuantConfig() for c in calls)
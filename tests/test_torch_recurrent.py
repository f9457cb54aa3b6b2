"""The port's recurrent layers and families against the JAX package, on the
CPU: RG-LRU, mLSTM and sLSTM (``repro.layers.recurrent``), xlstm-1.3b and
recurrentgemma-9b (its local attention's ring cache, the trailing rec
blocks), both engines and the pool's per-kind layout.

Each config is the reference's ``reduced()`` form (fp32; recurrentgemma's
window cut to 8, and its depth set to 8 layers, two (rec, rec, attn)
groups and two trailing rec blocks, so that ``tail_rec`` runs), weights
made by the reference from a fixed key and handed over as numpy arrays
(``interop``).  The port runs on its ``torch`` backend, the reference under
``repro.use(backend="xla")``.  Bands: atol = rtol = 1e-4 on outputs,
logits, losses and every state leaf (fp32 both sides, two frameworks' sum
orders), as ``test_torch_dense_variants.py``; greedy tokens must match
exactly.  mLSTM's and sLSTM's ``m`` (a running log-space max) hold to the
same band.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.configs.shapes import ShapeCfg as JShapeCfg
from repro.layers import recurrent as jrec
from repro.models import api as japi
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro.serve import PoolConfig as JPoolConfig
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch import interop, quant
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.core import brgemm
from repro_torch.data import pipeline as tpipeline
from repro_torch.layers import attention, recurrent
from repro_torch.models import api as tapi
from repro_torch.models import blocks as tblocks
from repro_torch.serve import (ContinuousEngine, Engine, PoolConfig, Request,
                               ServeConfig)
from repro_torch.serve.kv_cache import SlotKVCache

BAND = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 48
WINDOW = 8
RG_LAYERS = 8           # 2 x (rec, rec, attn) + 2 trailing rec blocks
# The continuous runs: more requests than slots, so slots free and take new
# requests; recurrentgemma's prompts on both sides of the window; xlstm's
# prompts obey mLSTM's chunk rule (chunk 16: <= 16 tokens or a multiple).
XLSTM_PROMPTS = [5, 16, 32, 1, 12]
RG_PROMPTS = [3, 13, 6, 20, 2]
MAX_TOKENS = [9, 7, 8, 10, 7]


def _cfgs(name):
    jcfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
    if name == "recurrentgemma-9b":
        jcfg = dataclasses.replace(jcfg, n_layers=RG_LAYERS)
        tcfg = dataclasses.replace(tcfg, n_layers=RG_LAYERS)
    return jcfg, tcfg


def _pair(name):
    jcfg, tcfg = _cfgs(name)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree, interop.params_from_numpy(
        tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def xlstm():
    return _pair("xlstm-1.3b")


@pytest.fixture(scope="module")
def rg():
    return _pair("recurrentgemma-9b")


@pytest.fixture(scope="module")
def pairs(xlstm, rg):
    return {"xlstm-1.3b": xlstm, "recurrentgemma-9b": rg}


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t)).astype(np.int32)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **BAND)


# ==========================================================================
# the layers
# ==========================================================================

D, B, T = 32, 2, 12


def _rglru():
    jcfg = jrec.RGLRUCfg(d_model=D, d_rnn=48)
    p = jrec.rglru_init(jax.random.PRNGKey(1), jcfg)
    mod = recurrent.RGLRU(recurrent.RGLRUCfg(d_model=D, d_rnn=48))
    state = lambda rng: {"h": rng.normal(size=(B, 48)).astype(np.float32),
                         "conv": rng.normal(size=(B, 3, 48)).astype(
                             np.float32)}
    return jrec.rglru_apply, jcfg, p, mod, state


def _mlstm():
    jcfg = jrec.MLSTMCfg(d_model=D, n_heads=2, dk=16, dv=16, chunk=4)
    p = jrec.mlstm_init(jax.random.PRNGKey(2), jcfg)
    mod = recurrent.MLSTM(recurrent.MLSTMCfg(d_model=D, n_heads=2, dk=16,
                                             dv=16, chunk=4))

    def state(rng):
        return (rng.normal(size=(B, 2, 16, 16)).astype(np.float32),
                rng.normal(size=(B, 2, 16)).astype(np.float32),
                rng.normal(size=(B, 2)).astype(np.float32))
    return jrec.mlstm_apply, jcfg, p, mod, state


def _slstm():
    jcfg = jrec.SLSTMCfg(d_model=D, n_heads=4)
    p = jrec.slstm_init(jax.random.PRNGKey(3), jcfg)
    mod = recurrent.SLSTM(recurrent.SLSTMCfg(d_model=D, n_heads=4))

    def state(rng):
        return {k: rng.normal(size=(B, D)).astype(np.float32)
                for k in ("h", "c", "n", "m")}
    return jrec.slstm_apply, jcfg, p, mod, state


LAYERS = {"rglru": _rglru, "mlstm": _mlstm, "slstm": _slstm}


def _load(mod, p):
    """The reference's layer params into the port's module (a nested dict:
    ``head_norm.scale``)."""
    with torch.no_grad():
        for name, param in mod.named_parameters():
            leaf = p
            for key in name.split("."):
                leaf = leaf[key]
            param.copy_(torch.tensor(np.asarray(leaf)))


def _as_port_state(kind, state):
    if kind == "mlstm":
        return dict(zip(("c", "n", "m"), map(torch.tensor, state)))
    return {k: torch.tensor(v) for k, v in state.items()}


def _state_leaves(kind, state):
    """A state as (leaf name, array) pairs, mLSTM's tuple named."""
    if kind == "mlstm" and isinstance(state, tuple):
        state = dict(zip(("c", "n", "m"), state))
    return {k: np.asarray(v) for k, v in state.items()}


@pytest.mark.parametrize("case", ["zero_state", "carried_state",
                                  "decode_step"])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_matches_reference(kind, case):
    """Output and every state leaf of one layer from the initial state,
    from a carried state (T = 12: three mLSTM chunks of 4), and one decode
    step from a carried state."""
    apply, jcfg, p, mod, make_state = LAYERS[kind]()
    _load(mod, p)
    rng = np.random.default_rng(7)
    t = 1 if case == "decode_step" else T
    x = rng.normal(size=(B, t, D)).astype(np.float32)
    state = None if case == "zero_state" else make_state(rng)
    with repro.use(backend="xla"):
        jstate = (None if state is None else
                  tuple(map(jnp.asarray, state)) if kind == "mlstm" else
                  {k: jnp.asarray(v) for k, v in state.items()})
        want, want_state = apply(p, jnp.asarray(x), jcfg, state=jstate)
    with torch.no_grad():
        got, got_state = mod(torch.from_numpy(x), state=None if state is None
                             else _as_port_state(kind, state))
    _close(got, want, f"{kind} output")
    want_leaves = _state_leaves(kind, want_state)
    assert sorted(got_state) == sorted(want_leaves)
    for key, leaf in want_leaves.items():
        _close(got_state[key], leaf, f"{kind} state {key}")


def _mlstm_inputs(t, seed=3, b=2, h=2, dk=8, dv=8):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, h, t, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    logi = rng.normal(size=(b, h, t)).astype(np.float32)
    logf = np.log(1 / (1 + np.exp(-rng.normal(2.0, 1.0, size=(b, h, t))))
                  ).astype(np.float32)
    return q, k, v, logi, logf


def test_mlstm_chunkwise_matches_reference_and_scan():
    """Four chunks of 6 against the reference's chunkwise form, and against
    the per-step scan, from the initial state and from a carried one."""
    q, k, v, logi, logf = _mlstm_inputs(24)
    want, wst = jrec.mlstm_chunkwise(*map(jnp.asarray, (q, k, v, logi, logf)),
                                     chunk=6)
    args = tuple(map(torch.from_numpy, (q, k, v, logi, logf)))
    got, gst = recurrent.mlstm_chunkwise(*args, chunk=6)
    scan, sst = recurrent.mlstm_scan(*args)
    _close(got, want)
    _close(scan, got)
    for a, b_, c in zip(gst, wst, sst):
        _close(a, b_)
        _close(c, a)
    # from the carried state, a second stretch of 12
    q2, k2, v2, li2, lf2 = _mlstm_inputs(12, seed=4)
    want2, _ = jrec.mlstm_chunkwise(*map(jnp.asarray, (q2, k2, v2, li2, lf2)),
                                    chunk=6, state=wst)
    args2 = tuple(map(torch.from_numpy, (q2, k2, v2, li2, lf2)))
    got2, _ = recurrent.mlstm_chunkwise(*args2, chunk=6, state=gst)
    scan2, _ = recurrent.mlstm_scan(*args2, state=sst)
    _close(got2, want2)
    _close(scan2, got2)


def test_mlstm_chunk_rule_raises():
    args = tuple(map(torch.from_numpy, _mlstm_inputs(10)))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        recurrent.mlstm_chunkwise(*args, chunk=4)
    assert recurrent.chunk_len(256, 200) == 200
    assert recurrent.chunk_len(256, 512) == 256


def test_linear_scan_is_the_recurrence_without_underflow():
    """The doubling scan against a loop over T, at decays near 0.9 over
    2048 steps, where a running product of ``a`` underflows fp32."""
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.uniform(0.9, 0.92, size=(2, 2048, 3)),
                     dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(2, 2048, 3)), dtype=torch.float32)
    assert float(torch.prod(a[:, :, 0], dim=1).max()) < \
        torch.finfo(torch.float32).tiny
    got = recurrent.linear_scan(a, b)
    h = torch.zeros(2, 3)
    want = []
    for t in range(2048):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    want = torch.stack(want, dim=1)
    assert torch.isfinite(got).all()
    _close(got, want)


# ==========================================================================
# the families
# ==========================================================================

def test_recurrent_configs_are_the_references():
    for name in ("xlstm-1.3b", "recurrentgemma-9b"):
        j, t = jconfigs.get(name), tconfigs.get(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    tblocks.check_ported(tconfigs.get("xlstm-1.3b"))
    tblocks.check_ported(tconfigs.get("recurrentgemma-9b"))
    assert tblocks.UNPORTED == ()


def test_layouts_follow_the_reference_stacks(xlstm, rg):
    _, tcfg, _, _, model = xlstm
    kinds = [type(b).kind for b in model.blocks]
    assert kinds == ["mlstm"] * 7 + ["slstm"]
    _, tcfg, _, _, model = rg
    assert [type(b).kind for b in model.blocks] == \
        ["rec", "rec", "attn"] * 2 + ["rec", "rec"]
    # the stack runs a group's rec blocks before its attention block,
    # whatever the pattern's order
    odd = dataclasses.replace(tcfg, pattern=("attn", "rec", "rec"))
    assert [k for k, _, _ in tblocks.recurrent_layout(odd)][:3] == \
        ["rec", "rec", "attn"]
    # xlstm with n_layers no multiple of slstm_every: mLSTMs only
    lone = dataclasses.replace(xlstm[1], n_layers=6)
    assert [k for k, _, _ in tblocks.recurrent_layout(lone)] == ["mlstm"] * 6


@pytest.mark.parametrize("name,t", [("xlstm-1.3b", 32),
                                    ("recurrentgemma-9b", 19)],
                         ids=["xlstm", "rg_past_window"])
def test_forward_and_loss_match_reference(pairs, name, t):
    """Train-mode logits and the loss: xlstm over two mLSTM chunks;
    recurrentgemma past its window of 8."""
    jcfg, tcfg, jparams, _, model = pairs[name]
    toks = _tokens(tcfg, 2, t)
    labels = _tokens(tcfg, 2, t, seed=1)
    labels[0, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    with repro.use(backend="xla"):
        want, _ = japi.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
        wloss, _ = japi.loss_fn(jparams, jax.tree.map(jnp.asarray, batch),
                                jcfg)
    with torch.no_grad():
        got, aux = tapi.forward(model, {"tokens": torch.from_numpy(toks)},
                                tcfg)
        gloss, metrics = tapi.loss_fn(
            model, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, t, tcfg.vocab)
    _close(got, want)
    _close(gloss, wloss)
    assert sorted(metrics) == ["ce_loss", "loss"]


def _ref_layer_states(jcache, cfg):
    """The reference's cache as per-layer dicts of numpy leaves, in the
    port's layer order (``blocks.recurrent_layout``)."""
    keys = {"mlstm_groups": "mlstm", "slstm_groups": "slstm",
            "groups.rec": "groups_rec", "groups.attn": "groups_attn",
            "tail_rec": "tail_rec"}
    out = []
    for kind, stack, idx in tblocks.recurrent_layout(cfg):
        node = jcache[keys[stack]]
        if kind == "mlstm":
            node = dict(zip(("c", "n", "m"), node))
        out.append({k: np.asarray(v)[idx] for k, v in node.items()})
    return out


def _states_match(cache, jcache, cfg, what):
    for i, (layer, want) in enumerate(zip(cache["blocks"],
                                          _ref_layer_states(jcache, cfg))):
        assert sorted(layer) == sorted(want)
        for key, leaf in want.items():
            _close(layer[key], leaf, f"{what}: layer {i} {key}")


@pytest.mark.parametrize("name,prompt", [("xlstm-1.3b", 16),
                                         ("xlstm-1.3b", 32),
                                         ("recurrentgemma-9b", 5),
                                         ("recurrentgemma-9b", 13)],
                         ids=["xlstm_one_chunk", "xlstm_two_chunks",
                              "rg_short", "rg_wrapped"])
def test_prefill_and_decode_match_reference(pairs, name, prompt):
    """Prefill's logits and every state leaf (the rings too), then 8 decode
    steps: each step's logits, and every leaf after the last."""
    jcfg, tcfg, jparams, _, model = pairs[name]
    toks = _tokens(tcfg, 2, prompt, seed=prompt)
    fed = _tokens(tcfg, 2, 8, seed=100 + prompt)
    with repro.use(backend="xla"):
        jcache = japi.init_cache(jcfg, 2, MAX_LEN)
        jl, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                  jcfg, jcache)
        want = [np.asarray(jl)]
        after_prefill = jax.tree.map(np.asarray, jcache)
        for i in range(8):
            jl, jcache = japi.decode_step(
                jparams, jnp.asarray(fed[:, i:i + 1]), jcfg, jcache,
                prompt + i)
            want.append(np.asarray(jl))
    with torch.inference_mode():
        cache = tapi.init_cache(tcfg, 2, MAX_LEN, device="cpu")
        logits, cache = tapi.prefill(model, {"tokens": torch.from_numpy(toks)},
                                     tcfg, cache)
        got = [logits.numpy()]
        _states_match(cache, after_prefill, tcfg, "prefill")
        for i in range(8):
            logits, cache = tapi.decode_step(
                model, torch.from_numpy(fed[:, i:i + 1]), tcfg, cache,
                prompt + i)
            got.append(logits.numpy())
        _states_match(cache, jcache, tcfg, "decode")
    for step, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"step {step}")


@pytest.mark.parametrize("name,prompt", [("xlstm-1.3b", 12),
                                         ("recurrentgemma-9b", 13)],
                         ids=["xlstm", "rg_wrapped"])
def test_engine_greedy_matches_reference(pairs, name, prompt):
    jcfg, tcfg, jparams, _, model = pairs[name]
    toks = _tokens(tcfg, 2, prompt, seed=prompt)
    with repro.use(backend="xla"):
        want = JEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN)).generate(
            {"tokens": jnp.asarray(toks)}, n_tokens=10, stop_tokens=())
    got = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN),
                 device="cpu").generate({"tokens": torch.from_numpy(toks)},
                                        n_tokens=10, stop_tokens=())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["xlstm-1.3b", "recurrentgemma-9b"],
                         ids=["xlstm", "rg"])
def test_continuous_greedy_matches_reference(pairs, name):
    """Five requests over three slots, 6-9 decode steps each: slots free
    and take new requests (whose states must start from the initial values,
    not the last request's), free slots decode garbage beside live ones,
    and a page size leaves the engine on the slotted pool."""
    jcfg, tcfg, jparams, _, model = pairs[name]
    lens = XLSTM_PROMPTS if name == "xlstm-1.3b" else RG_PROMPTS
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in lens]
    with repro.use(backend="xla"):
        want = JContinuousEngine(
            jcfg, jparams, JPoolConfig(n_slots=3, max_len=MAX_LEN)).serve(
                [JRequest(prompt=p, max_tokens=m, stop_tokens=())
                 for p, m in zip(prompts, MAX_TOKENS)])
    ce = ContinuousEngine(tcfg, model, PoolConfig(n_slots=3, max_len=MAX_LEN,
                                                  page_size=8), device="cpu")
    assert not ce.paged and isinstance(ce.pool, SlotKVCache)
    got = ce.serve([Request(prompt=p, max_tokens=m, stop_tokens=())
                    for p, m in zip(prompts, MAX_TOKENS)])
    assert got == want
    assert ce.pool.n_free == ce.pool.n_slots
    assert ce.pool.alloc_count == ce.pool.free_count == len(lens)
    assert ce.metrics.decode_steps >= 6


def test_slot_reuse_starts_from_the_initial_state(xlstm):
    """A slot that decoded a request (and garbage after it) and is admitted
    again gives the new request the tokens a fresh engine gives it."""
    _, tcfg, _, _, model = xlstm
    rng = np.random.default_rng(3)
    first, second = (rng.integers(0, tcfg.vocab, n).tolist() for n in (9, 7))
    ce = ContinuousEngine(tcfg, model, PoolConfig(n_slots=1, max_len=MAX_LEN),
                          device="cpu")
    ce.serve([Request(prompt=first, max_tokens=6, stop_tokens=())])
    for _ in range(3):            # the free slot decodes garbage
        with torch.inference_mode():
            ce._decode()
    again = ce.serve([Request(prompt=second, max_tokens=6, stop_tokens=())])
    fresh = ContinuousEngine(tcfg, model, PoolConfig(n_slots=1,
                                                     max_len=MAX_LEN),
                             device="cpu").serve(
        [Request(prompt=second, max_tokens=6, stop_tokens=())])
    assert list(again.values()) == list(fresh.values())
    assert ce.pool.alloc_count == 2


def test_pool_layout_by_kind(rg, xlstm):
    """The pool stacks each leaf over the layers of its kind at the
    reference's initial values; ``layer_views`` hands each layer its own
    views (a write through one lands in the pool) and ``stack_layers``
    inverts it; ``kv_bytes`` counts every leaf."""
    _, tcfg, _, _, _ = xlstm
    pool = SlotKVCache(tcfg, 3, MAX_LEN, device="cpu")
    assert tapi.cache_keys(tcfg) == ("mlstm.c", "mlstm.n", "mlstm.m",
                                     "slstm.h", "slstm.c", "slstm.n",
                                     "slstm.m")
    h, dh = tcfg.n_heads, tcfg.d_model // tcfg.n_heads
    assert pool.leaves["mlstm.c"].shape == (7, 3, h, dh, dh)
    assert tapi.kv_shape(tcfg, 3, MAX_LEN, "slstm.n") == (1, 3, tcfg.d_model)
    assert bool((pool.leaves["mlstm.m"] == -1e30).all())
    assert bool((pool.leaves["slstm.n"] == 1).all())
    assert pool.kv_bytes() == sum(v.numel() * 4
                                  for v in pool.leaves.values())
    with torch.inference_mode():
        pool.cache["blocks"][7]["h"][1] = 5.0
    assert bool((pool.leaves["slstm.h"][0, 1] == 5.0).all())
    _, tcfg, _, _, _ = rg
    pool = SlotKVCache(tcfg, 2, MAX_LEN, device="cpu")
    assert tapi.cache_keys(tcfg) == ("rec.h", "rec.conv", "attn.k", "attn.v")
    assert pool.leaves["rec.h"].shape == (6, 2, tcfg.d_rnn)
    assert pool.leaves["rec.conv"].shape == (6, 2, 3, tcfg.d_rnn)
    assert pool.leaves["attn.k"].shape == (2, 2, 1, WINDOW, tcfg.dh)
    views = pool.cache["blocks"]
    assert sorted(views[2]) == ["k", "v"] and sorted(views[7]) == ["conv",
                                                                  "h"]
    back = tapi.stack_layers(pool.cache, tcfg)
    assert all(torch.equal(back[k], pool.leaves[k]) for k in back)


def test_launches_per_layer(pairs, monkeypatch):
    """The GEMMs and flash calls of a forward, derived from the code: an
    mLSTM layer 7 ``matmul``, an sLSTM 1, a rec block 5 + 3 (the gated
    MLP), an attention block 4 + 3 and one flash call at prefill, the head
    1; a decode step calls no flash kernel."""
    from repro_torch.layers import attention as tattention
    calls = []
    real_mm, real_fl = brgemm.matmul, tattention.flash_attention

    def mm(x, w, *args, **kw):
        calls.append(("matmul", tuple(w.shape), kw.get("activation",
                                                       "none")))
        return real_mm(x, w, *args, **kw)

    def fl(*args, **kw):
        calls.append(("flash", kw.get("window")))
        return real_fl(*args, **kw)

    monkeypatch.setattr(brgemm, "matmul", mm)
    monkeypatch.setattr(tattention, "flash_attention", fl)
    for name, per_layer in (("xlstm-1.3b", {"mlstm": 7, "slstm": 1}),
                            ("recurrentgemma-9b", {"rec": 8, "attn": 7})):
        _, tcfg, _, _, model = pairs[name]
        kinds = [k for k, _, _ in tblocks.recurrent_layout(tcfg)]
        n_attn = kinds.count("attn")
        with torch.inference_mode():
            cache = tapi.init_cache(tcfg, 1, MAX_LEN, device="cpu")
            calls.clear()
            logits, cache = tapi.prefill(
                model, {"tokens": torch.zeros(1, 16, dtype=torch.long)},
                tcfg, cache)
            want = sum(per_layer[k] for k in kinds) + 1
            assert sum(c[0] == "matmul" for c in calls) == want
            assert [c for c in calls if c[0] == "flash"] == \
                [("flash", tcfg.window)] * n_attn
            calls.clear()
            tapi.decode_step(model, torch.zeros(1, 1, dtype=torch.long),
                             tcfg, cache, 16)
            assert len(calls) == want
        if name == "recurrentgemma-9b":
            acts = [c[2] for c in calls[:5]]
            assert acts == ["gelu", "none", "sigmoid", "sigmoid", "none"]


# ==========================================================================
# refusals, interop, init, pipeline
# ==========================================================================

@pytest.mark.parametrize("name", ["xlstm-1.3b", "recurrentgemma-9b"],
                         ids=["xlstm", "rg"])
def test_recurrent_refusals(pairs, name):
    """Chunked and bucketed prefill raise (the reference's engine refuses
    them), and xlstm's mLSTM chunk rule raises before any state is
    written; the quant tiers and calibrated weights no longer raise."""
    jcfg, tcfg, jparams, _, model = pairs[name]
    assert not tapi.supports_paging(tcfg)
    for kw, msg in (({"prefill_chunk": 8}, "prefill_chunk is not supported"),
                    ({"prefill_bucket": 8}, "prefill_bucket is not "
                                            "supported")):
        with pytest.raises(ValueError, match=msg):
            JContinuousEngine(jcfg, jparams, JPoolConfig(
                n_slots=2, max_len=MAX_LEN, **kw))
        with pytest.raises(ValueError, match=msg):
            ContinuousEngine(tcfg, model, PoolConfig(n_slots=2,
                                                     max_len=MAX_LEN, **kw),
                             device="cpu")
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="chunked prefill"):
        cache = tapi.init_cache(tcfg, 1, MAX_LEN, device="cpu")
        tapi.prefill_chunk(model, {"tokens": torch.zeros(1, 4,
                                                         dtype=torch.long)},
                           tcfg, cache, 0)
    # the quant tiers are served now (held against the reference in
    # test_torch_quant_families.py): each engine, a tier or calibrated
    # weights, sLSTM's recurrent r left in full precision
    toks = {"tokens": torch.zeros(1, 8, dtype=torch.long)}
    out = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN), device="cpu",
                 quant="int8").generate(toks, n_tokens=2, stop_tokens=())
    assert out.shape == (1, 2)
    got = ContinuousEngine(tcfg, model, PoolConfig(
        n_slots=2, max_len=MAX_LEN), device="cpu",
        decode_quant="int8").serve(
        [Request(prompt=[1] * 8, max_tokens=2, stop_tokens=())])
    assert len(got[0]) == 2
    calibrated = quant.calibrate_params(model, "int8")
    assert not any(isinstance(m, quant.QuantizedTensor) for n, m in
                   calibrated.named_modules() if n.endswith(".r"))
    out = Engine(tcfg, calibrated, ServeConfig(max_len=MAX_LEN),
                 device="cpu").generate(toks, n_tokens=2, stop_tokens=())
    assert out.shape == (1, 2)
    if name != "xlstm-1.3b":
        return
    ce = ContinuousEngine(tcfg, model, PoolConfig(n_slots=2,
                                                  max_len=MAX_LEN),
                          device="cpu")
    before = {k: v.clone() for k, v in ce.pool.leaves.items()}
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ce.submit(Request(prompt=[1] * 20, max_tokens=2))
    assert ce.scheduler.queue_depth == 0
    assert all(torch.equal(before[k], v) for k, v in ce.pool.leaves.items())
    with pytest.raises(ValueError, match="multiple of the chunk"):
        Engine(tcfg, model, ServeConfig(max_len=MAX_LEN),
               device="cpu").generate(
            {"tokens": torch.zeros(1, 20, dtype=torch.long)}, n_tokens=2)
    with torch.inference_mode():
        cache = tapi.init_cache(tcfg, 1, MAX_LEN, device="cpu")
        fresh = tapi.stack_layers(cache, tcfg)
        with pytest.raises(ValueError, match="multiple of the chunk"):
            tapi.prefill(model, {"tokens": torch.zeros(1, 20,
                                                       dtype=torch.long)},
                         tcfg, cache)
        assert all(torch.equal(fresh[k], v) for k, v in
                   tapi.stack_layers(cache, tcfg).items())


@pytest.mark.parametrize("name", ["xlstm-1.3b", "recurrentgemma-9b"],
                         ids=["xlstm", "rg"])
def test_params_round_trip(pairs, name):
    """The nested stacks carry across and back leaf for leaf:
    ``mlstm_groups`` (g, per, ...), ``slstm_groups``, ``groups.rec`` (g,
    n_rec, ...), ``groups.attn`` and ``tail_rec``."""
    _, tcfg, _, tree, model = pairs[name]
    back = interop.params_to_numpy(model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat[path], leaf)
    if name == "recurrentgemma-9b":
        assert back["tail_rec"]["rglru"]["lam"].shape == (2, tcfg.d_rnn)
        assert back["groups"]["rec"]["rglru"]["w_gelu"].shape[:2] == (2, 2)


def test_init_params_draws_the_references_distributions():
    for name in ("xlstm-1.3b", "recurrentgemma-9b"):
        cfg = tconfigs.get(name).reduced()
        named = dict(tapi.init_params(cfg, device="cpu").named_parameters())
        for key, p in named.items():
            p = p.detach()
            if key.endswith("rglru.lam"):
                a = torch.sigmoid(p)
                assert float(a.min()) >= 0.9 - 1e-6
                assert float(a.max()) <= 0.999 + 1e-6
            elif key.endswith("mlstm.bf"):
                assert bool((p == 3.0).all())
            elif key.endswith("slstm.b"):
                d = cfg.d_model
                assert bool((p[2 * d:3 * d] == 3.0).all())
                assert float(p[:2 * d].abs().sum() + p[3 * d:].abs().sum()) \
                    == 0.0
            elif key.endswith(("b_rgate", "b_igate", "mlstm.bi")):
                assert float(p.abs().sum()) == 0.0
            elif key.endswith("rglru.conv_w"):
                assert abs(float(p.std()) - cfg.d_rnn ** -0.5) < 0.02
            elif key.endswith("slstm.r"):
                assert abs(float(p.std()) - p.shape[1] ** -0.5) < 0.03


@pytest.mark.parametrize("name", ["xlstm-1.3b", "recurrentgemma-9b"],
                         ids=["xlstm", "rg"])
def test_pipeline_batches_and_loss_match_reference(pairs, name):
    """The port's token stream takes both configs: its batch equals the
    reference's, and the loss on it matches."""
    jcfg, tcfg, jparams, _, model = pairs[name]
    shape = dict(name="t", kind="train", seq_len=16, global_batch=2)
    pipe = tpipeline.TokenPipeline(tcfg, ShapeCfg(**shape), seed=3)
    jpipe = jpipeline.TokenPipeline(jcfg, JShapeCfg(**shape), seed=3)
    try:
        got, want = next(pipe), next(jpipe)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    finally:
        pipe.close()
        jpipe.close()
    with repro.use(backend="xla"):
        wloss, _ = japi.loss_fn(jparams, jax.tree.map(jnp.asarray, want),
                                jcfg)
    with torch.no_grad():
        gloss, _ = tapi.loss_fn(model, {k: torch.from_numpy(np.asarray(v))
                                        for k, v in got.items()}, tcfg)
    _close(gloss, wloss)


def test_local_attention_is_the_windowed_gqa_ring(rg):
    """recurrentgemma's attention block runs the port's ring attention with
    the config's window over one kv head."""
    _, tcfg, _, _, model = rg
    block = model.blocks[2]
    assert isinstance(block, tblocks.LocalAttnBlock)
    assert isinstance(block.attn, attention.Attention)
    assert block.attn.cfg.window == WINDOW and block.attn.cfg.n_kv_heads == 1
    cache = block.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    assert cache["k"].shape == (1, 1, WINDOW, tcfg.dh)

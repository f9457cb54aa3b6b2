"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
package, on the CPU: the encoder, the train forward, loss and gradients,
one AdamW step, prefill, chunked prefill and decode with every cache leaf
(the self K and V, the cross K and V), both engines and every pool, the
quant tiers, the token stream and ``interop``.

The config is the reference's ``reduced()`` form (fp32, 2 encoder + 2
decoder layers, d_model 128, 4 q heads over 2 kv heads of 32, vocab 512),
weights made by the reference from a fixed key and handed over as numpy
arrays (``interop``), inputs made with numpy from a seed.  The port runs on
its ``torch`` backend, the reference under ``repro.use(backend="xla")``, as
``test_torch_recurrent.py`` does.  Bands: atol = rtol = 1e-4 on outputs,
logits, losses, gradients, parameters after a step and every cache leaf
(fp32 both sides, two frameworks' sum orders); greedy tokens must match
exactly, but int8 pages, where the reference's own paged test allows one
request of five to differ (an int8 rounding can flip a near-tie), as
``test_torch_paged.py`` does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import configs as jconfigs
from repro import quant as jquant
from repro.configs.shapes import ShapeCfg as JShapeCfg
from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro.serve import PoolConfig as JPoolConfig
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import interop, quant
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.core import brgemm
from repro_torch.data import pipeline as tpipeline
from repro_torch.layers import attention as tattention
from repro_torch.models import api as tapi
from repro_torch.models import blocks as tblocks
from repro_torch.models import encdec
from repro_torch.serve import (ContinuousEngine, Engine, PagedKVCache,
                               PoolConfig, Request, ServeConfig,
                               SlotKVCache)
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

NAME = "seamless-m4t-large-v2"
BAND = dict(atol=1e-4, rtol=1e-4)
MAX_LEN, SRC_LEN = 32, 12
# The continuous runs: five requests over two slots, so that slots free
# and take new requests, one prompt of one token (the mha_ref cross
# branch) and two longer than the chunk of 8.
PROMPT_LENS = [5, 11, 1, 17, 6]
MAX_TOKENS = [6, 12, 8, 10, 5]
POOLS = {
    "slotted": {},
    "paged": {"page_size": 4},
    "preempting": {"page_size": 4, "n_pages": 8},
    "chunked": {"page_size": 4, "prefill_chunk": 8},
    "bucketed": {"prefill_bucket": 8},
}


def _pair(cfg_j, cfg_t):
    jparams = japi.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg_j, cfg_t, jparams, tree, interop.params_from_numpy(
        tree, cfg_t, device="cpu")


@pytest.fixture(scope="module")
def seamless():
    return _pair(jconfigs.get(NAME).reduced(), tconfigs.get(NAME).reduced())


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t)).astype(np.int32)


def _src(cfg, b, seed=0, src_len=SRC_LEN):
    return np.random.default_rng(100 + seed).standard_normal(
        (b, src_len, cfg.d_model)).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **BAND)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves_match(cache, jcache, what):
    """Every leaf of the port's cache against the reference's: self K and
    V (``{"self": {"k", "v"}}``), cross K and V (``{"cross": ...}``),
    layers stacked on both sides."""
    got = tapi.stack_layers(cache)
    assert sorted(got) == ["cross.k", "cross.v", "k", "v"]
    for key, (node, leaf) in {"k": ("self", "k"), "v": ("self", "v"),
                              "cross.k": ("cross", "k"),
                              "cross.v": ("cross", "v")}.items():
        _close(got[key], jcache[node][leaf], f"{what}: {key}")


# ==========================================================================
# the model
# ==========================================================================

def test_config_is_the_references_and_ported():
    j, t = jconfigs.get(NAME), tconfigs.get(NAME)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_counts() == t.param_counts()
    tblocks.check_ported(t)
    assert tapi.is_encdec(t) and tapi.supports_paging(t)


def test_full_model_shapes_are_the_references():
    """The full config's parameters, built on no device, have the
    reference's shapes leaf for leaf (``head.w`` (1024, 256206) among
    them) and its 1.632 B parameters."""
    cfg = tconfigs.get(NAME)
    specs = japi.params_specs(None, jconfigs.get(NAME))
    want = {jax.tree_util.keystr(p, simple=True, separator="."): s.shape
            for p, s in jax.tree_util.tree_leaves_with_path(specs)}
    model = encdec.EncDec(cfg, device="meta")
    got, layers = {}, {}
    for name, p in model.named_parameters():
        stack, _, rest = name.partition(".")
        if stack in ("enc_blocks", "dec_blocks"):
            name = f"{stack}.{rest.split('.', 1)[1]}"
            layers[name] = layers.get(name, 0) + 1
        got[name] = tuple(p.shape)
    got = {k: (layers[k], *v) if k in layers else v for k, v in got.items()}
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["head.w"] == (1024, 256206)
    assert layers["enc_blocks.attn.wq"] == layers["dec_blocks.ln_x.scale"] \
        == 24
    n = sum(p.numel() for p in model.parameters())
    assert abs(n / 1e9 - 1.632) < 1e-3


def test_encode_matches_reference(seamless):
    jcfg, tcfg, jparams, _, model = seamless
    src = _src(tcfg, 2)
    with repro.use(backend="xla"):
        want = jencdec.encode(jparams, jnp.asarray(src), jcfg)
    with torch.no_grad():
        got = encdec.encode(model, torch.from_numpy(src), tcfg)
    assert got.shape == (2, SRC_LEN, tcfg.d_model)
    _close(got, want)


def test_forward_loss_and_grads_match_reference(seamless):
    """Train-mode logits, the loss (labels of -1 masked) and the gradient
    of every parameter."""
    jcfg, tcfg, jparams, _, model = seamless
    batch = {"src_embeds": _src(tcfg, 2), "tokens": _tokens(tcfg, 2, 9),
             "labels": _tokens(tcfg, 2, 9, seed=1)}
    batch["labels"][0, :3] = -1
    with repro.use(backend="xla"):
        want, _ = japi.forward(jparams, _j(batch), jcfg)
        (wloss, _), jgrads = jax.value_and_grad(
            lambda p: japi.loss_fn(p, _j(batch), jcfg), has_aux=True)(
                jparams)
    got, aux = tapi.forward(model, _t(batch), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 9, tcfg.vocab)
    assert aux == {}
    _close(got.detach(), want)
    metrics, grads = tts.loss_and_grads(model, batch, tcfg)
    _close(metrics["loss"], wloss)
    assert sorted(metrics) == ["ce_loss", "loss"]
    want_grads = dict(interop.named_leaves(
        jax.tree.map(np.asarray, jgrads), tcfg))
    assert sorted(want_grads) == sorted(grads)
    for name, g in grads.items():
        _close(g, want_grads[name], name)


def test_one_adamw_step_matches_reference(seamless):
    """One step through ``make_train_step`` from the reference's state: the
    loss and every parameter after it."""
    jcfg, tcfg, _, _, _ = seamless
    shape = dict(name="t", kind="train", seq_len=16, global_batch=2)
    pipe = jpipeline.TokenPipeline(jcfg, JShapeCfg(**shape), seed=2)
    try:
        batch = {k: np.asarray(v) for k, v in next(pipe).items()}
    finally:
        pipe.close()
    jstate = jts.init_state(jax.random.PRNGKey(0), jcfg, jopt.AdamWCfg())
    jstate["opt"]["step"] = jnp.asarray(10, jstate["opt"]["step"].dtype)
    state = {"opt": interop.opt_state_from_numpy(
        jax.tree.map(np.asarray, jstate["opt"]), tcfg, "cpu")}
    with repro.use(backend="xla"):
        jnew, jmetrics = jts.make_train_step(jcfg, jopt.AdamWCfg())(
            jstate, _j(batch))
    new, metrics = tts.make_train_step(tcfg, topt.AdamWCfg())(state, batch)
    _close(metrics["loss"], jmetrics["loss"])
    want = dict(interop.named_leaves(
        jax.tree.map(np.asarray, jnew["opt"]["master"]), tcfg))
    assert sorted(want) == sorted(new["opt"]["master"])
    moved = 0
    for name, p in new["opt"]["master"].items():
        _close(p, want[name], name)
        moved += not np.array_equal(
            p.numpy(), dict(interop.named_leaves(jax.tree.map(
                np.asarray, jstate["opt"]["master"]), tcfg))[name])
    assert moved == len(want)


@pytest.mark.parametrize("prompt", [7, 1], ids=["prompt7", "one_token"])
def test_prefill_and_decode_match_reference(seamless, prompt):
    """Prefill's logits and every cache leaf, then 8 decode steps: each
    step's logits and every leaf after the last.  A one-token decoder
    prompt runs the plain cross-attention branch at prefill too."""
    jcfg, tcfg, jparams, _, model = seamless
    batch = {"src_embeds": _src(tcfg, 2, prompt),
             "tokens": _tokens(tcfg, 2, prompt, seed=prompt)}
    fed = _tokens(tcfg, 2, 8, seed=50 + prompt)
    with repro.use(backend="xla"):
        jcache = japi.init_cache(jcfg, 2, MAX_LEN, SRC_LEN)
        jl, jcache = japi.prefill(jparams, _j(batch), jcfg, jcache)
        want = [np.asarray(jl)]
        after_prefill = jax.tree.map(np.asarray, jcache)
        for i in range(8):
            jl, jcache = japi.decode_step(
                jparams, jnp.asarray(fed[:, i:i + 1]), jcfg, jcache,
                prompt + i)
            want.append(np.asarray(jl))
    with torch.inference_mode():
        cache = tapi.init_cache(tcfg, 2, MAX_LEN, SRC_LEN, device="cpu")
        logits, cache = tapi.prefill(model, _t(batch), tcfg, cache)
        got = [logits.numpy()]
        _leaves_match(cache, after_prefill, "prefill")
        for i in range(8):
            logits, cache = tapi.decode_step(
                model, torch.from_numpy(fed[:, i:i + 1]), tcfg, cache,
                prompt + i)
            got.append(logits.numpy())
        _leaves_match(cache, jcache, "decode")
    for step, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"step {step}")


def test_prefill_chunk_matches_reference(seamless):
    """A prompt of 13 in chunks of 6, 6 and a right-padded 1 of 6: the
    first encodes and writes the cross K and V, the later ones read them;
    each chunk's logits and every leaf after each."""
    jcfg, tcfg, jparams, _, model = seamless
    toks = _tokens(tcfg, 1, 18, seed=3)
    src = _src(tcfg, 1, 3)
    chunks = [(0, 6, None), (6, 6, None), (12, 6, 1)]
    with repro.use(backend="xla"):
        jcache = japi.init_cache(jcfg, 1, MAX_LEN, SRC_LEN)
        want = []
        for pos, width, length in chunks:
            batch = {"tokens": jnp.asarray(toks[:, pos:pos + width])}
            if pos == 0:
                batch["src_embeds"] = jnp.asarray(src)
            jl, jcache = japi.prefill_chunk(
                jparams, batch, jcfg, jcache, pos, length=length,
                first_chunk=pos == 0)
            want.append((np.asarray(jl), jax.tree.map(np.asarray, jcache)))
    with torch.inference_mode():
        cache = tapi.init_cache(tcfg, 1, MAX_LEN, SRC_LEN, device="cpu")
        for (pos, width, length), (wl, wcache) in zip(chunks, want):
            batch = {"tokens": torch.from_numpy(toks[:, pos:pos + width])}
            if pos == 0:
                batch["src_embeds"] = torch.from_numpy(src)
            logits, cache = tapi.prefill_chunk(
                model, batch, tcfg, cache, pos, length=length,
                first_chunk=pos == 0)
            _close(logits, wl, f"chunk at {pos}")
            _leaves_match(cache, wcache, f"chunk at {pos}")


def test_bucketed_prefill_logit_pos_matches_reference(seamless):
    """A prompt of 5 right-padded to 8: the logits at position 4."""
    jcfg, tcfg, jparams, _, model = seamless
    toks = np.zeros((1, 8), np.int32)
    toks[:, :5] = _tokens(tcfg, 1, 5, seed=4)
    batch = {"src_embeds": _src(tcfg, 1, 4), "tokens": toks}
    with repro.use(backend="xla"):
        want, _ = japi.prefill(jparams, _j(batch), jcfg,
                               japi.init_cache(jcfg, 1, MAX_LEN, SRC_LEN),
                               logit_pos=4)
    with torch.inference_mode():
        got, _ = tapi.prefill(model, _t(batch), tcfg,
                              tapi.init_cache(tcfg, 1, MAX_LEN, SRC_LEN,
                                              device="cpu"), logit_pos=4)
    _close(got, want)


def test_launches_per_layer(seamless, monkeypatch):
    """The GEMMs and flash calls of each forward, derived from the code: an
    encoder layer 6 ``matmul`` (q, k, v, o, up, down) and one non-causal
    flash call; a decoder layer at prefill 10 (self q, k, v, o; cross q, k,
    v, o; up, down), a causal flash call and, for more than one query, a
    non-causal one over the memory; a later chunk 8 a layer (the cross K
    and V come from the cache) and the cross flash call only (its
    self-attention is mha_ref); a decode step 8 a layer and none; the head
    1."""
    _, tcfg, _, _, model = seamless
    calls = []
    real_mm, real_fl = brgemm.matmul, tattention.flash_attention

    def mm(x, w, *args, **kw):
        calls.append(("matmul", tuple(w.shape)))
        return real_mm(x, w, *args, **kw)

    def fl(q, k, v, **kw):
        calls.append(("flash", kw["causal"], q.shape[2], k.shape[2]))
        return real_fl(q, k, v, **kw)

    monkeypatch.setattr(brgemm, "matmul", mm)
    monkeypatch.setattr(tattention, "flash_attention", fl)
    L, E = tcfg.n_layers, tcfg.n_enc_layers

    def counted(fn):
        calls.clear()
        fn()
        return (sum(c[0] == "matmul" for c in calls),
                sorted(c[1:] for c in calls if c[0] == "flash"))

    with torch.inference_mode():
        for prompt in (6, 1):
            cache = tapi.init_cache(tcfg, 1, MAX_LEN, SRC_LEN, device="cpu")
            batch = {"src_embeds": torch.zeros(1, SRC_LEN, tcfg.d_model),
                     "tokens": torch.zeros(1, prompt, dtype=torch.long)}
            n, flash = counted(lambda: tapi.prefill(model, batch, tcfg,
                                                    cache))
            assert n == 6 * E + 10 * L + 1
            assert flash == sorted(
                [(False, SRC_LEN, SRC_LEN)] * E
                + [(True, prompt, prompt)] * L
                + ([(False, prompt, SRC_LEN)] * L if prompt > 1 else []))
        n, flash = counted(lambda: tapi.prefill_chunk(
            model, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, tcfg,
            cache, 1, first_chunk=False))
        assert n == 8 * L + 1
        assert flash == [(False, 4, SRC_LEN)] * L
        n, flash = counted(lambda: tapi.decode_step(
            model, torch.zeros(1, 1, dtype=torch.long), tcfg, cache, 5))
        assert (n, flash) == (8 * L + 1, [])


# ==========================================================================
# serving
# ==========================================================================

def test_engine_greedy_matches_reference(seamless):
    jcfg, tcfg, jparams, _, model = seamless
    batch = {"src_embeds": _src(tcfg, 2, 5), "tokens": _tokens(tcfg, 2, 6,
                                                               seed=5)}
    with repro.use(backend="xla"):
        want = JEngine(jcfg, jparams, JServeConfig(
            max_len=MAX_LEN, src_len=SRC_LEN)).generate(
                _j(batch), n_tokens=10, stop_tokens=())
    got = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN, src_len=SRC_LEN),
                 device="cpu").generate(_t(batch), n_tokens=10,
                                        stop_tokens=())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _requests(cfg, cls=Request):
    rng = np.random.default_rng(7)
    return [cls(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                max_tokens=m, stop_tokens=(),
                src_embeds=rng.standard_normal(
                    (SRC_LEN, cfg.d_model)).astype(np.float32))
            for n, m in zip(PROMPT_LENS, MAX_TOKENS)]


@pytest.fixture(scope="module")
def reference(seamless):
    """The reference engine's greedy tokens: its slotted pool, and its int8
    pages."""
    jcfg, tcfg, jparams, _, _ = seamless
    with repro.use(backend="xla"):
        return {name: JContinuousEngine(
            jcfg, jparams, JPoolConfig(n_slots=2, max_len=MAX_LEN,
                                       src_len=SRC_LEN, **kw)).serve(
                _requests(tcfg, JRequest))
            for name, kw in (("slotted", {}),
                             ("int8", {"page_size": 4, "kv_quant": "int8"}))}


def _serve(seamless, **pool):
    _, tcfg, _, _, model = seamless
    eng = ContinuousEngine(tcfg, model, PoolConfig(
        n_slots=2, max_len=MAX_LEN, src_len=SRC_LEN, **pool), device="cpu")
    return eng, eng.serve(_requests(tcfg))


def _drained(eng):
    pool = eng.pool
    assert pool.n_free == pool.n_slots
    assert pool.alloc_count == pool.free_count
    if eng.paged:
        assert pool.page_alloc_count == pool.page_free_count
        assert pool.n_free_pages == pool.n_pages


@pytest.mark.parametrize("pool", list(POOLS))
def test_continuous_greedy_matches_reference(seamless, reference, pool):
    """Five requests over two slots in every pool: the reference's slotted
    tokens, every pool empty after."""
    eng, out = _serve(seamless, **POOLS[pool])
    assert eng.paged == ("page_size" in POOLS[pool])
    assert out == reference["slotted"]
    _drained(eng)
    assert eng.pool.alloc_count > eng.pool.n_slots
    if pool == "chunked":
        assert eng.metrics.prefill_chunks > 0
    if pool == "preempting":
        assert eng.metrics.preemptions > 0


def test_int8_pages_leave_the_cross_leaves_unquantized(seamless, reference):
    eng, out = _serve(seamless, page_size=4, kv_quant="int8")
    data = eng.pool.data
    assert data["k"].dtype == data["v"].dtype == torch.int8
    assert data["cross.k"].dtype == data["cross.v"].dtype == torch.float32
    assert sorted(eng.pool.scales) == ["k", "v"]
    match = sum(out[k] == reference["int8"][k] for k in out)
    assert match >= len(out) - 1
    _drained(eng)


def test_paged_pool_keeps_the_cross_leaves_by_slot(seamless):
    """The paged pool holds the cross K and V (L, n_slots, Hkv, src_len,
    dh) beside its pages: ``insert`` writes them at the slot, a paged
    decode reads them as they are and leaves them, and ``kv_bytes``
    counts them."""
    _, tcfg, _, _, model = seamless
    pool = PagedKVCache(tcfg, 3, MAX_LEN, page_size=4, src_len=SRC_LEN,
                        device="cpu")
    h, dh = tcfg.n_kv_heads, tcfg.head_dim
    assert pool.data["cross.k"].shape == (2, 3, h, SRC_LEN, dh)
    assert pool.data["k"].shape == (2, 24, h, 4, dh)
    assert tapi.kv_shape(tcfg, 3, 99, "cross.v", SRC_LEN) == \
        (2, 3, h, SRC_LEN, dh)
    assert pool.kv_bytes() == 4 * (2 * 2 * 24 * h * 4 * dh
                                   + 2 * 2 * 3 * h * SRC_LEN * dh)
    with torch.inference_mode():
        rcache = pool.request_cache()
        logits, rcache = tapi.prefill(model, {
            "src_embeds": torch.from_numpy(_src(tcfg, 1, 8)),
            "tokens": torch.from_numpy(_tokens(tcfg, 1, 5, seed=8))},
            tcfg, rcache)
        assert pool.insert(1, rcache, 5)
        one = tapi.stack_layers(rcache)
        for key in encdec.CROSS_KEYS:
            assert torch.equal(pool.data[key][:, 1], one[key][:, 0])
            assert not pool.data[key][:, 0].any()
        before = {k: pool.data[k].clone() for k in encdec.CROSS_KEYS}
        pool.positions[1] = 5
        tapi.decode_step_paged(
            model, torch.tensor([[0], [int(logits.argmax())], [0]]), tcfg,
            pool.data, pool.page_tables, pool.positions, page_size=4)
        assert all(torch.equal(before[k], pool.data[k]) for k in before)
    slot = SlotKVCache(tcfg, 3, MAX_LEN, src_len=SRC_LEN, device="cpu")
    assert slot.leaves["cross.v"].shape == (2, 3, h, SRC_LEN, dh)
    assert slot.cache["blocks"][1]["cross.k"].shape == (3, h, SRC_LEN, dh)


def test_refusals(seamless):
    """A missing ``src_embeds`` or one of another length raises, as the
    reference's engine does (the static engine against its ServeConfig);
    ``Transformer`` refuses the config."""
    jcfg, tcfg, jparams, _, model = seamless
    prompt = _tokens(tcfg, 1, 4)[0].tolist()
    short = _src(tcfg, 1, src_len=SRC_LEN - 2)[0]
    for pool in ({}, {"page_size": 4, "prefill_chunk": 4}):
        for src, msg in ((None, "requires src_embeds"),
                         (short, f"src_embeds length {SRC_LEN - 2} != pool "
                                 f"src_len {SRC_LEN}")):
            cfg = PoolConfig(n_slots=2, max_len=MAX_LEN, src_len=SRC_LEN,
                             **pool)
            with repro.use(backend="xla"), pytest.raises(ValueError,
                                                         match=msg):
                JContinuousEngine(jcfg, jparams, JPoolConfig(
                    **dataclasses.asdict(cfg))).serve(
                    [JRequest(prompt=prompt, max_tokens=2, src_embeds=src)])
            eng = ContinuousEngine(tcfg, model, cfg, device="cpu")
            with pytest.raises(ValueError, match=msg):
                eng.serve([Request(prompt=prompt, max_tokens=2,
                                   src_embeds=src)])
    engine = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN,
                                             src_len=SRC_LEN), device="cpu")
    with pytest.raises(ValueError, match="requires src_embeds"):
        engine.generate({"tokens": torch.tensor([prompt])}, n_tokens=2)
    with pytest.raises(ValueError, match="!= ServeConfig src_len"):
        engine.generate({"tokens": torch.tensor([prompt]),
                         "src_embeds": torch.from_numpy(short[None])},
                        n_tokens=2)
    from repro_torch.models.transformer import Transformer
    with pytest.raises(ValueError, match="encoder-decoder"):
        Transformer(tcfg, device="cpu")


@pytest.mark.parametrize("tier", ["decode_int8", "quant_int8",
                                  "calibrated_int8", "calibrated_fp8"])
def test_quant_tiers_match_reference(seamless, tier):
    """The static engine's greedy tokens in each quant tier equal the
    reference's: a tier over full-precision weights, or weights calibrated
    by the reference (carried across by ``interop``, its stacked
    ``QuantizedTensor`` leaves sliced per layer) and by the port."""
    jcfg, tcfg, jparams, _, model = seamless
    batch = {"src_embeds": _src(tcfg, 2, 6), "tokens": _tokens(tcfg, 2, 7,
                                                               seed=6)}
    kind, fmt = tier.split("_")
    kw = {"decode_int8": {"decode_quant": fmt},
          "quant_int8": {"quant": fmt}}.get(tier, {})
    jp, ported = jparams, [model]
    if kind == "calibrated":
        jp = jquant.calibrate_params(jparams, fmt)
        ported = [interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                            tcfg, device="cpu"),
                  quant.calibrate_params(model, fmt)]
    with repro.use(backend="xla"):
        want = JEngine(jcfg, jp, JServeConfig(
            max_len=MAX_LEN, src_len=SRC_LEN), **kw).generate(
                _j(batch), n_tokens=10, stop_tokens=())
    for params in ported:
        got = Engine(tcfg, params, ServeConfig(max_len=MAX_LEN,
                                               src_len=SRC_LEN),
                     device="cpu", **kw).generate(_t(batch), n_tokens=10,
                                                  stop_tokens=())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pool", ["slotted", "chunked"])
def test_continuous_decode_int8_matches_reference(seamless, pool):
    """``decode_quant="int8"`` through the continuous engine: the
    reference's tokens on the same pool, every pool empty after."""
    jcfg, tcfg, jparams, _, model = seamless
    kw = POOLS[pool]
    with repro.use(backend="xla"):
        want = JContinuousEngine(jcfg, jparams, JPoolConfig(
            n_slots=2, max_len=MAX_LEN, src_len=SRC_LEN, **kw),
            decode_quant="int8").serve(_requests(tcfg, JRequest))
    eng = ContinuousEngine(tcfg, model, PoolConfig(
        n_slots=2, max_len=MAX_LEN, src_len=SRC_LEN, **kw), device="cpu",
        decode_quant="int8")
    assert eng.serve(_requests(tcfg)) == want
    _drained(eng)


# ==========================================================================
# data, interop, a ragged vocabulary
# ==========================================================================

@pytest.mark.parametrize("kind,seq", [("train", 16), ("prefill", 64)])
def test_pipeline_batches_match_reference(seamless, kind, seq):
    """The port's stream draws the reference's batches bit for bit, its
    ``src_embeds`` (seq / 2 frames in train, min(4096, seq / 8) in
    prefill) among them."""
    jcfg, tcfg, _, _, _ = seamless
    shape = dict(name="t", kind=kind, seq_len=seq, global_batch=2)
    pipe = tpipeline.TokenPipeline(tcfg, ShapeCfg(**shape), seed=5)
    jpipe = jpipeline.TokenPipeline(jcfg, JShapeCfg(**shape), seed=5)
    try:
        for _ in range(2):
            got, want = next(pipe), next(jpipe)
            assert sorted(got) == sorted(want) == ["labels", "src_embeds",
                                                   "tokens"]
            for key in got:
                np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    finally:
        pipe.close()
        jpipe.close()
    t_shape, j_shape = ShapeCfg(**shape), JShapeCfg(**shape)
    assert tapi.encdec_src_len(tcfg, t_shape) == \
        japi.encdec_src_len(jcfg, j_shape)
    assert tapi.token_len(tcfg, t_shape) == japi.token_len(jcfg, j_shape)
    assert got["src_embeds"].shape[1] == (seq // 2 if kind == "train"
                                          else seq // 8)


def test_params_round_trip(seamless):
    """``enc_blocks`` and ``dec_blocks`` (``self_attn``, ``ln_x``,
    ``cross_attn``), ``enc_ln``, ``final_ln`` and ``head.w`` carry across
    and back leaf for leaf, and the AdamW state too."""
    _, tcfg, _, tree, model = seamless
    back = interop.params_to_numpy(model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat[path], leaf)
    assert back["dec_blocks"]["cross_attn"]["wk"].shape == \
        (2, tcfg.d_model, tcfg.n_kv_heads * tcfg.head_dim)
    state = topt.adamw_init(dict(model.named_parameters()), topt.AdamWCfg())
    again = interop.opt_state_to_numpy(state)
    assert sorted(again) == ["m", "master", "step", "v"]
    np.testing.assert_array_equal(again["master"]["enc_ln"]["scale"],
                                  tree["enc_ln"]["scale"])


def test_init_params_draws_the_references_distributions():
    cfg = tconfigs.get(NAME).reduced()
    model = tapi.init_params(cfg, device="cpu")
    assert isinstance(model, encdec.EncDec)
    for name, p in model.named_parameters():
        p = p.detach()
        if name.endswith("scale"):
            assert bool((p == 1).all())
        elif name == "embed.table":
            assert abs(float(p.std()) - cfg.d_model ** -0.5) < 0.01
        else:
            assert abs(float(p.std()) - p.shape[-2] ** -0.5) < 0.02, name


def test_ragged_vocab_through_the_plain_path():
    """A vocabulary of 514 (no multiple of 8, as the full config's 256206):
    logits and greedy tokens against the reference."""
    jcfg = dataclasses.replace(jconfigs.get(NAME).reduced(), vocab=514)
    tcfg = dataclasses.replace(tconfigs.get(NAME).reduced(), vocab=514)
    jcfg, tcfg, jparams, _, model = _pair(jcfg, tcfg)
    assert model.head.w.shape == (tcfg.d_model, 514)
    batch = {"src_embeds": _src(tcfg, 2, 9), "tokens": _tokens(tcfg, 2, 5,
                                                               seed=9)}
    with repro.use(backend="xla"):
        want_logits, _ = japi.forward(jparams, _j(batch), jcfg)
        want = JEngine(jcfg, jparams, JServeConfig(
            max_len=MAX_LEN, src_len=SRC_LEN)).generate(
                _j(batch), n_tokens=8, stop_tokens=())
    with torch.no_grad():
        got_logits, _ = tapi.forward(model, _t(batch), tcfg)
    _close(got_logits, want_logits)
    got = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN, src_len=SRC_LEN),
                 device="cpu").generate(_t(batch), n_tokens=8,
                                        stop_tokens=())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

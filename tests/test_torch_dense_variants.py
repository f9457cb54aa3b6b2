"""The port's dense variants against the JAX package, on the CPU: the plain
GELU FFN (starcoder2-15b), the untied head (mistral-large-123b), the
sliding-window ring cache (starcoder2-15b), llava-next-34b's patch prefix
(its projection, the prefix's positions in both engines), and
deepseek-coder-33b as it is.

Each config is the reference's ``reduced()`` form (fp32; starcoder2's
window cut to 8), weights made by the reference from a fixed key and handed
over as numpy arrays.  Logits band: atol = rtol = 1e-4, fp32 on both sides,
as ``test_torch_serve.py`` (two frameworks' GEMM sum orders through a few
layers).  Greedy tokens must match exactly.  The reference runs under
``repro.use(backend="xla")``: its untied head drops a ``backend=`` argument
and takes the ambient one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import configs as jconfigs
from repro.layers import mlp as jmlp
from repro.models import api as japi
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro.serve import PoolConfig as JPoolConfig
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.layers import mlp
from repro_torch.models import api as tapi
from repro_torch.serve import (ContinuousEngine, Engine, PoolConfig, Request,
                               ServeConfig)

BAND = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 40
WINDOW = 8
# Requests of the continuous run: prompts shorter and longer than the
# window, so that at every step some slots decode before the ring wraps and
# some after it.
PROMPT_LENS = [3, 13, 6, 9, 2]
MAX_TOKENS = [9, 5, 7, 4, 12]


def _pair(name):
    jcfg = jconfigs.get(name).reduced()
    tcfg = tconfigs.get(name).reduced()
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree, interop.params_from_numpy(
        tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def starcoder():
    return _pair("starcoder2-15b")


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t)).astype(np.int32)


def _forward_matches(pair, b=2, t=11):
    jcfg, tcfg, jparams, _, model = pair
    toks = _tokens(tcfg, b, t)
    with repro.use(backend="xla"):
        want, _ = japi.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        got, _ = tapi.forward(model, {"tokens": torch.from_numpy(toks)},
                              tcfg)
    assert got.dtype == torch.float32 and got.shape == (b, t, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


# ==========================================================================
# the plain GELU FFN and the untied head
# ==========================================================================

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_plain_gelu_ffn_matches_reference(backend):
    rng = np.random.default_rng(5)
    p = jmlp.init(jax.random.PRNGKey(2), 32, 64, gated=False)
    assert sorted(p) == ["w_down", "w_up"]
    x = rng.normal(size=(3, 4, 32)).astype(np.float32)
    want = jmlp.apply(p, jnp.asarray(x), activation="gelu", backend=backend)
    got = mlp.apply(None, torch.tensor(np.asarray(p["w_up"])),
                    torch.tensor(np.asarray(p["w_down"])),
                    torch.from_numpy(x), activation="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    module = mlp.MLP(32, 64, gated=False, activation="gelu")
    assert sorted(n for n, _ in module.named_parameters()) == [
        "w_down", "w_up"]


def test_plain_ffn_launches_two_gemms(monkeypatch):
    """The plain MLP: the up GEMM with GELU in its epilogue, then down."""
    from repro_torch.core import brgemm
    acts = []
    real = brgemm.matmul

    def spy(x, w, *args, **kw):
        acts.append(kw.get("activation", "none"))
        return real(x, w, *args, **kw)

    monkeypatch.setattr(brgemm, "matmul", spy)
    mlp.apply(None, torch.ones(4, 8), torch.ones(8, 4), torch.ones(2, 4),
              activation="gelu")
    assert acts == ["gelu", "none"]


def test_starcoder2_forward_matches_reference(starcoder):
    """The plain GELU FFN and windowed flash attention (T > window)."""
    _, tcfg, _, _, model = starcoder
    assert tcfg.window == WINDOW and not tcfg.gated_mlp
    assert model.blocks[0].mlp.w_gate is None
    _forward_matches(starcoder, t=2 * WINDOW + 3)


def test_untied_head_matches_reference():
    pair = _pair("mistral-large-123b")
    jcfg, tcfg, jparams, tree, model = pair
    assert not tcfg.tie_embeddings
    names = dict(model.named_parameters())
    assert names["head.w"].shape == (tcfg.d_model, tcfg.vocab)
    np.testing.assert_array_equal(names["head.w"].detach().numpy(),
                                  tree["head"]["w"])
    _forward_matches(pair)
    back = interop.params_to_numpy(model)
    np.testing.assert_array_equal(back["head"]["w"], tree["head"]["w"])
    # prefill and decode read the same head
    toks = _tokens(tcfg, 2, 6)
    with repro.use(backend="xla"):
        jcache = japi.init_cache(jcfg, 2, 16)
        want, _ = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                               jcache)
    with torch.inference_mode():
        cache = tapi.init_cache(tcfg, 2, 16, device="cpu")
        got, _ = tapi.prefill(model, {"tokens": torch.from_numpy(toks)},
                              tcfg, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


def test_untied_head_init_and_plain_mlp_round_trip(starcoder):
    cfg = tconfigs.get("mistral-large-123b").reduced()
    model = tapi.init_params(cfg, device="cpu")
    w = dict(model.named_parameters())["head.w"].detach()
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.01
    _, _, _, tree, model = starcoder
    back = interop.params_to_numpy(model)
    assert "w_gate" not in back["blocks"]["mlp"] and "head" not in back
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(flat[path], leaf)


def test_deepseek_coder_forward_matches_reference():
    _forward_matches(_pair("deepseek-coder-33b"))


# ==========================================================================
# the sliding-window ring cache
# ==========================================================================

@pytest.mark.parametrize("prompt", [5, 13], ids=["short", "wrapped"])
def test_ring_prefill_and_decode_match_reference(starcoder, prompt):
    """The ring's contents after a prompt shorter / longer than the window,
    then the logits of 12 decode steps (positions past the wrap)."""
    jcfg, tcfg, jparams, _, model = starcoder
    toks = _tokens(tcfg, 2, prompt, seed=prompt)
    fed = _tokens(tcfg, 2, 12, seed=100 + prompt)
    with repro.use(backend="xla"):
        jcache = japi.init_cache(jcfg, 2, MAX_LEN)
        jl, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                  jcfg, jcache)
        want = [np.asarray(jl)]
        ring = jax.tree.map(np.asarray, jcache)
        for i in range(12):
            jl, jcache = japi.decode_step(
                jparams, jnp.asarray(fed[:, i:i + 1]), jcfg, jcache,
                prompt + i)
            want.append(np.asarray(jl))
    with torch.inference_mode():
        cache = tapi.init_cache(tcfg, 2, MAX_LEN, device="cpu")
        assert cache["blocks"][0]["k"].shape[2] == WINDOW
        logits, cache = tapi.prefill(model, {"tokens": torch.from_numpy(toks)},
                                     tcfg, cache)
        got = [logits.numpy()]
        for i, block in enumerate(cache["blocks"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(block[key].numpy(),
                                           ring["blocks"][key][i], **BAND)
        for i in range(12):
            logits, cache = tapi.decode_step(
                model, torch.from_numpy(fed[:, i:i + 1]), tcfg, cache,
                prompt + i)
            got.append(logits.numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **BAND)


def test_ring_decode_takes_per_row_positions(starcoder):
    """One batched decode with rows on both sides of the wrap equals each
    row decoded alone (the reference's vmap of a batch-1 decode)."""
    _, tcfg, _, _, model = starcoder
    lens = [3, 11]
    with torch.inference_mode():
        caches = []
        for n in lens:
            c = tapi.init_cache(tcfg, 1, MAX_LEN, device="cpu")
            tapi.prefill(model, {"tokens": torch.from_numpy(
                _tokens(tcfg, 1, n, seed=n))}, tcfg, c)
            caches.append(c)
        pool = {"blocks": [{key: torch.cat([c["blocks"][i][key]
                                            for c in caches])
                            for key in ("k", "v")}
                           for i in range(tcfg.n_layers)]}
        tok = torch.tensor([[7], [9]])
        for step in range(10):
            pos = torch.tensor([n + step for n in lens])
            both, pool = tapi.decode_step(model, tok, tcfg, pool, pos)
            for r, c in enumerate(caches):
                one, _ = tapi.decode_step(model, tok[r:r + 1], tcfg, c,
                                          lens[r] + step)
                np.testing.assert_allclose(both[r:r + 1].numpy(),
                                           one.numpy(), **BAND)
            tok = both.argmax(-1)[:, None]


@pytest.mark.parametrize("prompt", [5, 13], ids=["short", "wrapped"])
def test_engine_greedy_matches_reference(starcoder, prompt):
    jcfg, tcfg, jparams, _, model = starcoder
    toks = _tokens(tcfg, 2, prompt, seed=prompt)
    with repro.use(backend="xla"):
        want = JEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN)).generate(
            {"tokens": jnp.asarray(toks)}, n_tokens=12, stop_tokens=())
    got = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN),
                 device="cpu").generate({"tokens": torch.from_numpy(toks)},
                                        n_tokens=12, stop_tokens=())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_continuous_greedy_matches_reference(starcoder):
    """Three slots of a ring each; slots decode before and after their
    ring wraps in the same steps."""
    jcfg, tcfg, jparams, _, model = starcoder
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in PROMPT_LENS]
    with repro.use(backend="xla"):
        want = JContinuousEngine(
            jcfg, jparams, JPoolConfig(n_slots=3, max_len=MAX_LEN)).serve(
                [JRequest(prompt=p, max_tokens=m, stop_tokens=())
                 for p, m in zip(prompts, MAX_TOKENS)])
    ce = ContinuousEngine(tcfg, model, PoolConfig(n_slots=3, max_len=MAX_LEN),
                          device="cpu")
    assert not ce.paged
    assert ce.pool.leaves["k"].shape[3] == WINDOW
    got = ce.serve([Request(prompt=p, max_tokens=m, stop_tokens=())
                    for p, m in zip(prompts, MAX_TOKENS)])
    assert got == want
    assert ce.pool.n_free == ce.pool.n_slots
    assert ce.pool.alloc_count == ce.pool.free_count == len(PROMPT_LENS)


def test_windowed_refusals(starcoder):
    """Chunked and bucketed prefill raise for a windowed config, with the
    reference's messages; a page size leaves it on the slotted pool."""
    _, tcfg, _, _, model = starcoder
    assert not tapi.supports_paging(tcfg)
    for kw, msg in (({"prefill_chunk": 8}, "prefill_chunk is not supported"),
                    ({"prefill_bucket": 8}, "prefill_bucket is not "
                                            "supported")):
        with pytest.raises(ValueError, match=msg):
            ContinuousEngine(tcfg, model, PoolConfig(n_slots=2,
                                                     max_len=MAX_LEN, **kw),
                             device="cpu")
    ce = ContinuousEngine(tcfg, model, PoolConfig(
        n_slots=2, max_len=MAX_LEN, page_size=8), device="cpu")
    assert not ce.paged
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="ring cache"):
        cache = tapi.init_cache(tcfg, 1, MAX_LEN, device="cpu")
        tapi.prefill_chunk(model, {"tokens": torch.zeros(1, 4,
                                                         dtype=torch.long)},
                           tcfg, cache, 0)


def test_vlm_config_is_refused(llava):
    """What the reference refuses a VLM config the port refuses too:
    bucketed and chunked prefill raise, a page size leaves it on the
    slotted pool, and a request or batch without its patches raises.
    What it runs the port runs: with ``mla=True`` (MLA in the dense
    family) its loss is the reference's."""
    jcfg, tcfg, jparams, _, model = llava
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
    ce = ContinuousEngine(tcfg, model, PoolConfig(
        n_slots=2, max_len=MAX_LEN, page_size=8), device="cpu")
    assert not ce.paged
    with pytest.raises(ValueError, match="patch_embeds"):
        ce.serve([Request(prompt=[1, 2], max_tokens=2, stop_tokens=())])
    # the prefix counts against the pool's positions, as the reference's
    with pytest.raises(ValueError, match="max_len"):
        ce.submit(Request(prompt=[1] * (MAX_LEN - 4 - 3), max_tokens=4))
    with pytest.raises(ValueError, match="patch_embeds"):
        tapi.forward(model, {"tokens": torch.zeros(1, 3, dtype=torch.long)},
                     tcfg)
    jm, tm = (dataclasses.replace(c, mla=True).reduced()
              for c in (jconfigs.get("llava-next-34b"),
                        tconfigs.get("llava-next-34b")))
    jp = japi.init_params(jax.random.PRNGKey(3), jm)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jm.vocab, (2, 9)).astype(np.int32)
    pe = rng.standard_normal((2, jm.n_patches, jm.d_model)).astype(np.float32)
    with repro.use(backend="xla"):
        want, _ = japi.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                    "patch_embeds": jnp.asarray(pe),
                                    "labels": jnp.asarray(toks)}, jm)
    mla = interop.params_from_numpy(jax.tree.map(np.asarray, jp), tm,
                                    device="cpu")
    with torch.no_grad():
        got, _ = tapi.loss_fn(mla, {"tokens": torch.from_numpy(toks),
                                    "patch_embeds": torch.from_numpy(pe),
                                    "labels": torch.from_numpy(toks)}, tm)
    np.testing.assert_allclose(float(got), float(want), **BAND)


# ==========================================================================
# llava-next-34b: the patch prefix
# ==========================================================================

N_PATCHES = 4      # llava's reduced() form


@pytest.fixture(scope="module")
def llava():
    return _pair("llava-next-34b")


def _patches(cfg, b, seed=0):
    return np.random.default_rng(100 + seed).standard_normal(
        (b, cfg.n_patches, cfg.d_model)).astype(np.float32)


def test_llava_config_is_the_references():
    jcfg, tcfg = jconfigs.get("llava-next-34b"), tconfigs.get(
        "llava-next-34b")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.reduced().n_patches == N_PATCHES
    assert tcfg.param_counts() == jcfg.param_counts()


def test_llava_forward_and_loss_match_reference(llava):
    """The projected patches prepended, their rows dropped before the head:
    logits (B, T, V) and the loss against the reference's."""
    jcfg, tcfg, jparams, _, model = llava
    toks, labels = _tokens(tcfg, 2, 11), _tokens(tcfg, 2, 11, seed=1)
    labels[0, :3] = -1
    pe = _patches(tcfg, 2)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "patch_embeds": jnp.asarray(pe)}
    tbatch = {k: torch.from_numpy(v) for k, v in
              (("tokens", toks), ("labels", labels), ("patch_embeds", pe))}
    with repro.use(backend="xla"):
        want, _ = japi.forward(jparams, jbatch, jcfg)
        want_loss, _ = japi.loss_fn(jparams, jbatch, jcfg)
    with torch.no_grad():
        got, _ = tapi.forward(model, tbatch, tcfg)
        got_loss, _ = tapi.loss_fn(model, tbatch, tcfg)
    assert got.shape == (2, 11, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **BAND)


def test_llava_patch_projection_fuses_gelu_and_bias(llava, monkeypatch):
    """The projection is two matmul calls, the first with its bias and GELU
    in the epilogue, the second with its bias."""
    from repro_torch.core import brgemm
    _, tcfg, _, _, model = llava
    calls = []
    real = brgemm.matmul

    def spy(x, w, bias=None, *a, **kw):
        calls.append((tuple(x.shape), bias is not None,
                      kw.get("activation", "none")))
        return real(x, w, bias, *a, **kw)

    monkeypatch.setattr(brgemm, "matmul", spy)
    with torch.no_grad():
        model.vision_proj(torch.from_numpy(_patches(tcfg, 2)))
    assert calls == [((2, N_PATCHES, tcfg.d_model), True, "gelu"),
                     ((2, N_PATCHES, tcfg.d_model), True, "none")]


def test_llava_params_round_trip(llava):
    _, tcfg, _, tree, model = llava
    back = interop.params_to_numpy(model)
    assert sorted(back["vision_proj"]) == ["b1", "b2", "w1", "w2"]
    for key, arr in tree["vision_proj"].items():
        np.testing.assert_array_equal(back["vision_proj"][key], arr)
    fresh = tapi.init_params(tcfg, device="cpu")
    assert not fresh.vision_proj.b1.any() and not fresh.vision_proj.b2.any()
    assert fresh.vision_proj.w1.std() > 0


@pytest.mark.parametrize("prompt", [1, 6])
def test_llava_engine_greedy_matches_reference(llava, prompt):
    """Positions start past the prefix; prefill's logits are the last
    token's."""
    jcfg, tcfg, jparams, _, model = llava
    toks, pe = _tokens(tcfg, 2, prompt, seed=prompt), _patches(tcfg, 2)
    with repro.use(backend="xla"):
        want = JEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN)).generate(
            {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)},
            n_tokens=12, stop_tokens=())
    got = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN),
                 device="cpu").generate(
        {"tokens": torch.from_numpy(toks), "patch_embeds":
         torch.from_numpy(pe)}, n_tokens=12, stop_tokens=())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_llava_continuous_greedy_matches_reference(llava):
    """Three slots of the slotted pool, each request with its own patch
    prefix (with and without the batch axis)."""
    jcfg, tcfg, jparams, _, model = llava
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in PROMPT_LENS]
    pes = [_patches(tcfg, 1, seed=i)[0 if i % 2 else slice(None)]
           for i in range(len(PROMPT_LENS))]
    with repro.use(backend="xla"):
        want = JContinuousEngine(
            jcfg, jparams, JPoolConfig(n_slots=3, max_len=MAX_LEN)).serve(
                [JRequest(prompt=p, max_tokens=m, stop_tokens=(),
                          patch_embeds=pe)
                 for p, m, pe in zip(prompts, MAX_TOKENS, pes)])
    ce = ContinuousEngine(tcfg, model, PoolConfig(n_slots=3, max_len=MAX_LEN),
                          device="cpu")
    got = ce.serve([Request(prompt=p, max_tokens=m, stop_tokens=(),
                            patch_embeds=pe)
                    for p, m, pe in zip(prompts, MAX_TOKENS, pes)])
    assert got == want
    assert not ce.paged and ce.pool.n_free == ce.pool.n_slots


def test_llava_token_pipeline_matches_reference():
    """The synthetic stream's batches, patch_embeds drawn after the tokens
    as the reference draws them, and token_len less the prefix."""
    from repro.configs.shapes import ShapeCfg as JShapeCfg
    from repro.data.pipeline import TokenPipeline as JTokenPipeline
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.data.pipeline import TokenPipeline
    jcfg = jconfigs.get("llava-next-34b").reduced()
    tcfg = tconfigs.get("llava-next-34b").reduced()
    shape = ShapeCfg("vlm", "train", 16, 4)
    assert tapi.token_len(tcfg, shape) == japi.token_len(
        jcfg, JShapeCfg("vlm", "train", 16, 4)) == 16 - N_PATCHES
    jp = JTokenPipeline(jcfg, JShapeCfg("vlm", "train", 16, 4), seed=3)
    tp = TokenPipeline(tcfg, shape, seed=3)
    try:
        for _ in range(2):
            want, got = next(jp), next(tp)
            assert sorted(got) == sorted(want) == ["labels", "patch_embeds",
                                                   "tokens"]
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
    finally:
        jp.close()
        tp.close()


def test_calibrated_untied_head_carries_across():
    """A calibrated reference tree's untied head (int8 storage and
    per-channel scales) crosses as the port's QuantizedTensor, its bits
    unchanged, beside the plain MLP's calibrated weights."""
    from repro.core import quantize as JQ
    from repro_torch import quant
    _, tcfg, jparams, _, _ = _pair("mistral-large-123b")
    jcal = JQ.calibrate_params(jparams, "int8")
    model = interop.params_from_numpy(jax.tree.map(np.asarray, jcal), tcfg,
                                      device="cpu")
    head = model.head.w
    assert isinstance(head, quant.QuantizedTensor)
    np.testing.assert_array_equal(head.q.numpy(),
                                  np.asarray(jcal["head"]["w"].q))
    np.testing.assert_array_equal(head.scale.numpy(),
                                  np.asarray(jcal["head"]["w"].scale))
    own = quant.calibrate_params(
        interop.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu"), "int8")
    assert own.head.w.q.equal(head.q)

"""The port's multi-head latent attention (MLA) and deepseek-v3-671b against
the JAX package, on the CPU.

The reduced config (fp32; q/k heads of 16 nope + 8 rope = 24, v heads of
16, kv_lora 16, q_lora 32; 1 dense then 2 MoE layers; the MTP block),
weights made by the reference from a fixed key and handed over as numpy
arrays.  The reference runs under ``repro.use(backend="xla")``.  Band: atol
= rtol = 1e-4 (fp32 both sides, two frameworks' sum orders), as
``test_torch_dense_variants.py``; greedy tokens exactly.  The flash
forward's head-size pairs and its zero padding of a pair it has no
instantiation for are held on the CPU through the plain ``mha_ref``; the
kernel itself is held on the card (``test_torch_gpu.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import configs as jconfigs
from repro.kernels.flash_attention.ref import mha_ref as jmha_ref
from repro.layers import attention as jattn
from repro.models import api as japi
from repro.models import blocks as jblocks
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro.serve import PoolConfig as JPoolConfig
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import mha_ref
from repro_torch.layers import attention
from repro_torch.models import api as tapi
from repro_torch.models import blocks
from repro_torch.serve import (ContinuousEngine, Engine, PagedKVCache,
                               PoolConfig, Request, ServeConfig)

BAND = dict(atol=1e-4, rtol=1e-4)
NAME = "deepseek-v3-671b"
MAX_LEN = 40
PROMPT_LENS = [19, 4, 26, 1, 12]
MAX_TOKENS = [5, 8, 4, 7, 6]
POOLS = {
    "slotted": {},
    "paged": {"page_size": 8},
    "chunked": {"page_size": 4, "prefill_chunk": 8},
}


@pytest.fixture(scope="module")
def deepseek():
    jcfg = jconfigs.get(NAME).reduced()
    tcfg = tconfigs.get(NAME).reduced()
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree, interop.params_from_numpy(
        tree, tcfg, device="cpu")


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t)).astype(np.int32)


# ==========================================================================
# flash attention at head-size pairs
# ==========================================================================

def _qkv(rng, b, hq, hkv, t, d, dv):
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return r(b, hq, t, d), r(b, hkv, t, d), r(b, hkv, t, dv)


def test_mha_ref_takes_a_separate_v_head_size():
    """q / k of 24 against v of 16 under an explicit scale: the
    reference's oracle, with MLA's causal mask."""
    q, k, v = _qkv(np.random.default_rng(0), 2, 4, 2, 9, 24, 16)
    want = jmha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, scale=0.2)
    got = mha_ref(*map(torch.from_numpy, (q, k, v)), causal=True, scale=0.2)
    assert got.shape == (2, 4, 9, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


@pytest.mark.parametrize("d,dv,want", [
    (24, 16, (32, 32)), (32, 32, (32, 32)), (64, 64, (64, 64)),
    (100, 100, (128, 128)), (192, 128, (192, 128)), (160, 96, (192, 128))])
def test_flash_head_dims_pick_the_first_pair_that_holds(d, dv, want):
    assert FK.head_dims(d, dv) == want


def test_flash_head_dims_refuse_a_pair_too_wide():
    with pytest.raises(ValueError, match="fit no instantiation"):
        FK.head_dims(264, 128)


def test_zero_padding_leaves_attention_unchanged():
    """The wrapper's padding of (24, 16) up to (32, 32): zero q / k columns
    add nothing to a score, zero v columns give zero outputs sliced off;
    the scale is the unpadded size's."""
    q, k, v = map(torch.from_numpy, _qkv(np.random.default_rng(1), 2, 4, 2,
                                         11, 24, 16))
    qp, kp, vp = FK._padded(q, k, v)
    assert (qp.shape[-1], kp.shape[-1], vp.shape[-1]) == (32, 32, 32)
    assert not qp[..., 24:].any() and not vp[..., 16:].any()
    want = mha_ref(q, k, v, causal=True, scale=24 ** -0.5)
    got = mha_ref(qp, kp, vp, causal=True, scale=24 ** -0.5)
    np.testing.assert_array_equal(got[..., 16:].numpy(), 0.0)
    np.testing.assert_allclose(got[..., :16].numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    q, k, v = _qkv(np.random.default_rng(2), 1, 2, 1, 5, 192, 128)
    assert FK._padded(*map(torch.from_numpy, (q, k, v)))[2].shape[-1] == 128


# ==========================================================================
# MLA attention
# ==========================================================================

def _attention(deepseek):
    jcfg, tcfg, jparams, tree, _ = deepseek
    acfg = blocks.attn_cfg(tcfg)
    jacfg = jblocks.attn_cfg(jcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["dense_blocks"]["attn"])
    layer = attention.MLAttention(acfg)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            node = jp
            for key in name.split("."):
                node = node[key]
            p.copy_(torch.tensor(np.asarray(node)))
    return jacfg, acfg, jp, layer


def test_mla_train_and_prefill_match_reference(deepseek):
    jacfg, acfg, jp, layer = _attention(deepseek)
    x = np.random.default_rng(3).standard_normal(
        (2, 13, acfg.d_model)).astype(np.float32)
    with repro.use(backend="xla"):
        want = jattn.apply(jp, jnp.asarray(x), jacfg, mode="train")
        jcache = jattn.init_cache(jacfg, 2, MAX_LEN)
        wy, jcache = jattn.apply(jp, jnp.asarray(x), jacfg, mode="prefill",
                                 cache=jcache)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), mode="train")
        cache = attention.init_cache(acfg, 2, MAX_LEN)
        assert sorted(cache) == ["c_kv", "k_rope"]
        assert cache["c_kv"].shape == (2, MAX_LEN, acfg.kv_lora_rank)
        y, cache = layer(torch.from_numpy(x), mode="prefill", cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **BAND)
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **BAND)


def test_mla_chunk_and_decode_match_reference(deepseek):
    """Chunks of a prompt through the absorbed form, then decode steps, each
    against the reference; the decode at a (B,) tensor of one position."""
    jacfg, acfg, jp, layer = _attention(deepseek)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 15, acfg.d_model)).astype(np.float32)
    steps = rng.standard_normal((2, 4, acfg.d_model)).astype(np.float32)
    with repro.use(backend="xla"):
        jcache = jattn.init_cache(jacfg, 2, MAX_LEN)
        want = []
        for p0, p1 in ((0, 8), (8, 15)):
            y, jcache = jattn.apply(jp, jnp.asarray(x[:, p0:p1]), jacfg,
                                    mode="prefill_chunk", cache=jcache,
                                    pos=p0)
            want.append(np.asarray(y))
        for i in range(4):
            y, jcache = jattn.apply(jp, jnp.asarray(steps[:, i:i + 1]),
                                    jacfg, mode="decode", cache=jcache,
                                    pos=15 + i)
            want.append(np.asarray(y))
    with torch.no_grad():
        cache = attention.init_cache(acfg, 2, MAX_LEN)
        got = []
        for p0, p1 in ((0, 8), (8, 15)):
            y, cache = layer(torch.from_numpy(x[:, p0:p1]),
                             mode="prefill_chunk", cache=cache, pos=p0)
            got.append(y.numpy())
        for i in range(4):
            y, cache = layer(torch.from_numpy(steps[:, i:i + 1]),
                             mode="decode", cache=cache,
                             pos=torch.full((2,), 15 + i))
            got.append(y.numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **BAND)
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **BAND)


def test_mla_decode_takes_per_row_positions(deepseek):
    """One batched decode with each row at its own position equals each row
    decoded alone at batch 1 (the reference's vmap over slots)."""
    _, acfg, _, layer = _attention(deepseek)
    rng = np.random.default_rng(5)
    lens = [3, 11, 7]
    with torch.no_grad():
        caches = []
        for n in lens:
            c = attention.init_cache(acfg, 1, MAX_LEN)
            layer(torch.from_numpy(rng.standard_normal(
                (1, n, acfg.d_model)).astype(np.float32)), mode="prefill",
                cache=c)
            caches.append(c)
        pool = {key: torch.cat([c[key] for c in caches]) for key in caches[0]}
        x = torch.from_numpy(rng.standard_normal(
            (3, 1, acfg.d_model)).astype(np.float32))
        both, pool = layer(x, mode="decode", cache=pool,
                           pos=torch.tensor(lens))
        for r, c in enumerate(caches):
            one, c = layer(x[r:r + 1], mode="decode", cache=c,
                           pos=torch.tensor([lens[r]]))
            np.testing.assert_allclose(both[r:r + 1].numpy(), one.numpy(),
                                       **BAND)
            for key in c:
                np.testing.assert_allclose(pool[key][r].numpy(),
                                           c[key][0].numpy(), **BAND)


# ==========================================================================
# deepseek-v3-671b, reduced
# ==========================================================================

def test_deepseek_config_is_the_references():
    jcfg, tcfg = jconfigs.get(NAME), tconfigs.get(NAME)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert tcfg.param_counts() == jcfg.param_counts()


def test_deepseek_layout(deepseek):
    """1 dense MLA block, then MoE MLA blocks with the shared expert, the
    MTP block, the untied head."""
    _, tcfg, _, _, model = deepseek
    assert tcfg.n_dense_layers == 1 and tcfg.n_layers == 3 and tcfg.mtp
    assert hasattr(model.blocks[0], "mlp") and not hasattr(model.blocks[0],
                                                           "moe")
    for blk in model.blocks[1:]:
        assert blk.moe.shared is not None and not hasattr(blk, "mlp")
    assert isinstance(model.mtp_block.attn, attention.MLAttention)
    assert model.head is not None


def test_deepseek_forward_and_loss_match_reference(deepseek):
    """Logits, the MoE aux, the MTP logits, and the loss with its MTP and
    balance terms."""
    jcfg, tcfg, jparams, _, model = deepseek
    toks, labels = _tokens(tcfg, 2, 17), _tokens(tcfg, 2, 17, seed=1)
    labels[0, 10:] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    with repro.use(backend="xla"):
        want, waux = japi.forward(jparams, jb, jcfg)
        wloss, wmetrics = japi.loss_fn(jparams, jb, jcfg)
    with torch.no_grad():
        got, aux = tapi.forward(model, tb, tcfg)
        loss, metrics = tapi.loss_fn(model, tb, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    assert sorted(aux) == sorted(waux)
    np.testing.assert_allclose(aux["mtp_logits"].numpy(),
                               np.asarray(waux["mtp_logits"]), **BAND)
    for key in ("load_balance_loss", "router_z_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(aux[key]), float(waux[key]), **BAND)
    assert sorted(metrics) == sorted(wmetrics) == [
        "ce_loss", "load_balance_loss", "loss", "mtp_loss"]
    for key in wmetrics:
        np.testing.assert_allclose(float(metrics[key]), float(wmetrics[key]),
                                   **BAND)


@pytest.mark.parametrize("prompt", [1, 14])
def test_deepseek_engine_greedy_matches_reference(deepseek, prompt):
    jcfg, tcfg, jparams, _, model = deepseek
    toks = _tokens(tcfg, 2, prompt, seed=prompt)
    with repro.use(backend="xla"):
        want = JEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN)).generate(
            {"tokens": jnp.asarray(toks)}, n_tokens=10, stop_tokens=())
    got = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN),
                 device="cpu").generate({"tokens": torch.from_numpy(toks)},
                                        n_tokens=10, stop_tokens=())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _requests(cfg, cls):
    rng = np.random.default_rng(1)
    return [cls(prompt=rng.integers(0, cfg.vocab, n).tolist(), max_tokens=m,
                stop_tokens=()) for n, m in zip(PROMPT_LENS, MAX_TOKENS)]


@pytest.fixture(scope="module")
def deepseek_reference(deepseek):
    jcfg, tcfg, jparams, _, _ = deepseek
    with repro.use(backend="xla"):
        return {name: JContinuousEngine(
            jcfg, jparams, JPoolConfig(n_slots=3, max_len=MAX_LEN,
                                       **kw)).serve(
                _requests(tcfg, JRequest))
            for name, kw in POOLS.items()}


@pytest.mark.parametrize("pool", list(POOLS))
def test_deepseek_continuous_greedy_matches_reference(deepseek,
                                                      deepseek_reference,
                                                      pool):
    """Three slots, five requests (capacity binds at the longer prompts'
    prefill); the pool's leaves are MLA's compressed ones."""
    _, tcfg, _, _, model = deepseek
    ce = ContinuousEngine(tcfg, model, PoolConfig(n_slots=3, max_len=MAX_LEN,
                                                  **POOLS[pool]),
                          device="cpu")
    assert ce.paged == (pool != "slotted")
    leaves = ce.pool.data if ce.paged else ce.pool.leaves
    assert sorted(leaves) == ["c_kv", "k_rope"]
    got = ce.serve(_requests(tcfg, Request))
    assert got == deepseek_reference[pool]
    assert ce.pool.n_free == ce.pool.n_slots
    if ce.paged:
        assert ce.pool.page_alloc_count == ce.pool.page_free_count
    n_pos = ce.pool.page_size if ce.paged else MAX_LEN
    n = ce.pool.n_pages if ce.paged else 3
    want = tcfg.n_layers * n * n_pos * (tcfg.kv_lora_rank
                                        + tcfg.qk_rope_dim) * 4
    assert ce.pool.kv_bytes() == want


def test_deepseek_pool_views_and_pages(deepseek):
    """Stacked MLA leaves and their per-layer views; pages to views and
    back without a head axis."""
    _, tcfg, _, _, _ = deepseek
    shape = tapi.kv_shape(tcfg, 3, 16, "c_kv")
    assert shape == (3, 3, 16, tcfg.kv_lora_rank)
    assert tapi.kv_shape(tcfg, 3, 16, "k_rope")[-1] == tcfg.qk_rope_dim
    leaves = {k: torch.randn(tapi.kv_shape(tcfg, 3, 16, k))
              for k in tapi.cache_keys(tcfg)}
    views = tapi.layer_views(leaves)
    assert len(views["blocks"]) == 3
    assert views["blocks"][1]["c_kv"].data_ptr() == leaves["c_kv"][1].data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(
        tapi.stack_layers(views).values(), leaves.values()))
    view = leaves["k_rope"].flatten(0, 1)         # (L * N, T, c)
    pages = tapi.view_to_pages(view, 4)
    assert pages.shape == (9, 4, 4, tcfg.qk_rope_dim)
    assert torch.equal(tapi.pages_to_view(pages), view)


def test_deepseek_params_round_trip(deepseek):
    """dense_blocks then moe_blocks as blocks.0 ..; the MTP block; every
    leaf back bit for bit."""
    _, tcfg, _, tree, model = deepseek
    assert sorted(tree) == ["dense_blocks", "embed", "final_ln", "head",
                            "moe_blocks", "mtp_block"]
    assert sorted(tree["moe_blocks"]["moe"]) == ["router", "shared",
                                                 "w_down", "w_gate", "w_up"]
    assert sorted(tree["moe_blocks"]["attn"]) == [
        "kv_norm", "q_norm", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    back = interop.params_to_numpy(model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat[path], leaf)
    names = dict(model.named_parameters())
    np.testing.assert_array_equal(
        names["blocks.2.moe.shared.w_up"].detach().numpy(),
        tree["moe_blocks"]["moe"]["shared"]["w_up"][1])


def test_deepseek_opt_state_round_trip(deepseek):
    from repro.train import optimizer as jopt
    jcfg, tcfg, jparams, _, _ = deepseek
    state = jax.tree.map(np.asarray, jopt.adamw_init(jparams,
                                                     jopt.AdamWCfg()))
    ported = interop.opt_state_from_numpy(state, tcfg, "cpu")
    assert "mtp_block.attn.wkv_b" in ported["m"]
    back = interop.opt_state_to_numpy(ported)
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_leaves_with_path(back))[path], leaf)


@pytest.mark.parametrize("name", ["grok-1-314b", NAME])
def test_pipeline_takes_the_moe_configs(name):
    """The synthetic stream's batches for both configs, the reference's."""
    from repro.configs.shapes import ShapeCfg as JShapeCfg
    from repro.data.pipeline import TokenPipeline as JTokenPipeline
    cfg, jcfg = tconfigs.get(name).reduced(), jconfigs.get(name).reduced()
    pipe = TokenPipeline(cfg, ShapeCfg("t", "train", 16, 2))
    jpipe = JTokenPipeline(jcfg, JShapeCfg("t", "train", 16, 2))
    try:
        for _ in range(2):
            got, want = next(pipe), next(jpipe)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for key in got:
                np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    finally:
        pipe.close()
        jpipe.close()


def test_mla_refusals(deepseek):
    """MLA in the encoder-decoder is still refused: the reference fails on
    it (its decoder layers read ``wq``: ``KeyError: 'wq'`` in ``loss_fn``
    and ``prefill``).  MLA in the dense family runs (the tests below), and
    int8 pages of the compressed cache and the quant tiers do: the pool
    keeps a scale a page for each stack (deepseek's dense and MoE layers)
    and key, and an engine serves a tier on them (both held against the
    reference in ``test_torch_quant_families.py``)."""
    _, tcfg, _, _, model = deepseek
    pool = PagedKVCache(tcfg, 2, MAX_LEN, page_size=8, kv_quant="int8",
                        device="cpu")
    assert sorted(pool.scales) == ["dense_blocks.c_kv",
                                   "dense_blocks.k_rope", "moe_blocks.c_kv",
                                   "moe_blocks.k_rope"]
    assert all(t.dtype == torch.int8 for t in pool.data.values())
    ce = ContinuousEngine(tcfg, model, PoolConfig(n_slots=2, max_len=MAX_LEN,
                                                  page_size=8,
                                                  kv_quant="int8"),
                          device="cpu", decode_quant="int8")
    got = ce.serve([Request(prompt=[3, 1, 4, 1, 5], max_tokens=4,
                            stop_tokens=())])
    assert len(got[0]) == 4 and ce.pool.n_free == ce.pool.n_slots
    seamless = tconfigs.get("seamless-m4t-large-v2")
    blocks.check_ported(seamless)
    with pytest.raises(NotImplementedError, match="KeyError: 'wq'"):
        blocks.check_ported(dataclasses.replace(seamless, mla=True))


# ==========================================================================
# MLA in the dense family: smollm-135m with mla=True, reduced
# ==========================================================================

@pytest.fixture(scope="module")
def dense_mla():
    jcfg = dataclasses.replace(jconfigs.get("smollm-135m"), mla=True).reduced()
    tcfg = dataclasses.replace(tconfigs.get("smollm-135m"), mla=True).reduced()
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree, interop.params_from_numpy(
        tree, tcfg, device="cpu")


def test_dense_mla_layout_and_round_trip(dense_mla):
    """The reference's dense tree (``blocks``, not mla_moe's two stacks):
    MLA attention and a gated MLP a layer, every leaf back bit for bit,
    the AdamW state too."""
    from repro.train import optimizer as jopt
    _, tcfg, jparams, tree, model = dense_mla
    assert sorted(tree) == ["blocks", "embed", "final_ln"]
    assert all(isinstance(b.attn, attention.MLAttention) and
               hasattr(b, "mlp") for b in model.blocks)
    back = interop.params_to_numpy(model)
    assert sorted(back) == sorted(tree)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat[path], leaf)
    state = jax.tree.map(np.asarray, jopt.adamw_init(jparams,
                                                     jopt.AdamWCfg()))
    ported = interop.opt_state_from_numpy(state, tcfg, "cpu")
    for again in (interop.opt_state_to_numpy(ported, tcfg),
                  interop.opt_state_to_numpy(ported)):
        flat = dict(jax.tree_util.tree_leaves_with_path(again))
        for path, leaf in jax.tree_util.tree_leaves_with_path(state):
            np.testing.assert_array_equal(flat[path], leaf)


def test_dense_mla_forward_and_loss_match_reference(dense_mla):
    jcfg, tcfg, jparams, _, model = dense_mla
    toks, labels = _tokens(tcfg, 2, 17), _tokens(tcfg, 2, 17, seed=1)
    labels[0, 10:] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    with repro.use(backend="xla"):
        want, _ = japi.forward(jparams, jb, jcfg)
        wloss, wmetrics = japi.loss_fn(jparams, jb, jcfg)
    with torch.no_grad():
        got, _ = tapi.forward(model, tb, tcfg)
        loss, metrics = tapi.loss_fn(model, tb, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    assert sorted(metrics) == sorted(wmetrics)
    for key in wmetrics:
        np.testing.assert_allclose(float(metrics[key]), float(wmetrics[key]),
                                   **BAND)


@pytest.mark.parametrize("prompt", [1, 14])
def test_dense_mla_engine_greedy_matches_reference(dense_mla, prompt):
    jcfg, tcfg, jparams, _, model = dense_mla
    toks = _tokens(tcfg, 2, prompt, seed=prompt)
    with repro.use(backend="xla"):
        want = JEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN)).generate(
            {"tokens": jnp.asarray(toks)}, n_tokens=10, stop_tokens=())
    got = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN),
                 device="cpu").generate({"tokens": torch.from_numpy(toks)},
                                        n_tokens=10, stop_tokens=())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


DENSE_POOLS = {**POOLS, "int8_pages": {"page_size": 8, "kv_quant": "int8"}}


@pytest.fixture(scope="module")
def dense_mla_reference(dense_mla):
    jcfg, tcfg, jparams, _, _ = dense_mla
    with repro.use(backend="xla"):
        return {name: JContinuousEngine(
            jcfg, jparams, JPoolConfig(n_slots=3, max_len=MAX_LEN,
                                       **kw)).serve(
                _requests(tcfg, JRequest))
            for name, kw in DENSE_POOLS.items()}


@pytest.mark.parametrize("pool", list(DENSE_POOLS))
def test_dense_mla_continuous_greedy_matches_reference(
        dense_mla, dense_mla_reference, pool):
    """Slotted, paged, chunked and int8 pages: MLA's compressed leaves,
    under int8 pages one scale a page for each key over all L layers
    (the reference's one ``blocks`` stack)."""
    _, tcfg, _, _, model = dense_mla
    ce = ContinuousEngine(tcfg, model, PoolConfig(
        n_slots=3, max_len=MAX_LEN, **DENSE_POOLS[pool]), device="cpu")
    leaves = ce.pool.data if ce.paged else ce.pool.leaves
    assert sorted(leaves) == ["c_kv", "k_rope"]
    if pool == "int8_pages":
        assert sorted(ce.pool.scales) == ["c_kv", "k_rope"]
        assert tapi.scale_stacks(tcfg, "c_kv") == (("c_kv", 0,
                                                    tcfg.n_layers),)
    assert ce.serve(_requests(tcfg, Request)) == dense_mla_reference[pool]
    assert ce.pool.n_free == ce.pool.n_slots

"""The port's dense LM and ``Engine`` against the JAX package, end to end.

Reduced smollm-135m (2 layers, d_model 128, fp32), weights made by the
reference from a fixed key and handed over as numpy arrays.  Logits band:
atol = rtol = 1e-4, fp32 on both sides; it covers two frameworks' GEMM sum
orders through 2 layers and their rope/rsqrt ulps (the observed spread is
~3e-6).  Greedy tokens must match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import api as tapi
from repro_torch.serve import Engine, ServeConfig

BAND = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 32


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get("smollm-135m").reduced()
    tcfg = tconfigs.get("smollm-135m").reduced()
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = interop.params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tree, model


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t)).astype(np.int32)


def test_configs_match_reference():
    for name in tconfigs.ARCH_NAMES:
        j, t = jconfigs.get(name), tconfigs.get(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(
            t.reduced())
        assert j.param_counts() == t.param_counts()


def test_interop_round_trip(pair):
    _, tcfg, _, tree, model = pair
    back = interop.params_to_numpy(model)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    bf16 = interop.params_from_numpy(tree, tcfg, device="cpu",
                                     dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf16.parameters())


def test_forward_logits(pair):
    jcfg, tcfg, jparams, _, model = pair
    toks = _tokens(tcfg, 2, 9)
    want, _ = japi.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                           backend="xla")
    with torch.no_grad():
        got, aux = tapi.forward(model, {"tokens": torch.from_numpy(toks)},
                                tcfg)
    assert got.dtype == torch.float32 and aux["load_balance_loss"] == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


def test_prefill_logits_cache_and_decode_step(pair):
    jcfg, tcfg, jparams, _, model = pair
    toks = _tokens(tcfg, 2, 7, seed=1)
    jcache = japi.init_cache(jcfg, 2, MAX_LEN)
    jl, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                              jcache, backend="xla")
    with torch.no_grad():
        tcache = tapi.init_cache(tcfg, 2, MAX_LEN, device="cpu")
        tl, tcache = tapi.prefill(model, {"tokens": torch.from_numpy(toks)},
                                  tcfg, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BAND)
    for key in ("k", "v"):
        stacked = torch.stack([c[key] for c in tcache["blocks"]]).numpy()
        np.testing.assert_allclose(stacked, np.asarray(jcache["blocks"][key]),
                                   **BAND)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    jl2, _ = japi.decode_step(jparams, jnp.asarray(nxt), jcfg, jcache,
                              jnp.int32(7), backend="xla")
    with torch.no_grad():
        tl2, tcache = tapi.decode_step(model, torch.from_numpy(nxt), tcfg,
                                       tcache, 7)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **BAND)
    assert tcache["blocks"][0]["k"][:, :, 8:].abs().sum() == 0


@pytest.mark.parametrize("batch,prompt_len,n_tokens", [
    (1, 5, 6), (1, 12, 4), (2, 9, 8), (3, 3, 5)])
def test_engine_greedy_matches_reference(pair, batch, prompt_len, n_tokens):
    jcfg, tcfg, jparams, _, model = pair
    toks = _tokens(tcfg, batch, prompt_len, seed=prompt_len)
    want = JEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN)).generate(
        {"tokens": jnp.asarray(toks)}, n_tokens=n_tokens, stop_tokens=())
    got = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN),
                 device="cpu").generate({"tokens": torch.from_numpy(toks)},
                                        n_tokens=n_tokens, stop_tokens=())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_stop_tokens_match_reference(pair):
    jcfg, tcfg, jparams, _, model = pair
    toks = _tokens(tcfg, 2, 6, seed=3)
    engine = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN), device="cpu")
    full = engine.generate({"tokens": torch.from_numpy(toks)}, n_tokens=10,
                           stop_tokens=()).numpy()
    stops = (int(full[0, 2]), int(full[1, 3]))
    want = JEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN)).generate(
        {"tokens": jnp.asarray(toks)}, n_tokens=10, stop_tokens=stops)
    got = engine.generate({"tokens": torch.from_numpy(toks)}, n_tokens=10,
                          stop_tokens=stops)
    assert got.shape[1] < 10
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generation_deterministic_under_generator(pair):
    _, tcfg, _, _, model = pair
    engine = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN,
                                             temperature=1.0), device="cpu")
    toks = {"tokens": torch.from_numpy(_tokens(tcfg, 2, 5))}

    def run(seed):
        return engine.generate(toks, n_tokens=8, stop_tokens=(),
                               generator=torch.Generator().manual_seed(seed))

    a, b, c = run(7), run(7), run(8)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab


def test_sampled_generation_default_generator_on_engine_device(pair,
                                                               monkeypatch):
    """With no generator, sampling draws from one on the engine's device,
    seeded 0: deterministic, and the same draws as an explicit one."""
    from repro_torch.serve import engine as engine_mod
    _, tcfg, _, _, model = pair
    engine = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN,
                                             temperature=1.0), device="cpu")
    toks = {"tokens": torch.from_numpy(_tokens(tcfg, 2, 5))}
    devices = []
    real = engine_mod._gumbel

    def spy(shape, generator, device):
        devices.append(generator.device)
        return real(shape, generator, device)

    monkeypatch.setattr(engine_mod, "_gumbel", spy)
    a = engine.generate(toks, n_tokens=6, stop_tokens=())
    b = engine.generate(toks, n_tokens=6, stop_tokens=())
    c = engine.generate(toks, n_tokens=6, stop_tokens=(),
                        generator=torch.Generator(
                            engine.device).manual_seed(0))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(a, c, atol=0, rtol=0)
    assert devices and all(d == engine.device for d in devices)

"""The port's layers against the JAX package's, on shared numpy inputs.

Tolerances: fp32 on both sides, so the bands cover only different
summation orders and transcendental ulps (rsqrt, sin/cos, pow) between the
two frameworks' CPU kernels: atol = rtol = 1e-5 for element-wise layers,
1e-4 where a GEMM sums over d_model or d_ff.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jattn
from repro.layers import embeddings as jemb
from repro.layers import mlp as jmlp
from repro.layers import norms as jnorms
from repro.layers.rope import apply_rope as japply_rope
from repro_torch.layers import attention as tattn
from repro_torch.layers import embeddings as temb
from repro_torch.layers import mlp as tmlp
from repro_torch.layers import norms as tnorms
from repro_torch.layers.rope import apply_rope as tapply_rope

RNG = np.random.default_rng(7)
ELEM = dict(atol=1e-5, rtol=1e-5)
GEMM = dict(atol=1e-4, rtol=1e-4)


def randn(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("shape", [(2, 5, 128), (3, 32)])
def test_rmsnorm(shape):
    x, scale = randn(*shape), randn(shape[-1])
    got = tnorms.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    want = jnorms.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    close(got, want, ELEM)
    mod = tnorms.RMSNorm(shape[-1])
    close(mod(torch.from_numpy(x)), jnorms.rmsnorm(
        jnorms.rmsnorm_init(shape[-1]), jnp.asarray(x)), ELEM)


def test_rmsnorm_bf16_keeps_dtype():
    x = torch.from_numpy(randn(4, 64)).to(torch.bfloat16)
    y = tnorms.rmsnorm(x, torch.ones(64, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("offset", [0, 17, 300])
def test_rope_interleaved_pairs(offset):
    x = randn(2, 4, 9, 32)
    pos = np.arange(offset, offset + 9)
    got = tapply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    want = japply_rope(jnp.asarray(x), jnp.asarray(pos))
    close(got, want, dict(atol=1e-4 if offset else 1e-5, rtol=1e-5))


def test_rope_batched_positions():
    x = randn(2, 3, 5, 16)
    pos = np.stack([np.arange(5), np.arange(40, 45)])
    got = tapply_rope(torch.from_numpy(x), torch.from_numpy(pos)[:, None])
    want = japply_rope(jnp.asarray(x), jnp.asarray(pos)[:, None])
    close(got, want, dict(atol=1e-4, rtol=1e-5))


def test_embeddings_encode_decode():
    table = randn(512, 128, scale=128 ** -0.5)
    tokens = RNG.integers(0, 512, (3, 7))
    params = {"table": jnp.asarray(table)}
    close(temb.encode(torch.from_numpy(table), torch.from_numpy(tokens)),
          jemb.encode(params, jnp.asarray(tokens)), dict(atol=0, rtol=0))
    x = randn(3, 7, 128)
    got = temb.decode(torch.from_numpy(table), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 7, 512)
    close(got, jemb.decode(params, jnp.asarray(x), backend="xla"), GEMM)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_gated_mlp(activation):
    d, f = 128, 256
    w = {"w_gate": randn(d, f, scale=d ** -0.5),
         "w_up": randn(d, f, scale=d ** -0.5),
         "w_down": randn(f, d, scale=f ** -0.5)}
    x = randn(2, 6, d)
    got = tmlp.apply(*(torch.from_numpy(w[k]) for k in
                       ("w_gate", "w_up", "w_down")),
                     torch.from_numpy(x), activation=activation)
    want = jmlp.apply({k: jnp.asarray(v) for k, v in w.items()},
                      jnp.asarray(x), activation=activation, backend="xla")
    close(got, want, GEMM)


def _attn_pair(n_heads=4, n_kv=2, dh=32, d=128):
    cfg_j = jattn.AttnCfg(d_model=d, n_heads=n_heads, n_kv_heads=n_kv,
                          head_dim=dh)
    cfg_t = tattn.AttnCfg(d_model=d, n_heads=n_heads, n_kv_heads=n_kv,
                          head_dim=dh)
    w = {"wq": randn(d, n_heads * dh, scale=d ** -0.5),
         "wk": randn(d, n_kv * dh, scale=d ** -0.5),
         "wv": randn(d, n_kv * dh, scale=d ** -0.5),
         "wo": randn(n_heads * dh, d, scale=(n_heads * dh) ** -0.5)}
    mod = tattn.Attention(cfg_t)
    with torch.no_grad():
        for k, v in w.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    return cfg_j, {k: jnp.asarray(v) for k, v in w.items()}, mod


def test_attention_train_prefill_decode_modes():
    cfg_j, pj, mod = _attn_pair()
    x = randn(2, 7, 128)
    with torch.no_grad():
        close(mod(torch.from_numpy(x), mode="train"),
              jattn.apply(pj, jnp.asarray(x), cfg_j, mode="train",
                          backend="xla"), GEMM)
        cache_t = tattn.init_cache(mod.cfg, 2, 12)
        cache_j = jattn.init_cache(cfg_j, 2, 12)
        y_t, cache_t = mod(torch.from_numpy(x), mode="prefill",
                           cache=cache_t)
        y_j, cache_j = jattn.apply(pj, jnp.asarray(x), cfg_j, mode="prefill",
                                   cache=cache_j, backend="xla")
        close(y_t, y_j, GEMM)
        for key in ("k", "v"):
            close(cache_t[key], cache_j[key], GEMM)
        x1 = randn(2, 1, 128)
        y_t, cache_t = mod(torch.from_numpy(x1), mode="decode",
                           cache=cache_t, pos=torch.full((2,), 7))
        y_j, cache_j = jattn.apply(pj, jnp.asarray(x1), cfg_j, mode="decode",
                                   cache=cache_j, pos=7, backend="xla")
        close(y_t, y_j, GEMM)
        close(cache_t["k"], cache_j["k"], GEMM)

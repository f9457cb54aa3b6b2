"""Plain versions of the port's kernels against the JAX package.

``matmul_ref`` is held against the reference's ``matmul_ref`` and against
``matmul_pallas`` in interpret mode; ``mha_ref`` against the reference's
``mha_ref``; the plain flash path (with lse) against
``flash_attention_pallas(interpret=True, return_residuals=True)``.

The backward: the activation-gradient tables against the reference's;
``matmul``'s gradients (plain autograd on the ``"torch"`` backend) against
``jax.vjp`` of the reference's ``matmul`` on its Pallas backend in
interpret mode, whose custom VJP is the kernel three times; and
``flash_attention_bwd_ref`` / ``delta_rowsum_ref`` against
``flash_attention_bwd_pallas`` / ``delta_rowsum_pallas`` in interpret mode.

Tolerances: fp32 inputs on both sides, fp32 accumulation in different
orders (atol = rtol = 3e-5, the band the reference's own pallas-vs-xla
GEMM tests use); bf16 outputs may differ by one bf16 ulp where the fp32
sums round differently (atol = rtol = 1e-2); the exp epilogue amplifies
fp32 differences by its own value (rtol 1e-4).  Gradients: 2e-4, the band
the reference's own gradient tests use (a gradient is a second product over
the first one's rounding).  Activation derivatives are elementwise fp32
formulas on both sides (atol = rtol = 1e-6).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.core import fusion as jfusion
from repro.kernels.brgemm import ref as jref
from repro.kernels.brgemm.kernel import matmul_pallas
from repro.kernels.brgemm.ops import matmul as jmatmul
from repro.kernels.flash_attention import bwd as jbwd
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import mha_ref as jmha_ref
from repro_torch.core import fusion
from repro_torch.kernels.brgemm import matmul, matmul_ref
from repro_torch.kernels.flash_attention import (delta_rowsum_ref,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 mha_ref)

RNG = np.random.default_rng(11)
F32 = dict(atol=3e-5, rtol=3e-5)
BF16_OUT = dict(atol=1e-2, rtol=1e-2)


def randn(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _gemm_operands(m=7, k=33, n=17):
    return (randn(m, k), randn(k, n, scale=k ** -0.5), randn(n),
            randn(m, n))


def _tol(activation, out_dtype):
    if out_dtype == "bfloat16":
        return BF16_OUT
    return dict(atol=3e-5, rtol=1e-4) if activation == "exp" else F32


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["plain", "bias", "c0", "bias+c0"])
@pytest.mark.parametrize("activation", list(fusion.ACTIVATIONS))
def test_matmul_ref_matches_reference(activation, epilogue, out_dtype):
    x, w, bias, c0 = _gemm_operands()
    use_bias, use_c0 = "bias" in epilogue, "c0" in epilogue
    kw = dict(activation=activation, alpha=0.75, beta=0.5 if use_c0 else 0.0)
    got = matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(bias) if use_bias else None,
                     c0=torch.from_numpy(c0) if use_c0 else None,
                     out_dtype=getattr(torch, out_dtype), **kw)
    want = jref.matmul_ref(jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(bias) if use_bias else None,
                           c0=jnp.asarray(c0) if use_c0 else None,
                           out_dtype=getattr(jnp, out_dtype), **kw)
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_tol(activation, out_dtype))


@pytest.mark.parametrize("activation,epilogue,out_dtype", [
    ("none", "plain", "float32"),
    ("silu", "plain", "bfloat16"),
    ("gelu", "bias", "float32"),
    ("relu", "c0", "float32"),
    ("tanh", "bias+c0", "bfloat16"),
])
def test_matmul_ref_matches_pallas_interpret(activation, epilogue,
                                             out_dtype):
    x, w, bias, c0 = _gemm_operands(m=9, k=40, n=24)
    use_bias, use_c0 = "bias" in epilogue, "c0" in epilogue
    kw = dict(activation=activation, alpha=1.5, beta=0.25 if use_c0 else 0.0)
    got = matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(bias) if use_bias else None,
                     c0=torch.from_numpy(c0) if use_c0 else None,
                     out_dtype=getattr(torch, out_dtype), **kw)
    want = matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                         jnp.asarray(bias) if use_bias else None,
                         jnp.asarray(c0) if use_c0 else None,
                         out_dtype=getattr(jnp, out_dtype), interpret=True,
                         **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_tol(activation, out_dtype))


def test_matmul_bf16_inputs_accumulate_in_fp32():
    x, w, _, _ = _gemm_operands(m=5, k=64, n=12)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    got = matmul_ref(xb, wb, out_dtype=torch.float32)
    want = jref.matmul_ref(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16),
                           out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_matmul_leading_dims_and_strided_weight():
    x = torch.from_numpy(randn(2, 3, 16))
    table = torch.from_numpy(randn(10, 16))
    got = matmul(x, table.T, out_dtype=torch.float32)
    assert got.shape == (2, 3, 10)
    want = matmul_ref(x.reshape(6, 16), table.T.contiguous(),
                      out_dtype=torch.float32).reshape(2, 3, 10)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_activation_codes_match_cuda_enum():
    # The kernels' one enum, which matmul.cu and the tile GEMMs include.
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "kernels" / "include" / "repro_tile.cuh").read_text()
    enum = re.search(r"enum Act \{([^}]*)\}", src).group(1)
    names = [e.split("=")[0].strip().lower() for e in enum.split(",")]
    assert names[:len(fusion.CODES)] == list(fusion.CODES)
    assert names[len(fusion.CODES)] == "n_act"


MHA_CASES = [
    dict(causal=True),
    dict(causal=True, window=4),
    dict(causal=False),
    dict(causal=False, q_offset=9, kv_len=10),        # decode, padded cache
    dict(causal=True, q_offset=5, kv_len=11),         # offset chunk
]


@pytest.mark.parametrize("kw", MHA_CASES)
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (3, 1)])
def test_mha_ref_matches_reference(kw, hq, hkv):
    tq = 1 if kw.get("q_offset") == 9 else 6
    q, k, v = randn(2, hq, tq, 16), randn(2, hkv, 16, 16), \
        randn(2, hkv, 16, 16)
    got = mha_ref(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    want = jmha_ref(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("t,window,hq,hkv", [
    (32, None, 4, 2),
    (20, None, 2, 2),      # ragged: not a multiple of any block
    (24, 8, 4, 1),
])
def test_plain_flash_matches_pallas_interpret_with_lse(t, window, hq, hkv):
    q, k, v = randn(1, hq, t, 32), randn(1, hkv, t, 32), randn(1, hkv, t, 32)
    o, lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, window=window,
                             return_residuals=True)
    want_o, want_lse = flash_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window,
        interpret=True, return_residuals=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **F32)


def test_mha_ref_lse_empty_rows_are_neg_inf():
    q, k, v = (torch.from_numpy(randn(1, 2, 4, 8)) for _ in range(3))
    _, lse = mha_ref(q, k, v, causal=False, kv_len=0, return_lse=True)
    assert torch.all(lse == -1e30)


# --------------------------------------------------------------------------
# the backward
# --------------------------------------------------------------------------

GRAD = dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("activation", list(fusion.ACTIVATIONS))
def test_activation_grads_match_reference(activation):
    pre = randn(5, 7) * 2
    assert fusion.needs_preact(activation) == jfusion.needs_preact(
        activation)
    if fusion.needs_preact(activation):
        got = fusion.GRAD_FROM_PREACT[activation](torch.from_numpy(pre))
        want = jfusion.GRAD_FROM_PREACT[activation](jnp.asarray(pre))
    else:
        y = np.array(jfusion.apply(activation, jnp.asarray(pre)))
        got = fusion.GRAD_FROM_OUTPUT[activation](torch.from_numpy(y))
        want = jfusion.GRAD_FROM_OUTPUT[activation](jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    with pytest.raises(ValueError):
        fusion.needs_preact("nope")


@pytest.mark.parametrize("activation,epilogue", [
    ("none", "plain"), ("silu", "plain"), ("gelu", "bias"),
    ("relu", "c0"), ("tanh", "bias+c0"), ("square", "plain"),
    ("sigmoid", "bias"), ("none", "table.T"),
])
def test_matmul_grads_match_reference_vjp(activation, epilogue):
    m, k, n = 9, 40, 24
    x, w, bias, c0 = _gemm_operands(m=m, k=k, n=n)
    table = randn(n, k, scale=k ** -0.5)
    dy = randn(m, n)
    use_bias, use_c0 = "bias" in epilogue, "c0" in epilogue
    kw = dict(activation=activation, alpha=1.5, beta=0.25 if use_c0 else 0.0)
    leaves = {"x": x, "w": table if epilogue == "table.T" else w}
    if use_bias:
        leaves["bias"] = bias
    if use_c0:
        leaves["c0"] = c0

    def jf(*args):
        a = dict(zip(leaves, args))
        wj = a["w"].T if epilogue == "table.T" else a["w"]
        return jmatmul(a["x"], wj, a.get("bias"), a.get("c0"),
                       backend="pallas", **kw)

    _, vjp = jax.vjp(jf, *(jnp.asarray(v) for v in leaves.values()))
    want = vjp(jnp.asarray(dy))

    t = {key: torch.from_numpy(v).requires_grad_() for key, v in
         leaves.items()}
    wt = t["w"].T if epilogue == "table.T" else t["w"]
    y = matmul(t["x"], wt, t.get("bias"), t.get("c0"), backend="torch", **kw)
    got = torch.autograd.grad(y, list(t.values()), torch.from_numpy(dy))
    for key, g, gw in zip(leaves, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw), err_msg=key,
                                   **GRAD)


BWD_CASES = [
    ("causal", dict(causal=True), dict(t=32, hq=2, hkv=2)),
    ("windowed", dict(causal=True, window=8), dict(t=32, hq=2, hkv=2)),
    ("gqa", dict(causal=True), dict(t=24, hq=4, hkv=2)),
    ("ragged", dict(causal=True), dict(t=20, hq=3, hkv=1)),
]


def _bwd_inputs(t, hq, hkv, d=32):
    q, k, v = randn(1, hq, t, d), randn(1, hkv, t, d), randn(1, hkv, t, d)
    return q, k, v, randn(1, hq, t, d)


@pytest.mark.parametrize("name,kw,shape", BWD_CASES,
                         ids=[c[0] for c in BWD_CASES])
def test_flash_bwd_ref_matches_pallas_interpret(name, kw, shape):
    q, k, v, dy = _bwd_inputs(**shape)
    jq, jk, jv, jdy = (jnp.asarray(a) for a in (q, k, v, dy))
    y, lse = flash_attention_pallas(jq, jk, jv, interpret=True,
                                    return_residuals=True, **kw)
    want = jbwd.flash_attention_bwd_pallas(jq, jk, jv, y, lse, jdy,
                                           interpret=True, **kw)
    tq, tk, tv, tdy = (torch.from_numpy(a) for a in (q, k, v, dy))
    ty, tlse = (torch.from_numpy(np.asarray(a)) for a in (y, lse))
    got = flash_attention_bwd_ref(tq, tk, tv, ty, tlse, tdy, **kw)
    via_op = flash_attention_bwd(tq, tk, tv, ty, tlse, tdy, **kw)
    leaves = [a.requires_grad_() for a in (tq.clone(), tk.clone(),
                                           tv.clone())]
    via_autograd = torch.autograd.grad(flash_attention(*leaves, **kw),
                                       leaves, tdy)
    for g_name, g, gw, g_op, g_ad in zip(("dq", "dk", "dv"), got, want,
                                         via_op, via_autograd):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw),
                                   err_msg=f"{name} {g_name}", **GRAD)
        torch.testing.assert_close(g_op, g, atol=0, rtol=0)
        torch.testing.assert_close(g_ad, g, atol=0, rtol=0)


def test_delta_rowsum_ref_matches_pallas_interpret():
    y, dy = randn(2, 3, 20, 32), randn(2, 3, 20, 32)
    want = jbwd.delta_rowsum_pallas(jnp.asarray(y), jnp.asarray(dy),
                                    interpret=True)
    got = delta_rowsum_ref(torch.from_numpy(y), torch.from_numpy(dy))
    assert got.shape == (2, 3, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
def test_flash_bwd_ref_row_with_no_valid_key_matches_reference_grad(hq,
                                                                    hkv):
    """Non-causal, windowed, Tq > Tk: rows q_pos >= Tk + window - 1 see no
    key.  Their output is the mean of V, so every key's dV takes the row's
    dO / Tk and dQ, dK nothing: the plain gradient (autograd of the port's
    mha_ref, which the card's backward kernel is held to) against
    ``jax.vjp`` of the reference's mha_ref."""
    kw = dict(causal=False, window=3)
    q, k, v = randn(1, hq, 12, 16), randn(1, hkv, 5, 16), \
        randn(1, hkv, 5, 16)
    dy = randn(1, hq, 12, 16)
    _, vjp = jax.vjp(lambda a, b, c: jmha_ref(a, b, c, **kw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dy))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = mha_ref(tq, tk, tv, return_lse=True, **kw)
    assert (lse[..., 7:] == -1e30).all() and (lse[..., :7] > -1e29).all()
    got = flash_attention_bwd_ref(tq, tk, tv, None, lse,
                                  torch.from_numpy(dy), **kw)
    for name, g, gw in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw), err_msg=name,
                                   **GRAD)
    # The empty rows reach dV only, each key by the row's dO / Tk.
    e = np.zeros_like(dy)
    e[..., 7:, :] = dy[..., 7:, :]
    _, vjp_e = jax.vjp(lambda a, b, c: jmha_ref(a, b, c, **kw),
                       *(jnp.asarray(a) for a in (q, k, v)))
    dq_e, dk_e, dv_e = vjp_e(jnp.asarray(e))
    assert np.abs(np.asarray(dq_e)).max() == 0
    assert np.abs(np.asarray(dk_e)).max() == 0
    per_key = e.reshape(1, hkv, hq // hkv, 12, 16).sum((2, 3)) / 5
    np.testing.assert_allclose(np.asarray(dv_e), np.broadcast_to(
        per_key[:, :, None], dv_e.shape), **GRAD)

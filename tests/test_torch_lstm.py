"""The port's LSTM, FC layer, SGDM and LSTM language model against the JAX
package, on the CPU.

Inputs come from numpy seeds; the reference's parameters cross as numpy
arrays through ``interop``.  Bands, all fp32 on both sides:
  * LSTM forward and gradients, FC: atol = rtol = 2e-4, the reference
    suite's own band for its Pallas-vs-XLA LSTM and FC checks (two
    frameworks' GEMM sum orders and tanh / sigmoid ulps through a few
    steps);
  * SGDM: 1e-6 (the same elementwise formulas, one global norm summed in
    another order);
  * the LSTM-LM loss 1e-5 and its gradients 2e-4; the example's first 10
    losses 1e-4.
The reference runs under ``backend="xla"`` and, where the test names it,
``"pallas"`` (interpret mode on the CPU, as the JAX suite runs it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.layers import linear as jlinear
from repro.layers import lstm as jlstm
from repro.models import lstm_lm as jlm
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.layers import linear, lstm
from repro_torch.models import lstm_lm
from repro_torch.train import optimizer as opt

BAND = dict(rtol=2e-4, atol=2e-4)


def randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_lstm_cell_equations():
    """Eq. 1-6 against a numpy rewrite, gate order (i, c, f, o)."""
    c, k, n = 16, 24, 4
    p = lstm.init(c, k, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    assert torch.equal(p["b"][2], torch.ones(k))          # forget bias
    assert not p["b"][[0, 1, 3]].any()
    x = randn(np.random.default_rng(0), 3, n, c)
    h, s = lstm.forward(p, t(x))
    assert h.shape == s.shape == (3, n, k)

    def sig(v):
        return 1 / (1 + np.exp(-v))

    W, R, B = (p[key].numpy() for key in ("w", "r", "b"))
    h_prev = np.zeros((n, k), np.float32)
    s_prev = np.zeros((n, k), np.float32)
    for step in range(3):
        pre = [x[step] @ W[i] + h_prev @ R[i] + B[i] for i in range(4)]
        i_t, c_t, f_t, o_t = sig(pre[0]), np.tanh(pre[1]), sig(pre[2]), \
            sig(pre[3])
        s_prev = f_t * s_prev + i_t * c_t
        h_prev = o_t * np.tanh(s_prev)
        np.testing.assert_allclose(h[step].numpy(), h_prev, **BAND)
        np.testing.assert_allclose(s[step].numpy(), s_prev, **BAND)


def test_cell_step_launches_eight_gemms(monkeypatch):
    """Two matmuls a gate, in gate order: x @ W_g to fp32, then h @ R_g
    chained onto it (c0, beta 1) with the bias and the gate's activation."""
    from repro_torch.core import brgemm
    calls = []
    real = brgemm.matmul

    def spy(x, w, bias=None, c0=None, **kw):
        calls.append((bias is not None, c0 is not None, kw.get("beta", 0.0),
                      kw.get("activation", "none"), kw.get("out_dtype")))
        return real(x, w, bias, c0, **kw)

    monkeypatch.setattr(brgemm, "matmul", spy)
    p = lstm.init(8, 8, device="cpu")
    lstm.cell_step(p, torch.zeros(2, 8), torch.zeros(2, 8),
                   torch.zeros(2, 8))
    acts = ("sigmoid", "tanh", "sigmoid", "sigmoid")
    want = []
    for a in acts:
        want += [(False, False, 0.0, "none", torch.float32),
                 (True, True, 1.0, a, None)]
    assert calls == want


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_lstm_forward_and_grads_match_reference(backend):
    rng = np.random.default_rng(1)
    jp = jlstm.init(jax.random.PRNGKey(1), 20, 28)
    x = randn(rng, 4, 3, 20)
    gh, gs = randn(rng, 4, 3, 28), randn(rng, 4, 3, 28)

    def jloss(p, x):
        h, s = jlstm.forward(p, x, backend=backend)
        return (h * gh).sum() + (s * gs).sum(), (h, s)

    (_, (hw, sw)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    p = interop.lstm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    p = {key: v.requires_grad_() for key, v in p.items()}
    xt = t(x).requires_grad_()
    h, s = lstm.forward(p, xt)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(hw), **BAND)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(sw), **BAND)
    loss = (h * t(gh)).sum() + (s * t(gs)).sum()
    grads = torch.autograd.grad(loss, [p["w"], p["r"], p["b"], xt])
    for got, want in zip(grads, [jgp["w"], jgp["r"], jgp["b"], jgx]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


# ------------------------------- FC -----------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fc_forward_matches_reference(backend):
    jp = jlinear.init(jax.random.PRNGKey(0), 96, 64)
    x = randn(np.random.default_rng(7), 32, 96)
    want = jlinear.apply(jp, jnp.asarray(x), activation="relu",
                         backend=backend)
    p = {key: t(v) for key, v in jp.items()}
    got = linear.apply(p, t(x), activation="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    np.testing.assert_allclose(
        got.numpy(), np.maximum(x @ np.asarray(jp["w"])
                                + np.asarray(jp["b"]), 0), **BAND)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fc_bwd_upd_match_reference(backend):
    """dX (BWD, reduces over K), dW (UPD, reduces over the minibatch) and
    the bias gradient of a sigmoid FC layer."""
    jp = jlinear.init(jax.random.PRNGKey(0), 48, 40)
    x = randn(np.random.default_rng(8), 16, 48)

    def jloss(p, x):
        return (jlinear.apply(p, x, activation="sigmoid",
                              backend=backend) ** 2).sum()

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    p = {key: t(v).requires_grad_() for key, v in jp.items()}
    xt = t(x).requires_grad_()
    loss = (linear.apply(p, xt, activation="sigmoid") ** 2).sum()
    gw, gb, gx = torch.autograd.grad(loss, [p["w"], p["b"], xt])
    for got, want in ((gw, jgp["w"]), (gb, jgp["b"]), (gx, jgx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


# ------------------------------- SGDM ---------------------------------

@pytest.mark.parametrize("clip,wd", [(0.5, 0.01), (1e6, 0.01), (0.0, 0.0)],
                         ids=["clip_active", "clip_inactive", "no_clip"])
def test_sgdm_update_matches_reference(clip, wd):
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (7,), "c": (2, 3, 4)}
    params = {n: randn(rng, *s) for n, s in shapes.items()}
    grads = [{n: 3 * randn(rng, *s) for n, s in shapes.items()}
             for _ in range(3)]
    jcfg = jopt.SGDMCfg(lr=0.3, momentum=0.9, weight_decay=wd,
                        grad_clip=clip)
    cfg = opt.SGDMCfg(lr=0.3, momentum=0.9, weight_decay=wd,
                      grad_clip=clip)
    assert jcfg == jopt.SGDMCfg(**vars(cfg))
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    jstate = jopt.sgdm_init(jparams, jcfg)
    tparams = {n: t(v) for n, v in params.items()}
    tstate = opt.sgdm_init(tparams, cfg)
    for i, g in enumerate(grads):
        jparams, jstate, jm = jopt.sgdm_update(
            jparams, {n: jnp.asarray(v) for n, v in g.items()}, jstate,
            jcfg, lr_scale=0.5 + i)
        tparams, tstate, tm = opt.sgdm_update(
            tparams, {n: t(v) for n, v in g.items()}, tstate, cfg,
            lr_scale=0.5 + i)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert tstate["step"] == int(jstate["step"])
        for n in shapes:
            np.testing.assert_allclose(tparams[n].numpy(),
                                       np.asarray(jparams[n]), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(tstate["mom"][n].numpy(),
                                       np.asarray(jstate["mom"][n]),
                                       rtol=1e-6, atol=1e-6)
    if clip == 0.5:       # the clip really scaled every update
        assert float(jm["grad_norm"]) > 10 * clip


def test_sgdm_keeps_bf16_params_and_fp32_momentum():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.sgdm_init(p, opt.SGDMCfg())
    p, state, _ = opt.sgdm_update(p, {"w": torch.full((4,), 0.5,
                                                      dtype=torch.bfloat16)},
                                  state, opt.SGDMCfg(lr=0.1))
    assert p["w"].dtype == torch.bfloat16
    assert state["mom"]["w"].dtype == torch.float32
    assert torch.equal(state["mom"]["w"], torch.full((4,), 0.5))
    want = torch.full((4,), 1 - 0.1 * 0.5).to(torch.bfloat16)
    assert torch.equal(p["w"], want)


# ----------------------------- LSTM-LM --------------------------------

def _lm_pair(cfg_kw, seed=0):
    jcfg = jlm.LSTMLMCfg(**cfg_kw)
    cfg = lstm_lm.LSTMLMCfg(**cfg_kw)
    assert vars(jcfg) == vars(cfg)
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, interop.lstm_lm_params_from_numpy(
        tree, cfg, device="cpu")


def test_lstm_lm_defaults_and_interop_round_trip():
    assert vars(lstm_lm.LSTMLMCfg()) == vars(jlm.LSTMLMCfg())
    _, cfg, jparams, params = _lm_pair(dict(vocab=64, d_model=16,
                                            n_layers=2))
    back = interop.lstm_lm_params_to_numpy(params)
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf))
    with pytest.raises(ValueError, match="layers"):
        interop.lstm_lm_params_from_numpy(
            back, lstm_lm.LSTMLMCfg(vocab=64, d_model=16, n_layers=3),
            device="cpu")
    own = lstm_lm.init_params(cfg, device="cpu")
    assert [tuple(v.shape) for _, v in
            jax.tree_util.tree_leaves_with_path(own)] == [
        tuple(v.shape) for _, v in flat]


def test_lstm_lm_loss_and_grads_match_reference():
    jcfg, cfg, jparams, params = _lm_pair(dict(vocab=64, d_model=32,
                                               n_layers=2), seed=1)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 64, (3, 6)).astype(np.int32)
    labels = rng.integers(0, 64, (3, 6)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    with repro.use(backend="xla"):
        (jl, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
            jparams, jbatch, jcfg)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    (loss, aux), grads = lstm_lm.loss_and_grads(params, batch, cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(aux["loss"]) == float(loss)
    logits = lstm_lm.forward(params, batch["tokens"], cfg)
    assert logits.shape == (3, 6, 64) and logits.dtype == torch.float32
    got = dict(jax.tree_util.tree_leaves_with_path(
        interop.lstm_lm_params_to_numpy(grads)))
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        np.testing.assert_allclose(got[path], np.asarray(want), **BAND)


def test_gnmt_example_losses_match_reference():
    """The first 10 steps of examples/train_lstm_gnmt.py: vocab 128, d 64,
    4 layers, SGDM (lr 0.3, momentum 0.9, clip 1.0) on "next = current +
    1" batches; the port's losses within 1e-4 of the reference's."""
    kw = dict(vocab=128, d_model=64, n_layers=4)
    jcfg, cfg, jparams, params = _lm_pair(kw)
    jocfg = jopt.SGDMCfg(lr=0.3, momentum=0.9, grad_clip=1.0)
    ocfg = opt.SGDMCfg(lr=0.3, momentum=0.9, grad_clip=1.0)
    jstate = jopt.sgdm_init(jparams, jocfg)

    @jax.jit
    def jstep(params, state, batch):
        (loss, _), grads = jax.value_and_grad(
            jlm.loss_fn, has_aux=True)(params, batch, jcfg)
        params, state, _ = jopt.sgdm_update(params, grads, state, jocfg)
        return params, state, loss

    named = dict(lstm_lm.named_leaves(params))
    state = opt.sgdm_init(named, ocfg)
    rng = np.random.default_rng(0)
    jlosses, losses = [], []
    for _ in range(10):
        start = rng.integers(0, cfg.vocab, size=(16, 1))
        seq = (start + np.arange(33)) % cfg.vocab
        tokens, labels = seq[:, :-1], seq[:, 1:]
        with repro.use(backend="xla"):
            jparams, jstate, jl = jstep(
                jparams, jstate, {"tokens": jnp.asarray(tokens, jnp.int32),
                                  "labels": jnp.asarray(labels, jnp.int32)})
        jlosses.append(float(jl))
        (loss, _), grads = lstm_lm.loss_and_grads(
            params, {"tokens": torch.from_numpy(tokens),
                     "labels": torch.from_numpy(labels)}, cfg)
        opt.sgdm_update(named, dict(lstm_lm.named_leaves(grads)), state,
                        ocfg)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]

"""Training the MoE, MLA and recurrent families against the JAX package, on
the CPU: the loss and every parameter's gradient, and one AdamW step, of
grok-1-314b, deepseek-v3-671b (MLA, MTP, the shared expert), xlstm-1.3b
and recurrentgemma-9b; and the two pieces the card's train steps add: the
flash backward's zero padding of a head-size pair no instantiation holds,
and the batched GEMM's backward formula (``brgemm.ops.batched_bwd``, which
``_BatchedCuda`` runs on the card).

The configs are the reference's ``reduced()`` forms (fp32) cut to a few
layers (``LAYERS``), weights made by
the reference from a fixed key and handed over as numpy arrays
(``interop``), inputs made with numpy from a seed.  The port runs on its
``torch`` backend, the reference under ``repro.use(backend="xla")`` (its
MoE experts then the one einsum the port's kernel backward differentiates),
as ``test_torch_encdec.py`` does for the encoder-decoder.  Bands: atol =
rtol = 1e-4 on losses and parameters after a step (fp32 both sides, two
frameworks' sum orders); each gradient entry within rtol 1e-4 and an
atol of 1e-4 times its own parameter's largest gradient entry, that scale
floored at 1e-2 of the largest entry of the parameter's layer (xlstm's
input-gate biases cancel to ~6e-6 against ~0.26 in their layer; every
gradient measures within 8e-6 of its scale on these configs); the padded
backward against the unpadded one 1e-5 (fp32 autograd of the same sums, with zero terms added);
the batched backward's formula against plain autograd 1e-5 (fp32; the
same products in another grouping).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro
from repro import configs as jconfigs
from repro.configs.shapes import ShapeCfg as JShapeCfg
from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels.brgemm import kernel as BK
from repro_torch.kernels.brgemm import ops as bops
from repro_torch.kernels.brgemm.ref import batched_matmul_ref
from repro_torch.kernels.flash_attention import bwd as FB
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     mha_ref)
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

BAND = dict(atol=1e-4, rtol=1e-4)
FAMILIES = ["grok-1-314b", "deepseek-v3-671b", "xlstm-1.3b",
            "recurrentgemma-9b"]
# A few layers of each reduced config: grok's and deepseek-v3's first two
# (deepseek's one dense layer, one MoE layer, and its MTP block); one
# (mLSTM, sLSTM) pair of xlstm; one (rec, rec, attn) group of
# recurrentgemma.
LAYERS = {"grok-1-314b": dict(n_layers=2),
          "deepseek-v3-671b": dict(n_layers=2),
          "xlstm-1.3b": dict(n_layers=2, slstm_every=2),
          "recurrentgemma-9b": dict(n_layers=3)}
B, T = 2, 16        # xlstm's mLSTM chunk is 16 reduced: T a multiple
# A gradient's absolute band as a share of its parameter's scale, and the
# floor of that scale as a share of its layer's (see above).
GRAD_SCALE_BAND, LAYER_FLOOR = 1e-4, 1e-2


@pytest.fixture(scope="module")
def pairs():
    """Per family: (reference cfg, port cfg, reference params, the port's
    model on the CPU), built once for the module."""
    out = {}
    for name in FAMILIES:
        jcfg, tcfg = (dataclasses.replace(c.get(name).reduced(),
                                          **LAYERS[name])
                      for c in (jconfigs, tconfigs))
        jparams = jax.jit(lambda key: japi.init_params(key, jcfg))(
            jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        out[name] = (jcfg, tcfg, jparams, interop.params_from_numpy(
            tree, tcfg, device="cpu"))
    return out


def _batch(cfg, seed):
    """A batch of the reference's token stream."""
    pipe = jpipeline.TokenPipeline(cfg, JShapeCfg(
        name="t", kind="train", seq_len=T, global_batch=B), seed=seed)
    try:
        return {k: np.asarray(v) for k, v in next(pipe).items()}
    finally:
        pipe.close()


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **BAND)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_reference(pairs, name):
    """The loss (with the MoE balance and z terms, deepseek's MTP term)
    and the gradient of every parameter, labels of -1 masked."""
    jcfg, tcfg, jparams, model = pairs[name]
    batch = _batch(jcfg, seed=1)
    batch["labels"][0, :3] = -1
    with repro.use(backend="xla"):      # jitted: eager dispatch is slower
        (wloss, wmetrics), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: japi.loss_fn(p, b, jcfg), has_aux=True))(
                jparams, _j(batch))
    metrics, grads = tts.loss_and_grads(model, batch, tcfg)
    _close(metrics["loss"], wloss)
    assert sorted(metrics) == sorted(wmetrics)
    for key in wmetrics:
        _close(metrics[key], wmetrics[key], key)
    want = dict(interop.named_leaves(jax.tree.map(np.asarray, jgrads), tcfg))
    assert sorted(want) == sorted(grads)
    layer_max = {}
    for pname, w in want.items():
        layer = pname.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0),
                               float(np.abs(w).max()))
    for pname, g in grads.items():
        assert g is not None, pname
        scale = max(float(np.abs(want[pname]).max()),
                    LAYER_FLOOR * layer_max[pname.rsplit(".", 1)[0]])
        np.testing.assert_allclose(g.numpy(), want[pname],
                                   atol=GRAD_SCALE_BAND * scale,
                                   rtol=BAND["rtol"], err_msg=pname)


@pytest.mark.parametrize("name", FAMILIES)
def test_one_adamw_step_matches_reference(pairs, name):
    """One step through ``make_train_step`` from the reference's state
    (carried by ``interop.opt_state_from_numpy``, at step 10 so that the
    learning rate is not 0): the loss and every parameter after it."""
    jcfg, tcfg, _, _ = pairs[name]
    batch = _batch(jcfg, seed=2)
    jstate = jax.jit(lambda key: jts.init_state(key, jcfg, jopt.AdamWCfg()))(
        jax.random.PRNGKey(0))
    jstate["opt"]["step"] = jnp.asarray(10, jstate["opt"]["step"].dtype)
    before = dict(interop.named_leaves(
        jax.tree.map(np.asarray, jstate["opt"]["master"]), tcfg))
    state = {"opt": interop.opt_state_from_numpy(
        jax.tree.map(np.asarray, jstate["opt"]), tcfg, "cpu")}
    with repro.use(backend="xla"):
        jnew, jmetrics = jax.jit(jts.make_train_step(jcfg, jopt.AdamWCfg()))(
            jstate, _j(batch))
    new, metrics = tts.make_train_step(tcfg, topt.AdamWCfg())(state, batch)
    _close(metrics["loss"], jmetrics["loss"])
    want = dict(interop.named_leaves(
        jax.tree.map(np.asarray, jnew["opt"]["master"]), tcfg))
    assert sorted(want) == sorted(new["opt"]["master"])
    moved = 0
    for pname, p in new["opt"]["master"].items():
        _close(p, want[pname], pname)
        moved += not np.array_equal(p.numpy(), before[pname])
    assert moved == len(want)


# ==========================================================================
# the flash backward's padded pairs
# ==========================================================================

@pytest.mark.parametrize("d,dv,pair,causal", [
    (24, 16, (32, 32), True),        # the reduced MLA's, the path's pad
    (24, 16, (32, 32), False),
    (192, 128, (256, 256), True),    # MLA's, padded as the other design
])
def test_padded_backward_sliced_back_is_the_unpadded(d, dv, pair, causal):
    """The backward's padding rule: q and k zero-padded to the pair's d,
    v, y and dy to its dv, the plain backward at the unpadded size's scale,
    sliced back, equals the unpadded backward; the padded columns'
    gradients are zero.  Where the pair is the one ``head_dims`` picks,
    the padding is the wrapper's own (``bwd._padded``)."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    q, k, v = t(2, 4, 20, d), t(2, 2, 20, d), t(2, 2, 20, dv)
    dy = t(2, 4, 20, dv)
    y = mha_ref(q, k, v, causal=causal)
    want = flash_attention_bwd_ref(q, k, v, y, None, dy, causal=causal)
    padded = [F.pad(x, (0, n - x.size(3))) for x, n in zip(
        (q, k, v, y, dy), (pair[0], pair[0], pair[1], pair[1], pair[1]))]
    if FK.head_dims(d, dv) == pair:
        for a, b in zip(FB._padded(q, k, v, y, dy), padded):
            assert torch.equal(a, b)
    pq, pk, pv, py, pdy = padded
    got = flash_attention_bwd_ref(pq, pk, pv, py, None, pdy, causal=causal,
                                  scale=d ** -0.5)
    for name, g, w, n in zip(("dq", "dk", "dv"), got, want, (d, d, dv)):
        torch.testing.assert_close(g[..., :n], w, atol=1e-5, rtol=1e-5,
                                   msg=name)
        assert not g[..., n:].any(), name


def test_padded_backward_of_a_native_pair_is_not_padded():
    """MLA's (192, 128) and RecurrentGemma's (256, 256) run as they are;
    a pair wider than every instantiation raises."""
    for d, dv in ((192, 128), (256, 256), (64, 64)):
        views = [torch.zeros(1, 1, 4, n) for n in (d, d, dv, dv, dv)]
        assert all(a is b for a, b in zip(FB._padded(*views), views))
    with pytest.raises(ValueError, match="fit no instantiation"):
        FB._padded(*[torch.zeros(1, 1, 4, n) for n in (264, 264, 128, 128,
                                                       128)])


# ==========================================================================
# the batched GEMM's backward
# ==========================================================================

@pytest.mark.parametrize("case", [
    "silu", "bias_gelu", "broadcast_a", "broadcast_b", "transposed"])
def test_batched_backward_formula_matches_autograd(case, monkeypatch):
    """``_BatchedCuda`` with the kernel swapped for its plain version (so
    its own formula runs on the CPU: dA_i = alpha g_i B_i^T, dB_i = alpha
    A_i^T g_i, the broadcast operand summed over the batch, dbias, g from
    the output or the recomputed pre-activation) against plain autograd
    through ``batched_matmul_ref``; and the count of GEMMs it calls."""
    rng = np.random.default_rng(3)
    nb, m, k, n = 3, 5, 7, 6

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    act, alpha, bias = "none", 1.0, None
    a, b = t(nb, m, k), t(nb, k, n)
    if case == "silu":
        act = "silu"
    elif case == "bias_gelu":
        act, bias, alpha = "gelu", t(n), 0.5
    elif case == "broadcast_a":
        a, act = t(m, k), "relu"
    elif case == "broadcast_b":
        b, bias = t(k, n), t(n)
    else:   # both operands column-major entries, read in place
        a, b = t(nb, k, m).transpose(1, 2), t(nb, n, k).transpose(1, 2)
        act = "sigmoid"
    dy = t(nb, m, n)
    calls = []

    def counted(*args, **kw):
        calls.append(kw.get("activation", "none"))
        return batched_matmul_ref(*args, **kw)
    monkeypatch.setattr(BK, "batched_matmul_cuda", counted)
    leaves = [x.clone().requires_grad_() for x in (a, b)]
    lb = bias.clone().requires_grad_() if bias is not None else None
    y = bops._BatchedCuda.apply(*leaves, lb, act, alpha, None, 0)
    y.backward(dy)
    got = [x.grad for x in leaves] + ([lb.grad] if lb is not None else [])
    assert calls == [act] + ["none"] * (3 if case in ("silu", "bias_gelu")
                                        else 2)
    ref = [x.clone().requires_grad_() for x in (a, b)]
    rb = bias.clone().requires_grad_() if bias is not None else None
    batched_matmul_ref(*ref, rb, activation=act, alpha=alpha).backward(dy)
    want = [x.grad for x in ref] + ([rb.grad] if rb is not None else [])
    for name, g, w in zip(("da", "db", "dbias"), got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=name)


def test_batched_backward_is_the_expert_einsums_gradient():
    """The MoE's expert GEMMs differentiate as the reference's XLA einsum
    ``gecd,edf->gecf`` does: the batched backward's dB of (E, G * cap, D)
    rows against (E, D, F) weights is the einsum's weight gradient."""
    rng = np.random.default_rng(5)
    e, rows, d, f = 4, 6, 8, 5
    x = torch.from_numpy(rng.standard_normal((e, rows, d)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((e, d, f)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((e, rows, f)).astype(
        np.float32))
    da, db, _ = bops.batched_bwd(batched_matmul_ref, x, w, None, None, g,
                                 activation="none", alpha=1.0)
    torch.testing.assert_close(db, torch.einsum("erd,erf->edf", x, g),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(da, torch.einsum("erf,edf->erd", g, w),
                               atol=1e-5, rtol=1e-5)
    xp = F.pad(x, (0, 0, 0, 2))     # discard rows of zeros add nothing
    gp = F.pad(g, (0, 0, 0, 2))
    _, dbp, _ = bops.batched_bwd(batched_matmul_ref, xp, w, None, None, gp,
                                 activation="none", alpha=1.0)
    torch.testing.assert_close(dbp, db, atol=1e-6, rtol=1e-6)

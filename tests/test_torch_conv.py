"""The port's direct convolution and ResNet against the JAX package.

``conv2d_ref`` is held against the reference's ``conv2d_pallas`` in
interpret mode (the four cases of ``tests/test_paper_primitives.py``) and
against the paper's loop nest (``conv2d_loops_ref``), at 1e-4: fp32 on
both sides, sums in other orders.  ``conv2d_bwd``, the dual-convolution
backward the kernel path runs, is run on the plain convolution and GEMM
and held against ``jax.vjp`` of the reference's ``conv2d`` on its Pallas
backend (interpret mode), whose custom VJP is the dual convolution through
the Pallas kernel, at 1e-3, the band of the reference's own
``test_conv_dual_backward``: this is what pins the dilation, the extra
bottom/right pad and the flip/swap of w without a card.

A reduced ResNet (width 4, one block a stage, 10 classes, 2 images of
64x64, the image size of ``examples/resnet50_forward.py``) runs on weights
drawn with numpy in the reference's tree, carried into the port by
``resnet_params_from_numpy``, against the reference's
``resnet.forward(..., backend="xla")`` and ``jax.value_and_grad``: logits
and loss at 1e-4, gradients leaf by leaf at 1e-3.  Not 32x32: there the
last stage is 1x1, so each of its normalisations averages N*H*W = 2
values per channel, and with some hundreds of channels one pair nearly
coincides (batch variance ~1e-5, the eps), where x_hat = d / sqrt(d^2 +
eps) turns fp32 rounding into 1e-4 errors: on such a draw both packages'
logits miss a float64 evaluation by 8e-5 (the port) and 2e-4 (the
reference).  At 64x64 the last stage normalises 8 values a channel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import conv2d as jconv2d
from repro.kernels.conv2d import ref as jref
from repro.kernels.conv2d.kernel import conv2d_pallas
from repro.models import resnet as jresnet
from repro_torch.interop import (resnet_params_from_numpy,
                                 resnet_params_to_numpy)
from repro_torch.kernels.brgemm import matmul_ref
from repro_torch.kernels.conv2d import (conv2d, conv2d_bwd, conv2d_loops_ref,
                                        conv2d_ref)
from repro_torch.models import resnet

RNG = np.random.default_rng(13)
F32 = dict(atol=1e-4, rtol=1e-4)
DUAL = dict(atol=1e-3, rtol=1e-3)


def randn(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# The four cases of tests/test_paper_primitives.py::test_conv_pallas_...
CASES = [
    dict(n=1, h=8, w=8, c=4, k=8, r=3, s=3, stride=1, padding=1),
    dict(n=2, h=10, w=10, c=6, k=5, r=3, s=3, stride=2, padding=1),
    dict(n=1, h=6, w=6, c=3, k=4, r=1, s=1, stride=1, padding=0),
    dict(n=1, h=9, w=9, c=3, k=4, r=7, s=7, stride=2, padding=3),
]


def _case_inputs(case):
    x = randn(case["n"], case["h"], case["w"], case["c"])
    w = randn(case["r"], case["s"], case["c"], case["k"], scale=0.2)
    return x, w, randn(case["k"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "{r}x{s}s{stride}p"
                         "{padding}".format(**c))
def test_conv2d_ref_matches_pallas_interpret(case):
    x, w, b = _case_inputs(case)
    kw = dict(stride=case["stride"], padding=case["padding"])
    got = conv2d_ref(t(x), t(w), t(b), activation="relu", **kw)
    want = conv2d_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         activation="relu", interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("case", CASES + [
    dict(n=1, h=6, w=6, c=2, k=4, r=3, s=3, stride=2, padding=1)],
    ids=lambda c: "{r}x{s}s{stride}p{padding}".format(**c))
def test_conv2d_ref_matches_loop_nest(case):
    x, w, _ = _case_inputs(case)
    kw = dict(stride=case["stride"], padding=case["padding"])
    loops = conv2d_loops_ref(x, w, **kw)
    np.testing.assert_array_equal(loops,
                                  np.asarray(jref.conv2d_loops_ref(x, w,
                                                                   **kw)))
    np.testing.assert_allclose(conv2d(t(x), t(w), **kw).numpy(), loops,
                               **F32)


# (N, H, C, K, R, stride, padding, activation): 1x1, 3x3 and 7x7 windows at
# strides 1 and 2; odd sizes where the dual needs its extra pad; one
# activation read from the output, one from the recomputed pre-activation.
DUAL_CASES = [
    (2, 6, 4, 8, 1, 1, 0, "none"),
    (2, 7, 4, 6, 1, 2, 0, "relu"),
    (1, 6, 3, 5, 3, 1, 1, "silu"),
    (2, 7, 4, 8, 3, 2, 1, "relu"),
    (1, 9, 3, 4, 7, 2, 3, "none"),
]


@pytest.mark.parametrize("n,h,c,k,r,stride,padding,activation", DUAL_CASES)
def test_conv_dual_backward_matches_reference(n, h, c, k, r, stride,
                                              padding, activation):
    x, w = randn(n, h, h, c), randn(r, r, c, k, scale=(c * r * r) ** -0.5)
    b = randn(k)
    kw = dict(stride=stride, padding=padding, activation=activation)

    def jf(x, w, b):
        return jconv2d(x, w, b, backend="pallas", **kw)

    y_ref, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dy = randn(*y_ref.shape)
    want = vjp(jnp.asarray(dy))
    y = conv2d_ref(t(x), t(w), t(b), **kw)
    got = conv2d_bwd(conv2d_ref, matmul_ref, t(x), t(w), t(b), y, t(dy),
                     **kw)
    for name, g, gw in zip(("dx", "dw", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw), err_msg=name,
                                   **DUAL)
    # The stem's image takes no gradient: no dual convolution runs.
    calls = []

    def counted(*a, **k_):
        calls.append(1)
        return conv2d_ref(*a, **k_)

    dx, dw, _ = conv2d_bwd(counted, matmul_ref, t(x), t(w), t(b), y, t(dy),
                           needs=(False, True, True), **kw)
    assert dx is None and dw is not None
    assert len(calls) == (activation == "silu")   # only the recompute


@pytest.mark.parametrize("h,w", [(6, 6), (7, 7), (8, 5), (1, 2)])
def test_max_pool_matches_reduce_window(h, w):
    x = randn(2, h, w, 3)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = resnet.max_pool(t(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CFG = resnet.ResNetCfg(n_classes=10, width=4, stage_blocks=(1, 1, 1, 1))
JCFG = jresnet.ResNetCfg(n_classes=10, width=4, stage_blocks=(1, 1, 1, 1))


def _reference_tree(rng):
    """Weights for the reference's tree, drawn with numpy at its init
    scales (its structure from ``jax.eval_shape``, which runs nothing)."""
    shapes = jax.eval_shape(lambda: jresnet.init_params(
        jax.random.PRNGKey(0), JCFG))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "'scale'" in name:
            return np.ones(s.shape, np.float32)
        if "'bias'" in name or "'b'" in name:
            return np.zeros(s.shape, np.float32)
        fan_in = np.prod(s.shape[:-1])
        gain = 1.0 if "'head'" in name else 2.0
        return (rng.normal(size=s.shape) * (gain / fan_in) ** 0.5
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_resnet_params_round_trip_and_checks():
    tree = _reference_tree(np.random.default_rng(0))
    params = resnet_params_from_numpy(tree, CFG, device="cpu")
    back = resnet_params_to_numpy(params)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    bad = resnet_params_to_numpy(params)
    bad["stages"][1].append(bad["stages"][1][0])
    with pytest.raises(ValueError, match="entries"):
        resnet_params_from_numpy(bad, CFG, device="cpu")
    bad = resnet_params_to_numpy(params)
    del bad["stages"][0][0]["proj"]
    with pytest.raises(ValueError, match="keys"):
        resnet_params_from_numpy(bad, CFG, device="cpu")


def test_resnet_matches_reference():
    rng = np.random.default_rng(5)
    tree = _reference_tree(rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    labels = np.array([1, 7], np.int32)

    def jloss(p):
        logits = jresnet.forward(p, jnp.asarray(x), JCFG, backend="xla")
        loss = -jax.nn.log_softmax(logits)[jnp.arange(2), labels].mean()
        return loss, logits

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree.map(jnp.asarray, tree))

    params = resnet_params_from_numpy(tree, CFG, device="cpu")
    logits = resnet.forward(params, t(x), CFG)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **F32)
    loss, grads = resnet.loss_and_grads(params, t(x), t(labels), CFG)
    np.testing.assert_allclose(float(loss), float(want_loss), **F32)
    want = resnet_params_from_numpy(jax.tree.map(np.asarray, want_grads),
                                    CFG, device="cpu")
    for (name, g), (_, gw) in zip(resnet.named_leaves(grads),
                                  resnet.named_leaves(want)):
        np.testing.assert_allclose(g.numpy(), gw.numpy(), err_msg=name,
                                   **DUAL)

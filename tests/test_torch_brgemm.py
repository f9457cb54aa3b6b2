"""The port's stacked and batched batch-reduce GEMMs against the JAX
package.

``brgemm_ref`` and ``batched_matmul_ref`` (with A broadcast, B broadcast
and neither) are held against the reference's plain versions and against
``brgemm_stacked_pallas`` / ``batched_matmul_pallas`` in interpret mode,
at 3e-5 (fp32 on both sides, sums in other orders; the band the
reference's own pallas-vs-xla GEMM tests use).  ``brgemm``'s gradients are
held against ``jax.vjp`` of the reference's ``brgemm`` on its Pallas
backend (interpret mode), whose custom VJP is the batched kernel twice, at
2e-4 (a gradient is a second product over the first one's rounding): both
through plain autograd on the ``"torch"`` backend and through
``brgemm_bwd`` on the plain versions, the backward the kernel path runs,
which reads B_i^T and A_i^T as transposed views.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.brgemm import kernel as jkernel
from repro.kernels.brgemm import ref as jref
from repro.kernels.brgemm.ops import brgemm as jbrgemm
from repro_torch.core.brgemm import batched_matmul, brgemm
from repro_torch.kernels.brgemm import (batched_matmul_ref, brgemm_bwd,
                                        brgemm_ref)

RNG = np.random.default_rng(17)
F32 = dict(atol=3e-5, rtol=3e-5)
GRAD = dict(atol=2e-4, rtol=2e-4)


def randn(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(nb=3, m=9, k=40, n=24):
    return (randn(nb, m, k), randn(nb, k, n, scale=(nb * k) ** -0.5),
            randn(n), randn(m, n))


@pytest.mark.parametrize("activation,epilogue", [
    ("none", "plain"), ("relu", "bias"), ("gelu", "c0"),
    ("tanh", "bias+c0")])
def test_brgemm_ref_matches_reference_and_pallas(activation, epilogue):
    a, b, bias, c0 = _operands()
    use_bias, use_c0 = "bias" in epilogue, "c0" in epilogue
    kw = dict(activation=activation, alpha=0.75, beta=0.5 if use_c0 else 0.0)
    got = brgemm_ref(t(a), t(b), t(bias) if use_bias else None,
                     c0=t(c0) if use_c0 else None, **kw).numpy()
    jargs = (jnp.asarray(a), jnp.asarray(b),
             jnp.asarray(c0) if use_c0 else None,
             jnp.asarray(bias) if use_bias else None)
    np.testing.assert_allclose(got, np.asarray(jref.brgemm_ref(*jargs, **kw)),
                               **F32)
    np.testing.assert_allclose(
        got, np.asarray(jkernel.brgemm_stacked_pallas(*jargs, interpret=True,
                                                      **kw)), **F32)


@pytest.mark.parametrize("bcast", ["none", "a", "b"])
@pytest.mark.parametrize("activation,use_bias", [("none", False),
                                                 ("sigmoid", True)])
def test_batched_matmul_ref_matches_reference_and_pallas(bcast, activation,
                                                         use_bias):
    a, b, bias, _ = _operands(nb=4, m=10, k=24, n=17)
    a = a[0] if bcast == "a" else a
    b = b[0] if bcast == "b" else b
    kw = dict(activation=activation, alpha=1.25)
    got = batched_matmul_ref(t(a), t(b), t(bias) if use_bias else None,
                             **kw).numpy()
    assert got.shape == (4, 10, 17)
    jargs = (jnp.asarray(a), jnp.asarray(b),
             jnp.asarray(bias) if use_bias else None)
    np.testing.assert_allclose(
        got, np.asarray(jref.batched_matmul_ref(*jargs, **kw)), **F32)
    np.testing.assert_allclose(
        got, np.asarray(jkernel.batched_matmul_pallas(*jargs, interpret=True,
                                                      **kw)), **F32)
    np.testing.assert_allclose(
        batched_matmul(t(a), t(b), t(bias) if use_bias else None,
                       **kw).numpy(), got, **F32)


@pytest.mark.parametrize("activation,epilogue", [
    ("none", "plain"), ("relu", "bias+c0"), ("gelu", "bias"),
    ("sigmoid", "c0")])
def test_brgemm_grads_match_reference_pallas_vjp(activation, epilogue):
    a, b, bias, c0 = _operands(nb=3, m=9, k=16, n=12)
    dy = randn(9, 12)
    use_bias, use_c0 = "bias" in epilogue, "c0" in epilogue
    kw = dict(activation=activation, alpha=1.5, beta=0.25 if use_c0 else 0.0)
    leaves = {"a": a, "b": b}
    if use_bias:
        leaves["bias"] = bias
    if use_c0:
        leaves["c0"] = c0

    def jf(*args):
        p = dict(zip(leaves, args))
        return jbrgemm(p["a"], p["b"], p.get("bias"), p.get("c0"),
                       backend="pallas", **kw)

    _, vjp = jax.vjp(jf, *(jnp.asarray(v) for v in leaves.values()))
    want = dict(zip(leaves, vjp(jnp.asarray(dy))))

    tl = {k: t(v).requires_grad_() for k, v in leaves.items()}
    y = brgemm(tl["a"], tl["b"], tl.get("bias"), tl.get("c0"),
               backend="torch", **kw)
    autograd = dict(zip(tl, torch.autograd.grad(y, list(tl.values()),
                                                t(dy))))
    y = y.detach()
    manual = brgemm_bwd(brgemm_ref, batched_matmul_ref, t(a), t(b),
                        t(bias) if use_bias else None,
                        t(c0) if use_c0 else None, y, t(dy), **kw)
    manual = dict(zip(("a", "b", "bias", "c0"), manual))
    for key in leaves:
        np.testing.assert_allclose(autograd[key].numpy(),
                                   np.asarray(want[key]), err_msg=key, **GRAD)
        np.testing.assert_allclose(manual[key].numpy(),
                                   np.asarray(want[key]), err_msg=key, **GRAD)
    if not use_bias:
        assert manual["bias"] is None

"""Card-only tests of the port's CUDA kernels, of serving and of training
through them.

Marked ``gpu``; each test skips without a CUDA device (decided in a
fixture, so every test collects alike everywhere).  This file imports no
JAX: the machine with the card has none.  Run them there with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Tolerances as in ``chip_smoke.py``: fp32 sums in different orders
(1e-4), one bf16 ulp for bf16 outputs (1e-2), a few for bf16 attention
(2e-2).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import dispatch, fusion
from repro_torch.kernels.brgemm import matmul, matmul_cuda, matmul_ref
from repro_torch.kernels.flash_attention import (delta_rowsum_cuda,
                                                 delta_rowsum_ref,
                                                 flash_attention,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_cuda,
                                                 mha_ref)
from repro_torch.models import api
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train.optimizer import AdamWCfg
from repro_torch.train.train_step import init_state, make_train_step

pytestmark = pytest.mark.gpu
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture(autouse=True)
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,trans", [
    (64, 64, 64, False), (8, 576, 192, False), (77, 100, 133, False),
    (9, 96, 1000, True)])
def test_matmul_kernel(gen, dtype, m, k, n, trans):
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    w = torch.randn(n, k, device="cuda", generator=gen).to(dtype).T \
        if trans else torch.randn(k, n, device="cuda", generator=gen).to(dtype)
    torch.testing.assert_close(matmul_cuda(x, w), matmul_ref(x, w),
                               **TOL[dtype])


@pytest.mark.parametrize("activation", list(fusion.ACTIVATIONS))
def test_matmul_kernel_epilogue(gen, activation):
    x = torch.randn(33, 64, device="cuda", generator=gen)
    w = torch.randn(64, 40, device="cuda", generator=gen) / 8
    bias = torch.randn(40, device="cuda", generator=gen)
    c0 = torch.randn(33, 40, device="cuda", generator=gen)
    kw = dict(activation=activation, alpha=0.5, beta=0.7)
    torch.testing.assert_close(matmul_cuda(x, w, bias, c0, **kw),
                               matmul_ref(x, w, bias, c0=c0, **kw),
                               **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,window", [(64, 64, None), (100, 32, None),
                                        (130, 128, 40)])
def test_flash_kernel(gen, dtype, t, d, window):
    q = torch.randn(2, t, 4, d, device="cuda", generator=gen
                    ).to(dtype).transpose(1, 2)
    k, v = (torch.randn(2, 2, t, d, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, window=window,
                                  return_residuals=True)
    ro, rl = mha_ref(q, k, v, window=window, return_lse=True)
    tol = TOL[dtype] if dtype == torch.float32 else dict(atol=2e-2,
                                                         rtol=2e-2)
    torch.testing.assert_close(o, ro, **tol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)


def test_engine_kernels_match_plain_greedy(gen):
    cfg = configs.get("smollm-135m").reduced()
    params = api.init_params(cfg, gen)
    engine = Engine(cfg, params, ServeConfig(max_len=32))
    tokens = torch.randint(0, cfg.vocab, (2, 9), device="cuda",
                           generator=gen)
    matmul_cuda.launches = flash_attention_cuda.launches = 0
    got = engine.generate({"tokens": tokens}, n_tokens=6, stop_tokens=())
    assert matmul_cuda.launches == (cfg.n_layers * 7 + 1) * 6
    assert flash_attention_cuda.launches == cfg.n_layers
    with dispatch.use(backend="torch"):
        want = engine.generate({"tokens": tokens}, n_tokens=6,
                               stop_tokens=())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# Gradients, kernels against plain autograd.  fp32: sums in different
# orders (1e-4 relative to the largest entry).  bf16: the kernel rounds
# alpha * g, P and dS to bf16 before each product, the plain version
# differentiates in fp32 and rounds once; both round the result to bf16
# (3e-2 relative to the largest entry, a few bf16 ulps).
GRAD_BAND = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _rel_close(got, want, band, what):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= band * max(scale, 1e-6), f"{what}: {err} vs {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation,table", [("none", False),
                                              ("silu", False),
                                              ("tanh", False),
                                              ("none", True)])
def test_matmul_gradients_match_plain_autograd(gen, dtype, activation,
                                               table):
    m, k, n = 130, 96, 200
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(n, k, device="cuda", generator=gen) / 10).to(dtype) \
        if table else (torch.randn(k, n, device="cuda", generator=gen)
                       / 10).to(dtype)
    bias = torch.randn(n, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    grads = {}
    for backend in ("cuda", "torch"):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, bias)]
        wt = leaves[1].T if table else leaves[1]
        launches = matmul_cuda.launches
        y = matmul(leaves[0], wt, leaves[2], activation=activation,
                   alpha=0.5, backend=backend)
        grads[backend] = torch.autograd.grad(y, leaves, dy)
        # forward, dx, dw, and the pre-activation recompute for silu
        expect = 3 + fusion.needs_preact(activation) if backend == "cuda" \
            else 0
        assert matmul_cuda.launches - launches == expect
    for name, got, want in zip(("dx", "dw", "dbias"), grads["cuda"],
                               grads["torch"]):
        assert got.dtype == want.dtype == dtype
        _rel_close(got, want, GRAD_BAND[dtype], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,hq,hkv,d,window", [(64, 4, 2, 64, None),
                                               (100, 3, 1, 32, None),
                                               (130, 2, 2, 128, 40)])
def test_flash_backward_matches_plain(gen, dtype, t, hq, hkv, d, window):
    q = torch.randn(2, t, hq, d, device="cuda", generator=gen
                    ).to(dtype).transpose(1, 2)
    k, v = (torch.randn(2, hkv, t, d, device="cuda", generator=gen
                        ).to(dtype) for _ in range(2))
    dy = torch.randn(2, t, hq, d, device="cuda", generator=gen
                     ).to(dtype).transpose(1, 2)
    o, lse = flash_attention_cuda(q, k, v, window=window,
                                  return_residuals=True)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, dy, window=window,
                                   return_delta=True)
    want = flash_attention_bwd_ref(q, k, v, o, lse, dy, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _rel_close(g, w, GRAD_BAND[dtype], name)
    torch.testing.assert_close(got[3], delta_rowsum_cuda(o, dy), atol=0,
                               rtol=0)
    torch.testing.assert_close(got[3], delta_rowsum_ref(o, dy), atol=1e-4,
                               rtol=1e-4)
    # Through autograd: one backward call, its two launches counted as one.
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    calls = flash_attention_bwd_cuda.launches
    out = flash_attention(*leaves, window=window)
    ad = torch.autograd.grad(out, leaves, dy)
    assert flash_attention_bwd_cuda.launches - calls == 1
    for g, w in zip(ad, got[:3]):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_non_causal_ragged(gen, dtype):
    """Non-causal, Tq != Tk, neither a multiple of the 64-row tile."""
    q = torch.randn(2, 6, 50, 64, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(2, 3, 130, 64, device="cuda", generator=gen
                        ).to(dtype) for _ in range(2))
    dy = torch.randn(2, 6, 50, 64, device="cuda", generator=gen).to(dtype)
    o, lse = flash_attention_cuda(q, k, v, causal=False,
                                  return_residuals=True)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, dy, causal=False)
    want = flash_attention_bwd_ref(q, k, v, o, lse, dy, causal=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _rel_close(g, w, GRAD_BAND[dtype], name)


def test_backward_of_a_sum(gen):
    """A gradient with zero strides (a sum's broadcast) reaches the
    backward kernels too."""
    q, k, v = (torch.randn(1, 2, 70, 64, device="cuda", generator=gen)
               for _ in range(3))
    x = torch.randn(40, 24, device="cuda", generator=gen)
    table = torch.randn(32, 24, device="cuda", generator=gen) / 5
    grads = []
    for backend in ("cuda", "torch"):
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        xw = [a.detach().clone().requires_grad_() for a in (x, table)]
        (flash_attention(*leaves, backend=backend).sum()
         + matmul(xw[0], xw[1].T, activation="tanh", backend=backend).sum()
         ).backward()
        grads.append([a.grad for a in leaves + xw])
    for g, w_ in zip(*grads):
        _rel_close(g, w_, GRAD_BAND[torch.float32], "sum")


def test_train_step_kernels_match_plain(gen):
    cfg = configs.get("smollm-135m").reduced()
    ocfg = AdamWCfg()
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 70), device="cuda",
                                     generator=gen)}
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    losses = {}
    for backend in ("cuda", "torch"):
        state = init_state(cfg, ocfg, torch.Generator().manual_seed(0),
                           "cuda")
        state["opt"]["step"] = 1500          # a non-zero learning rate
        step = make_train_step(cfg, ocfg, backend=backend)
        before = (matmul_cuda.launches, flash_attention_cuda.launches,
                  flash_attention_bwd_cuda.launches)
        losses[backend] = [float(step(state, batch)[1]["loss"])
                           for _ in range(2)]
        after = (matmul_cuda.launches, flash_attention_cuda.launches,
                 flash_attention_bwd_cuda.launches)
        per_layer = 7
        expect = ((3 * (per_layer * cfg.n_layers + 1) + cfg.n_layers) * 2,
                  cfg.n_layers * 2, cfg.n_layers * 2) \
            if backend == "cuda" else (0, 0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == expect
    np.testing.assert_allclose(losses["cuda"], losses["torch"], atol=1e-4,
                               rtol=0)

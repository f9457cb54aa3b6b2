"""Card-only tests of the port's CUDA kernels, of serving (static and
continuous batching) and of training through them, of ResNet-50's path (the convolution, the stacked and
batched GEMMs), and of the quantized GEMMs and serving tiers.

Marked ``gpu``; each test skips without a CUDA device (decided in a
fixture, so every test collects alike everywhere).  This file imports no
JAX: the machine with the card has none.  Run them there with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Tolerances as in ``chip_smoke.py``: fp32 sums in different orders
(1e-4), one bf16 ulp for bf16 outputs (1e-2), a few for bf16 attention
(2e-2).  The quantized GEMMs: int8 with no activation exactly (the int32
sum is exact and the epilogue rounds as the plain version's), fp8 as the
fp32 GEMM's sums (1e-4), one bf16 ulp for bf16 out or an activation's ulp.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import blocking, dispatch, fusion
from repro_torch import quant
from repro_torch.kernels.brgemm import (batched_matmul, batched_matmul_cuda,
                                        batched_matmul_q_cuda,
                                        batched_matmul_q_ref,
                                        batched_matmul_ref, brgemm,
                                        brgemm_q_cuda, brgemm_q_ref,
                                        brgemm_ref, brgemm_stacked_cuda,
                                        matmul, matmul_cuda, matmul_q_cuda,
                                        matmul_q_ref, matmul_ref)
from repro_torch.kernels.brgemm.kernel import (plan_batched_call, plan_call,
                                               plan_stacked_call,
                                               reset_matmul_counts)
from repro_torch.kernels.brgemm.quant_kernel import (plan_q_batched_call,
                                                     plan_q_call,
                                                     plan_q_stacked_call,
                                                     reset_quant_counts)
from repro_torch.kernels.conv2d import (conv2d, conv2d_cuda, conv2d_ref,
                                        dual_operands)
from repro_torch.kernels.conv2d.kernel import (plan_conv_call,
                                               reset_conv_counts)
from repro_torch.kernels.conv2d.ops import patches
from repro_torch.kernels.flash_attention import bwd as FB
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import (delta_rowsum_cuda,
                                                 delta_rowsum_ref,
                                                 flash_attention,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_cuda,
                                                 mha_ref,
                                                 reset_flash_bwd_counts)
from repro_torch.models import api, resnet
from repro_torch.serve import (ContinuousEngine, Engine, PoolConfig, Request,
                               ServeConfig)
from repro_torch.train.optimizer import AdamWCfg
from repro_torch.train.train_step import init_state, make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the path's list of ResNet-50's convolutions)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture(autouse=True)
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False      # the plain fp32 conv
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


def _operands(gen, m, k, n, dtype, xt, wt, pad=0):
    """x (m, k) and w (k, n), row- or column-major, rows ``pad`` elements
    longer than they need to be (pad < 0: rounded up to a multiple of
    8)."""
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    def rows(inner):
        return -(-inner // 8) * 8 if pad < 0 else inner + pad
    x = randn(k, rows(m))[:, :m].T if xt else randn(m, rows(k))[:, :k]
    w = (randn(n, rows(k), scale=k ** -0.5)[:, :k].T if wt
         else randn(k, rows(n), scale=k ** -0.5)[:, :n])
    return x, w


# (m, k, n): one tile's worth of k (no split) and a long k (split).
PLAN_SHAPES = [(304, 576, 576), (96, 4096, 200)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
@pytest.mark.parametrize("xt,wt", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_matmul_layouts_split_and_not(gen, dtype, m, k, n, xt, wt):
    x, w = _operands(gen, m, k, n, dtype, xt, wt)
    p = plan_call(x, w)
    assert p.mainloop == ("wgmma" if dtype == torch.bfloat16 else "simt")
    assert (p.splits > 1) == (k == 4096)
    reset_matmul_counts()
    got = matmul_cuda(x, w)
    assert matmul_cuda.mainloops[p.mainloop] == 1
    assert matmul_cuda.split_launches == (p.splits > 1)
    torch.testing.assert_close(got, matmul_ref(x, w), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
@pytest.mark.parametrize("activation", list(fusion.ACTIVATIONS))
def test_matmul_epilogues_split_and_not(gen, dtype, m, k, n, activation):
    i = list(fusion.ACTIVATIONS).index(activation)
    x, w = _operands(gen, m, k, n, dtype, i % 2, i // 2 % 2)
    bias = torch.randn(n, device="cuda", generator=gen).to(dtype)
    c0 = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    for out_dtype in (None, torch.float32):
        kw = dict(activation=activation, alpha=0.5, beta=0.75,
                  out_dtype=out_dtype)
        torch.testing.assert_close(
            matmul_cuda(x, w, bias, c0, **kw),
            matmul_ref(x, w, bias, c0=c0, **kw),
            **TOL[out_dtype or dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,xt,wt,pad,mainloop", [
    (77, 100, 133, 0, 0, -1, "wgmma"),     # ragged, rows padded to 8
    (77, 100, 133, 1, 1, 3, "wmma"),       # rows 80 and 103 apart
    (96, 4096, 200, 1, 0, 3, "wmma"),      # the same, split
])
def test_matmul_ragged_and_unaligned(gen, dtype, m, k, n, xt, wt, pad,
                                     mainloop):
    x, w = _operands(gen, m, k, n, dtype, xt, wt, pad)
    assert plan_call(x, w).mainloop == (
        mainloop if dtype == torch.bfloat16 else "simt")
    torch.testing.assert_close(matmul_cuda(x, w), matmul_ref(x, w),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_stem_weight_gradient_against_float64(gen, dtype):
    """ResNet-50's stem wgrad at N = 32: k = 401,408 into a (147, 64)
    fp32 output, the window operand read transposed through its padded
    rows; against float64 within the fp32 summation bound (1e-4 of the
    largest |output| + 4 sqrt(k) 2^-24 (|A| |B|), as chip_smoke.py)."""
    x = torch.randn(32, 224, 224, 3, device="cuda", generator=gen).to(dtype)
    cols = patches(x, 7, 7, 2, 3)
    g = (torch.randn(cols.size(0), 64, device="cuda", generator=gen)
         * 1e-2).to(dtype)
    assert plan_call(cols.T, g).splits > 1
    got = matmul_cuda(cols.T, g, out_dtype=torch.float32).double()
    truth = cols.T.double() @ g.double()
    bound = (1e-4 * truth.abs().max() + 4 * cols.size(0) ** 0.5 * 2.0 ** -24
             * (cols.T.double().abs() @ g.double().abs()))
    assert bool(((got - truth).abs() <= bound).all())


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


# Continuous batching at the reduced width in fp32, each pool on the
# kernels against the plain path: the same greedy tokens (int8 pages: all
# requests but at most one, the bound the reference's own test of int8
# pages uses, since an int8 rounding can flip a near-tie), and launch
# counts from the engine's metrics (chip_smoke's rule).
CONT_POOLS = {"slotted": {}, "paged": {"page_size": 8},
              "preempting": {"page_size": 4, "n_pages": 8},
              "chunked": {"page_size": 4, "prefill_chunk": 8},
              "int8_pages": {"page_size": 8, "kv_quant": "int8"}}


@pytest.mark.parametrize("pool", sorted(CONT_POOLS))
def test_continuous_engine_kernels_match_plain(gen, pool):
    cfg = configs.get("smollm-135m").reduced()
    params = api.init_params(cfg, gen)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                    max_tokens=m, stop_tokens=())
            for n, m in zip([5, 20, 3, 17, 7], [6, 4, 8, 3, 5])]

    def serve():
        engine = ContinuousEngine(cfg, params, PoolConfig(
            n_slots=3, max_len=32, **CONT_POOLS[pool]))
        return engine, engine.serve(reqs)

    reset_matmul_counts()
    flash_attention_cuda.launches = 0
    engine, got = serve()
    launches = {"matmul": matmul_cuda.launches, "matmul_q": 0,
                "flash_attention": flash_attention_cuda.launches}
    assert launches == chip_smoke.expected_continuous_launches(
        cfg, engine, reqs)
    assert engine.pool.n_free == engine.pool.n_slots
    if pool == "preempting":
        assert engine.metrics.preemptions > 0
    with dispatch.use(backend="torch"):
        _, want = serve()
    assert matmul_cuda.launches == launches["matmul"]
    same = sum(got[r] == want[r] for r in want)
    assert same >= len(want) - (pool == "int8_pages")


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


def _band_close(got, want, dtype, what):
    """fp32: 1e-4 of the largest |output| (sums in other orders); bf16
    out: one bf16 ulp (the TOL band)."""
    if dtype == torch.float32 and got.dtype == torch.float32:
        scale = max(want.abs().max().item(), 1.0)
        torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=1e-4,
                                   msg=what)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[torch.bfloat16], msg=what)


# (N, H, C, K, R, stride, padding, activation, bias): the stem (C = 3,
# element-wise gather), 1x1 and 3x3 windows at strides 1 and 2, and ragged
# counts that leave every tile edge partly empty.
CONV_CASES = [
    (2, 37, 3, 64, 7, 2, 3, "none", False),
    (2, 14, 64, 256, 1, 1, 0, "none", False),
    (3, 15, 64, 128, 1, 2, 0, "relu", True),
    (2, 16, 64, 64, 3, 1, 1, "none", False),
    (2, 17, 128, 72, 3, 2, 1, "gelu", True),
    (1, 9, 12, 20, 3, 2, 1, "relu", True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,c,k,r,stride,padding,activation,use_bias",
                         CONV_CASES)
def test_conv2d_kernel(gen, dtype, n, h, c, k, r, stride, padding,
                       activation, use_bias):
    x = torch.randn(n, h, h, c, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(r, r, c, k, device="cuda", generator=gen)
         * (c * r * r) ** -0.5).to(dtype)
    bias = torch.randn(k, device="cuda", generator=gen).to(dtype) \
        if use_bias else None
    kw = dict(stride=stride, padding=padding, activation=activation)
    launches = conv2d_cuda.launches
    _band_close(conv2d_cuda(x, w, bias, **kw), conv2d_ref(x, w, bias, **kw),
                dtype, "conv")
    _band_close(conv2d_cuda(x, w, bias, out_dtype=torch.float32, **kw),
                conv2d_ref(x, w, bias, out_dtype=torch.float32, **kw),
                torch.float32, "conv fp32 out")
    assert conv2d_cuda.launches - launches == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,c,k,r,stride,padding,activation,use_bias",
                         CONV_CASES[1:])
def test_conv2d_gradients_match_plain_autograd(gen, dtype, n, h, c, k, r,
                                               stride, padding, activation,
                                               use_bias):
    x = torch.randn(n, h, h, c, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(r, r, c, k, device="cuda", generator=gen)
         * (c * r * r) ** -0.5).to(dtype)
    bias = torch.randn(k, device="cuda", generator=gen).to(dtype)
    kw = dict(stride=stride, padding=padding, activation=activation)
    grads = {}
    for backend in ("cuda", "torch"):
        leaves = [a.detach().clone().requires_grad_() for a in (x, w, bias)]
        y = conv2d(*leaves, backend=backend, **kw)
        dy = torch.randn(y.shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1)
                         ).to(dtype)
        before = conv2d_cuda.launches, matmul_cuda.launches
        grads[backend] = torch.autograd.grad(y, leaves, dy)
        # the dual conv (+ the gelu pre-activation recompute) and one wgrad
        expect = ((1 + (activation == "gelu"), 1) if backend == "cuda"
                  else (0, 0))
        assert (conv2d_cuda.launches - before[0],
                matmul_cuda.launches - before[1]) == expect
    for name, got, want in zip(("dx", "dw", "dbias"), grads["cuda"],
                               grads["torch"]):
        assert got.dtype == want.dtype == dtype
        _rel_close(got, want, GRAD_BAND[dtype], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,m,k,n,epilogue", [
    (16, 64, 64, 64, "plain"), (3, 77, 100, 133, "bias+c0"),
    (4, 300, 96, 40, "c0"), (8, 130, 1024, 96, "bias")])
def test_brgemm_stacked_kernel(gen, dtype, nb, m, k, n, epilogue):
    a = torch.randn(nb, m, k, device="cuda", generator=gen).to(dtype)
    b = (torch.randn(nb, k, n, device="cuda", generator=gen)
         * (nb * k) ** -0.5).to(dtype)
    bias = torch.randn(n, device="cuda", generator=gen).to(dtype) \
        if "bias" in epilogue else None
    c0 = torch.randn(m, n, device="cuda", generator=gen).to(dtype) \
        if "c0" in epilogue else None
    kw = dict(activation="tanh", alpha=0.5, beta=0.75 if c0 is not None
              else 0.0)
    reset_matmul_counts()
    _band_close(brgemm_stacked_cuda(a, b, bias, c0, **kw),
                brgemm_ref(a, b, bias, c0=c0, **kw), dtype, "brgemm")
    # column-major entries, read in place
    at, bt = a.transpose(1, 2).contiguous().transpose(1, 2), \
        b.transpose(1, 2).contiguous().transpose(1, 2)
    _band_close(brgemm_stacked_cuda(at, bt, bias, c0, **kw),
                brgemm_ref(a, b, bias, c0=c0, **kw), dtype, "brgemm^T")
    assert brgemm_stacked_cuda.launches == 2
    # each call on its plan's mainloop (k = 100: rows TMA cannot read)
    planned = [plan_stacked_call(a, b).mainloop,
               plan_stacked_call(at, bt).mainloop]
    assert sum(brgemm_stacked_cuda.mainloops.values()) == 2
    for mainloop in planned:
        assert brgemm_stacked_cuda.mainloops[mainloop] >= 1
    if dtype == torch.float32:
        assert planned == ["simt", "simt"]


# The paper's cases (chip_smoke.py's BRGEMM_CASES) and a ragged one.
STACKED_CASES = [(16, 64, 64, 64), (32, 128, 128, 128), (64, 64, 256, 64),
                 (8, 4096, 1024, 1024), (5, 70, 100, 130)]


@pytest.mark.parametrize("layout", ["row-major", "column-major"])
@pytest.mark.parametrize("epilogue", ["plain", "bias c0 gelu"])
@pytest.mark.parametrize("nb,m,k,n", STACKED_CASES)
def test_brgemm_stacked_wgmma(gen, nb, m, k, n, epilogue, layout):
    """bf16 brgemm_stacked on the wgmma mainloop with the batch folded into
    the reduction, split (the paper's small cases) or not, rows padded to
    8 elements (k = 100: each entry's zero fill), with and without bias,
    C0 and gelu, both operands row- or column-major; two calls give the
    same bits (the splits' partials are added in split order)."""
    bf = torch.bfloat16
    col = layout == "column-major"
    a = _entries(gen, nb, m, k, col, bf)
    b = _entries(gen, nb, k, n, col, bf, (nb * k) ** -0.5)
    kw = {}
    if epilogue != "plain":
        kw = dict(bias=torch.randn(n, device="cuda", generator=gen).to(bf),
                  c0=torch.randn(m, n, device="cuda", generator=gen).to(bf),
                  activation="gelu", alpha=0.5, beta=0.75)
    p = plan_stacked_call(a, b)
    assert p.mainloop == "wgmma"
    reset_matmul_counts()
    got = brgemm_stacked_cuda(a, b, **kw)
    _band_close(got, brgemm_ref(a, b, **kw), bf, f"{layout} {epilogue}")
    torch.testing.assert_close(brgemm_stacked_cuda(a, b, **kw), got, atol=0,
                               rtol=0)
    assert brgemm_stacked_cuda.mainloops == {"wgmma": 2, "wmma": 0,
                                             "simt": 0}
    assert brgemm_stacked_cuda.split_launches == 2 * (p.splits > 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bcast", ["none", "a", "b"])
@pytest.mark.parametrize("trans", [False, True])
def test_batched_matmul_kernel(gen, dtype, bcast, trans):
    nb, m, k, n = 5, 70, 96, 130
    a = torch.randn(nb, m, k, device="cuda", generator=gen).to(dtype)
    b = (torch.randn(nb, k, n, device="cuda", generator=gen)
         * k ** -0.5).to(dtype)
    if trans:   # the swapaxes(-1, -2) views of brgemm's backward
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
        b = b.transpose(1, 2).contiguous().transpose(1, 2)
    a = a[0] if bcast == "a" else a
    b = b[0] if bcast == "b" else b
    bias = torch.randn(n, device="cuda", generator=gen)
    launches = batched_matmul_cuda.launches
    got = batched_matmul_cuda(a, b, bias, activation="relu", alpha=2.0)
    assert got.shape == (nb, m, n) and got.dtype == dtype
    _band_close(got, batched_matmul_ref(a, b, bias, activation="relu",
                                        alpha=2.0), dtype, "batched")
    assert batched_matmul_cuda.launches - launches == 1


def _entries(gen, nb, r, c, col_major, dtype, scale=1.0):
    """(nb, r, c) entries (2-D for nb = 0), row- or column-major, memory
    rows padded to a multiple of 8 elements (TMA-legal)."""
    inner, outer = (r, c) if col_major else (c, r)
    lead = (nb,) if nb else ()
    buf = (torch.randn(*lead, outer, -(-inner // 8) * 8, device="cuda",
                       generator=gen) * scale).to(dtype)[..., :inner]
    return buf.transpose(-1, -2) if col_major else buf


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("layout", ["A_i @ B_i", "A broadcast", "B broadcast",
                                    "dA = g B_i^T", "dB = A_i^T g",
                                    "both column-major"])
@pytest.mark.parametrize("nb,m,k,n", [(5, 70, 100, 136), (3, 200, 64, 72),
                                      (16, 64, 64, 64), (2, 130, 300, 257)])
def test_batched_matmul_wgmma(gen, nb, m, k, n, layout, out_dtype):
    """bf16 batched_matmul on the wgmma mainloop: ragged m, n and k (k not a
    multiple of 64: each entry's zero fill), a broadcast operand, both
    transposed views of brgemm's backward, bias, alpha and every
    activation, bf16 and fp32 out."""
    bf = torch.bfloat16
    a = _entries(gen, nb, m, k, False, bf)
    b = _entries(gen, nb, k, n, False, bf, k ** -0.5)
    g = _entries(gen, 0, m, n, False, bf)
    lhs, rhs = {
        "A_i @ B_i": (a, b),
        "A broadcast": (a[0], b),
        "B broadcast": (a, b[0]),
        "dA = g B_i^T": (g, b.transpose(1, 2)),
        "dB = A_i^T g": (a.transpose(1, 2), g),
        "both column-major": (_entries(gen, nb, m, k, True, bf),
                              _entries(gen, nb, k, n, True, bf, k ** -0.5)),
    }[layout]
    assert plan_batched_call(lhs, rhs).mainloop == "wgmma"
    reset_matmul_counts()
    got = batched_matmul_cuda(lhs, rhs, out_dtype=out_dtype)
    want = batched_matmul_ref(lhs, rhs, out_dtype=out_dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    _band_close(got, want, out_dtype or bf, layout)
    bias = torch.randn(rhs.size(-1), device="cuda", generator=gen).to(bf)
    for act in fusion.ACTIVATIONS:
        kw = dict(activation=act, alpha=0.5, out_dtype=out_dtype)
        _band_close(batched_matmul_cuda(lhs, rhs, bias, **kw),
                    batched_matmul_ref(lhs, rhs, bias, **kw),
                    out_dtype or bf, f"{layout} {act}")
    assert batched_matmul_cuda.mainloops == {
        "wgmma": 1 + len(fusion.ACTIVATIONS), "wmma": 0, "simt": 0}


def test_batched_matmul_tma_illegal_and_fp32_mainloops(gen):
    """Rows 36 apart (bf16): the wmma tile; fp32: simt; both against the
    plain version."""
    for dtype, want in ((torch.bfloat16, "wmma"), (torch.float32, "simt")):
        a = torch.randn(3, 77, 36, device="cuda", generator=gen).to(dtype)
        b = (torch.randn(3, 36, 200, device="cuda", generator=gen)
             / 6).to(dtype)
        reset_matmul_counts()
        _band_close(batched_matmul_cuda(a, b), batched_matmul_ref(a, b),
                    dtype, want)
        assert batched_matmul_cuda.mainloops[want] == 1


def _qkv(gen, b, hq, hkv, tq, tk, d, dtype=torch.bfloat16):
    """Head-split views, as the attention layer hands them over."""
    return tuple(torch.randn(b, t, h, d, device="cuda", generator=gen)
                 .to(dtype).transpose(1, 2)
                 for h, t in ((hq, tq), (hkv, tk), (hkv, tk)))


@pytest.mark.parametrize("tq,tk,hq,hkv,d,causal,window", [
    (200, 200, 4, 4, 64, True, None),      # causal, group 1, ragged T
    (130, 130, 6, 2, 32, True, 50),        # windowed, group 3
    (256, 256, 8, 2, 128, False, None),    # non-causal, group 4
    (150, 70, 4, 2, 64, False, 20),        # Tq > Tk, rows with no key
    (70, 150, 3, 1, 128, False, None),     # Tq < Tk
    (100, 230, 4, 2, 32, True, None),      # causal, Tq < Tk
    (64, 64, 2, 1, 64, True, None),        # one tile
])
def test_flash_forward_wgmma(gen, tq, tk, hq, hkv, d, causal, window):
    """The wgmma + TMA flash forward against mha_ref, on the attention
    layer's transposed views, with and without lse."""
    q, k, v = _qkv(gen, 2, hq, hkv, tq, tk, d)
    assert FK.plan_call(q, k, v) == "wgmma"
    FK.reset_flash_counts()
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  return_residuals=True)
    ro, rl = mha_ref(q, k, v, causal=causal, window=window, return_lse=True)
    torch.testing.assert_close(o, ro, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    o2 = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(o2, o, atol=0, rtol=0)
    assert flash_attention_cuda.mainloops == {"wgmma": 2, "wmma": 0,
                                              "simt": 0}


def test_flash_forward_tma_illegal_runs_wmma(gen):
    """Rows 8 elements apart overlap: bf16 on the wmma kernel, still
    against mha_ref."""
    def overlapping(h):
        buf = torch.randn(2 * h * (8 * 96 + 64), device="cuda",
                          generator=gen).to(torch.bfloat16)
        return buf.as_strided((2, h, 96, 64),
                              (h * (8 * 96 + 64), 8 * 96 + 64, 8, 1))
    q, k, v = overlapping(4), overlapping(2), overlapping(2)
    FK.reset_flash_counts()
    o, lse = flash_attention_cuda(q, k, v, return_residuals=True)
    ro, rl = mha_ref(q, k, v, return_lse=True)
    torch.testing.assert_close(o, ro, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    assert flash_attention_cuda.mainloops["wmma"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["none", "gelu", "sigmoid"])
def test_brgemm_gradients_match_plain_autograd(gen, dtype, activation):
    nb, m, k, n = 6, 90, 72, 110
    a = torch.randn(nb, m, k, device="cuda", generator=gen).to(dtype)
    b = (torch.randn(nb, k, n, device="cuda", generator=gen)
         * (nb * k) ** -0.5).to(dtype)
    bias = torch.randn(n, device="cuda", generator=gen).to(dtype)
    c0 = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    grads = {}
    for backend in ("cuda", "torch"):
        leaves = [t.detach().clone().requires_grad_() for t in (a, b, bias,
                                                                 c0)]
        before = brgemm_stacked_cuda.launches, batched_matmul_cuda.launches
        y = brgemm(*leaves, activation=activation, alpha=0.5, beta=0.25,
                   backend=backend)
        grads[backend] = torch.autograd.grad(y, leaves, dy)
        # forward (+ the gelu recompute); dA and dB on the batched kernel
        expect = ((1 + (activation == "gelu"), 2) if backend == "cuda"
                  else (0, 0))
        assert (brgemm_stacked_cuda.launches - before[0],
                batched_matmul_cuda.launches - before[1]) == expect
    for name, got, want in zip(("da", "db", "dbias", "dc0"), grads["cuda"],
                               grads["torch"]):
        assert got.dtype == want.dtype == dtype
        _rel_close(got, want, GRAD_BAND[dtype], name)


# Every distinct convolution of ResNet-50's forward, (name, c, k, h, r,
# stride, padding), at N = 32.
RESNET50_CONVS = list({cv.key: (cv.name, cv.c, cv.k, cv.h, cv.r, cv.stride,
                                 cv.padding)
                        for cv in chip_smoke.resnet_convs(
                            resnet.ResNetCfg(), 224)}.values())


@pytest.mark.parametrize("name,c,k,h,r,stride,padding", RESNET50_CONVS,
                         ids=[c[0] for c in RESNET50_CONVS])
def test_conv2d_resnet50_shapes_and_duals(gen, name, c, k, h, r, stride,
                                          padding):
    """Each ResNet-50 convolution at N = 32 in bf16 and its dual (the
    backward by data, fp32 out) against conv2d_ref; every one on the wgmma
    + TMA im2col mainloop but the stem's (3 channels: the wmma tiles)."""
    x = torch.randn(32, h, h, c, device="cuda", generator=gen).to(
        torch.bfloat16)
    w = (torch.randn(r, r, c, k, device="cuda", generator=gen)
         * (c * r * r) ** -0.5).to(torch.bfloat16)
    kw = dict(stride=stride, padding=padding)
    mainloop = "wmma" if name == "stem" else "wgmma"
    reset_conv_counts()
    assert plan_conv_call(x, w, **kw).mainloop == mainloop
    _band_close(conv2d_cuda(x, w, **kw), conv2d_ref(x, w, **kw),
                torch.bfloat16, f"{name} forward")
    calls = 1
    if name != "stem":                        # the image takes no gradient
        p = (h + 2 * padding - r) // stride + 1
        g = torch.randn(32, p, p, k, device="cuda", generator=gen).to(
            torch.bfloat16)
        gd, wd, pd = dual_operands(g, w, (h, h), stride, padding)
        assert plan_conv_call(gd, wd, padding=pd).mainloop == "wgmma"
        _band_close(conv2d_cuda(gd, wd, padding=pd, out_dtype=torch.float32),
                    conv2d_ref(gd, wd, padding=pd, out_dtype=torch.float32),
                    torch.float32, f"{name} dual")
        calls = 2
    assert conv2d_cuda.mainloops == {"wgmma": 0, "wmma": 0, "simt": 0,
                                     mainloop: calls}


# (N, H, C, K, R, stride, padding, activation): the im2col walk's edges, a
# channel block partly past C (40, 96), a 5x5 window at stride 2, an output
# of fewer pixels than a tile, and a window the plan splits (C = 256 over
# few tiles).
IM2COL_EDGES = [
    (2, 9, 40, 24, 3, 1, 1, "none"),
    (3, 11, 96, 136, 5, 2, 2, "silu"),
    (1, 5, 64, 64, 3, 1, 1, "relu"),
    (2, 10, 256, 72, 3, 1, 1, "none"),
]


@pytest.mark.parametrize("n,h,c,k,r,stride,padding,activation",
                         IM2COL_EDGES)
def test_conv2d_im2col_edges(gen, n, h, c, k, r, stride, padding,
                             activation):
    """The wgmma + TMA im2col convolution at its edges, bf16 and fp32 out,
    with a bias, against conv2d_ref; split windows where planned."""
    x = torch.randn(n, h, h, c, device="cuda", generator=gen).to(
        torch.bfloat16)
    w = (torch.randn(r, r, c, k, device="cuda", generator=gen)
         * (c * r * r) ** -0.5).to(torch.bfloat16)
    bias = torch.randn(k, device="cuda", generator=gen).to(torch.bfloat16)
    kw = dict(stride=stride, padding=padding, activation=activation)
    p = plan_conv_call(x, w, stride, padding)
    assert p.mainloop == "wgmma"
    reset_conv_counts()
    for out_dtype in (None, torch.float32):
        _band_close(conv2d_cuda(x, w, bias, out_dtype=out_dtype, **kw),
                    conv2d_ref(x, w, bias, out_dtype=out_dtype, **kw),
                    torch.float32 if out_dtype else torch.bfloat16,
                    f"im2col {out_dtype}")
    assert conv2d_cuda.mainloops["wgmma"] == 2
    assert conv2d_cuda.split_launches == (2 if p.splits > 1 else 0)
    if c == 256:
        assert p.splits > 1


def test_resnet_launch_counts_and_plain_parity(gen):
    """A reduced ResNet on the kernels: one conv launch per convolution
    and one head GEMM per forward; a gradient step adds a dual conv for
    each but the stem and a wgrad GEMM for each, plus the head's two."""
    cfg = resnet.ResNetCfg(n_classes=10, width=8, stage_blocks=(1, 2, 1, 1))
    params = resnet.init_params(cfg, gen)
    x = torch.randn(2, 64, 64, 3, device="cuda", generator=gen)
    labels = torch.tensor([3, 7], device="cuda")
    convs = 1 + 3 * sum(cfg.stage_blocks) + len(cfg.stage_blocks)
    conv2d_cuda.launches = matmul_cuda.launches = 0
    with torch.no_grad():
        logits = resnet.forward(params, x, cfg)
    assert (conv2d_cuda.launches, matmul_cuda.launches) == (convs, 1)
    with torch.no_grad():
        want = resnet.forward(params, x, cfg, backend="torch")
    _rel_close(logits, want, 1e-3, "logits")
    conv2d_cuda.launches = matmul_cuda.launches = 0
    loss, grads = resnet.loss_and_grads(params, x, labels, cfg)
    assert (conv2d_cuda.launches, matmul_cuda.launches) == (
        2 * convs - 1, 1 + 2 + convs)
    want_loss, want_grads = resnet.loss_and_grads(params, x, labels, cfg,
                                                  backend="torch")
    assert abs(loss.item() - want_loss.item()) <= 1e-4
    for (name, g), (_, w_) in zip(resnet.named_leaves(grads),
                                  resnet.named_leaves(want_grads)):
        err = ((g - w_).norm() / w_.norm().clamp_min(1e-30)).item()
        assert err <= 1e-3, (name, err)


# --------------------------------------------------------------------------
# the quantized GEMMs and serving tiers
# --------------------------------------------------------------------------

FORMATS = ("int8", "float8_e4m3fn", "float8_e5m2")


def _qtol(fmt, out_dtype, activation="none"):
    if out_dtype == torch.bfloat16:
        return dict(atol=1e-2, rtol=1e-2)
    if fmt == "int8":
        return dict(atol=0, rtol=0) if activation == "none" else dict(
            atol=1e-5, rtol=1e-5)
    return dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,trans", [
    (64, 64, 64, False), (8, 576, 192, False), (77, 100, 133, False),
    (9, 96, 1000, True), (300, 1536, 576, False)])
def test_matmul_q_kernel(gen, fmt, out_dtype, m, k, n, trans):
    x = torch.randn(m, k, device="cuda", generator=gen)
    w = torch.randn(n, k, device="cuda", generator=gen).T if trans else \
        torch.randn(k, n, device="cuda", generator=gen)
    xq, sx = quant.quantize(x, fmt, axis=(-1,))
    wq, sw = quant.quantize(w, fmt, axis=(-2,))
    assert (wq.stride(0) == 1) == trans          # table.T stays col-major
    launches = matmul_q_cuda.launches
    got = matmul_q_cuda(xq, wq, sx, sw, out_dtype=out_dtype)
    assert matmul_q_cuda.launches == launches + 1
    torch.testing.assert_close(got, matmul_q_ref(xq, wq, sx, sw,
                                                 out_dtype=out_dtype),
                               **_qtol(fmt, out_dtype))


_CFG = configs.get("smollm-135m")
# (name, m, k, n) of matmul_q on the quantized serving path (8 prompts of
# 512 tokens, 8 decode rows; the head is decode_int8's)
QUANT_SHAPES = [(f"{phase}.{name}", m, k, n)
                for phase, m in (("prefill", 8 * 512), ("decode", 8))
                for name, k, n in (
                    ("q", _CFG.d_model, _CFG.n_heads * _CFG.dh),
                    ("kv", _CFG.d_model, _CFG.n_kv_heads * _CFG.dh),
                    ("o", _CFG.n_heads * _CFG.dh, _CFG.d_model),
                    ("gate_up", _CFG.d_model, _CFG.d_ff),
                    ("down", _CFG.d_ff, _CFG.d_model))]
QUANT_SHAPES.append(("decode.lm_head", 8, _CFG.d_model, _CFG.vocab))
QUANT_PAIRS = [("int8", "int8"), ("float8_e4m3fn", "float8_e4m3fn"),
               ("float8_e4m3fn", "float8_e5m2")]


@pytest.mark.parametrize("x_fmt,w_fmt", QUANT_PAIRS,
                         ids=["int8", "e4m3", "e4m3 x e5m2"])
@pytest.mark.parametrize("name,m,k,n", QUANT_SHAPES,
                         ids=[s[0] for s in QUANT_SHAPES])
def test_matmul_q_main_path_shapes(gen, name, m, k, n, x_fmt, w_fmt):
    """matmul_q at every main-path shape with the weight K-major as the
    path stores it, bf16 and fp32 out, against matmul_q_ref: on 8-bit
    wgmma (fp8's slice sums added in fp32); int8 exact."""
    x = torch.randn(m, k, device="cuda", generator=gen)
    w = (torch.randn(n, k, device="cuda", generator=gen).T
         if name.endswith("lm_head") else
         torch.randn(k, n, device="cuda", generator=gen)) * k ** -0.5
    xq, sx = quant.quantize(x, x_fmt, axis=(-1,))
    wq, sw = quant.quantize(w, w_fmt, axis=(-2,), k_major=True)
    assert wq.stride() == (1, k)
    assert plan_q_call(xq, wq).mainloop == "wgmma"
    for out_dtype in (torch.bfloat16, torch.float32):
        reset_quant_counts()
        got = matmul_q_cuda(xq, wq, sx, sw, out_dtype=out_dtype)
        assert matmul_q_cuda.mainloops == {"wgmma": 1, "wmma": 0}
        torch.testing.assert_close(got, matmul_q_ref(
            xq, wq, sx, sw, out_dtype=out_dtype), **_qtol(x_fmt, out_dtype))


@pytest.mark.parametrize("fmt", ["int8", "float8_e4m3fn"])
def test_matmul_q_wgmma_split_k(gen, fmt):
    """One output tile over k = 4096: the plan splits k; the partials
    (int32, or fp32 for fp8) added in split order, then the dequant."""
    x = torch.randn(8, 4096, device="cuda", generator=gen)
    w = torch.randn(4096, 128, device="cuda", generator=gen) / 64
    bias = torch.randn(128, device="cuda", generator=gen)
    xq, sx = quant.quantize(x, fmt, axis=(-1,))
    wq, sw = quant.quantize(w, fmt, axis=(-2,), k_major=True)
    assert plan_q_call(xq, wq).splits > 1
    reset_quant_counts()
    for out_dtype in (torch.float32, torch.bfloat16):
        for kw in (dict(), dict(bias=bias, activation="gelu", alpha=0.5)):
            torch.testing.assert_close(
                matmul_q_cuda(xq, wq, sx, sw, out_dtype=out_dtype, **kw),
                matmul_q_ref(xq, wq, sx, sw, out_dtype=out_dtype, **kw),
                **_qtol(fmt, out_dtype, kw.get("activation", "none")))
    assert matmul_q_cuda.split_launches == 4
    assert matmul_q_cuda.mainloops["wgmma"] == 4


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("activation", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_matmul_q_kernel_epilogue(gen, fmt, activation, bias_dtype):
    x = torch.randn(33, 64, device="cuda", generator=gen)
    w = torch.randn(64, 40, device="cuda", generator=gen)
    bias = torch.randn(40, device="cuda", generator=gen).to(bias_dtype)
    xq, sx = quant.quantize(x, fmt, axis=None)    # per-tensor, expanded
    wq, sw = quant.quantize(w, fmt, axis=(-2,))
    sx = sx.expand(33)
    kw = dict(activation=activation, alpha=0.5)
    torch.testing.assert_close(matmul_q_cuda(xq, wq, sx, sw, bias, **kw),
                               matmul_q_ref(xq, wq, sx, sw, bias, **kw),
                               **_qtol(fmt, torch.float32, activation))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("nb,m,k,n,trans", [
    (3, 40, 72, 24, False), (16, 64, 64, 64, False), (4, 96, 128, 80, True)])
def test_brgemm_q_kernel(gen, fmt, nb, m, k, n, trans):
    a = torch.randn(nb, m, k, device="cuda", generator=gen)
    b = torch.randn(nb, n, k, device="cuda", generator=gen).transpose(1, 2) \
        if trans else torch.randn(nb, k, n, device="cuda", generator=gen)
    aq, sa = quant.quantize(a, fmt, axis=(0, 2))
    bq, sb = quant.quantize(b, fmt, axis=(0, 1))
    bias = torch.randn(n, device="cuda", generator=gen)
    for kw in (dict(), dict(bias=bias, activation="gelu", alpha=2.0)):
        act = kw.get("activation", "none")
        torch.testing.assert_close(brgemm_q_cuda(aq, bq, sa, sb, **kw),
                                   brgemm_q_ref(aq, bq, sa, sb, **kw),
                                   **_qtol(fmt, torch.float32, act))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("bcast", ["none", "a", "b"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_batched_matmul_q_kernel(gen, fmt, bcast, out_dtype):
    nb, m, k, n = 5, 70, 96, 48
    a = torch.randn(m, k, device="cuda", generator=gen) if bcast == "a" \
        else torch.randn(nb, m, k, device="cuda", generator=gen)
    b = torch.randn(k, n, device="cuda", generator=gen) if bcast == "b" \
        else torch.randn(nb, k, n, device="cuda", generator=gen)
    aq, sa = quant.quantize(a, fmt, axis=(-1,))
    bq, sb = quant.quantize(b, fmt, axis=(-2,))
    got = batched_matmul_q_cuda(aq, bq, sa, sb, out_dtype=out_dtype)
    assert got.shape == (nb, m, n)
    torch.testing.assert_close(got, batched_matmul_q_ref(
        aq, bq, sa, sb, out_dtype=out_dtype), **_qtol(fmt, out_dtype))


# chip_smoke.py's quant cases for brgemm_q / batched_matmul_q: the paper's
# BRGEMM_CASES on the wgmma mainloop, rows of 100 bytes on the wmma tiles
Q_BATCHED_CASES = [(*c, "wgmma") for c in chip_smoke.BRGEMM_CASES] + [
    (5, 70, 100, 130, "wmma")]


def _f64_err(got, exact, sr, sc):
    """max |got - exact * (sr x sc)| over the largest |output|, float64."""
    truth = exact * (sr.double()[..., :, None] * sc.double()[..., None, :])
    return ((got.double() - truth).abs().max() / truth.abs().max()).item()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("nb,m,k,n,loop", Q_BATCHED_CASES,
                         ids=[f"B{c[0]} m{c[1]} k{c[2]} n{c[3]}"
                              for c in Q_BATCHED_CASES])
def test_brgemm_q_wgmma_cases(gen, fmt, nb, m, k, n, loop):
    """brgemm_q at the smoke's cases, B K-major as the routing quantizes
    it: on the mainloop its plan states (split or not, counted), against
    the plain version with and without bias, activation and alpha; fp8
    with fp32 out within 2e-6 of the largest output of float64 (fp32 sums
    of up to 16,384 exact products)."""
    a = torch.randn(nb, m, k, device="cuda", generator=gen)
    b = torch.randn(nb, k, n, device="cuda", generator=gen) * (nb * k) ** -.5
    bias = torch.randn(n, device="cuda", generator=gen)
    aq, sa = quant.quantize(a, fmt, axis=(0, 2))
    bq, sb = quant.quantize(b, fmt, axis=(0, 1), k_major=True)
    p = plan_q_stacked_call(aq, bq)
    assert p.mainloop == loop
    reset_quant_counts()
    for out_dtype in (torch.float32, torch.bfloat16):
        for kw in (dict(), dict(bias=bias, activation="gelu", alpha=0.5)):
            got = brgemm_q_cuda(aq, bq, sa, sb, out_dtype=out_dtype, **kw)
            torch.testing.assert_close(
                got, brgemm_q_ref(aq, bq, sa, sb, out_dtype=out_dtype, **kw),
                **_qtol(fmt, out_dtype, kw.get("activation", "none")))
            if fmt != "int8" and out_dtype == torch.float32 and not kw:
                exact = torch.einsum("imk,ikn->mn", aq.double(), bq.double())
                assert _f64_err(got, exact, sa, sb) <= 2e-6
    assert brgemm_q_cuda.mainloops == {"wgmma": 4 * (loop == "wgmma"),
                                       "wmma": 4 * (loop == "wmma")}
    assert brgemm_q_cuda.split_launches == 4 * (p.splits > 1)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("nb,m,k,n,loop", Q_BATCHED_CASES,
                         ids=[f"B{c[0]} m{c[1]} k{c[2]} n{c[3]}"
                              for c in Q_BATCHED_CASES])
def test_batched_matmul_q_wgmma_cases(gen, fmt, nb, m, k, n, loop):
    """batched_matmul_q at the smoke's cases with per-entry scales, A or B
    a 2-D broadcast operand (its scale row shared), and with bias,
    activation and alpha: on the mainloop its plan states, against the
    plain version; fp8 with fp32 out within 2e-6 of float64."""
    a = torch.randn(nb, m, k, device="cuda", generator=gen)
    b = torch.randn(nb, k, n, device="cuda", generator=gen) * k ** -.5
    bias = torch.randn(n, device="cuda", generator=gen)
    aq, sa = quant.quantize(a, fmt, axis=(-1,))
    bq, sb = quant.quantize(b, fmt, axis=(-2,), k_major=True)
    cases = [((aq, bq, sa, sb), {}), ((aq[0], bq, sa[0], sb), {}),
             ((aq, bq[0], sa, sb[0]), {}),
             ((aq, bq, sa, sb), dict(bias=bias, activation="silu",
                                     alpha=2.0))]
    reset_quant_counts()
    for args, kw in cases:
        assert plan_q_batched_call(*args[:2]).mainloop == loop
        for out_dtype in (torch.float32, torch.bfloat16):
            got = batched_matmul_q_cuda(*args, out_dtype=out_dtype, **kw)
            assert got.shape == (nb, m, n)
            torch.testing.assert_close(got, batched_matmul_q_ref(
                *args, out_dtype=out_dtype, **kw),
                **_qtol(fmt, out_dtype, kw.get("activation", "none")))
            if fmt != "int8" and out_dtype == torch.float32 and not kw:
                exact = args[0].double() @ args[1].double()
                assert _f64_err(got, exact, args[2], args[3]) <= 2e-6
    assert batched_matmul_q_cuda.mainloops == {
        "wgmma": 8 * (loop == "wgmma"), "wmma": 8 * (loop == "wmma")}
    assert batched_matmul_q_cuda.split_launches == 0


def test_quant_batched_n_major_b_runs_wmma(gen):
    """An N-major 8-bit B handed straight to the wrappers: 8-bit wgmma has
    no transpose, so the plan takes the wmma tiles, and the result holds."""
    a = torch.randn(4, 96, 128, device="cuda", generator=gen)
    b = torch.randn(4, 128, 80, device="cuda", generator=gen) / 16
    aq, sa = quant.quantize(a, "int8", axis=(0, 2))
    bq, sb = quant.quantize(b, "int8", axis=(0, 1))
    assert bq.stride(-1) == 1
    reset_quant_counts()
    torch.testing.assert_close(brgemm_q_cuda(aq, bq, sa, sb),
                               brgemm_q_ref(aq, bq, sa, sb), atol=0, rtol=0)
    aq, sa = quant.quantize(a, "int8", axis=(-1,))
    bq, sb = quant.quantize(b, "int8", axis=(-2,))
    torch.testing.assert_close(batched_matmul_q_cuda(aq, bq, sa, sb),
                               batched_matmul_q_ref(aq, bq, sa, sb),
                               atol=0, rtol=0)
    assert brgemm_q_cuda.mainloops["wmma"] == 1
    assert batched_matmul_q_cuda.mainloops["wmma"] == 1


@pytest.mark.parametrize("spec", ["int8", "fp8"])
def test_quantized_entry_points_launch_once(gen, spec):
    x = torch.randn(3, 5, 64, device="cuda", generator=gen)
    w = torch.randn(64, 32, device="cuda", generator=gen)
    a = torch.randn(4, 16, 64, device="cuda", generator=gen)
    b = torch.randn(4, 64, 32, device="cuda", generator=gen)
    counters = (matmul_q_cuda, brgemm_q_cuda, batched_matmul_q_cuda)
    reset_quant_counts()
    with torch.no_grad():
        got = [matmul(x, w, quant=spec), brgemm(a, b, quant=spec),
               batched_matmul(a, b, quant=spec)]
        assert [c.launches for c in counters] == [1] * 3
        with dispatch.use(backend="torch"):
            want = [matmul(x, w, quant=spec), brgemm(a, b, quant=spec),
                    batched_matmul(a, b, quant=spec)]
    assert [c.launches for c in counters] == [1] * 3
    # every B quantized K-major by the routing: all three on wgmma
    assert [c.mainloops for c in counters] == [{"wgmma": 1, "wmma": 0}] * 3
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **_qtol(spec, torch.float32))


@pytest.mark.parametrize("tier", ["decode_int8", "calibrated_int8",
                                  "calibrated_fp8"])
def test_engine_quant_tiers_match_plain_greedy(gen, tier):
    cfg = configs.get("smollm-135m").reduced()
    params = api.init_params(cfg, gen)
    kw = {}
    if tier == "decode_int8":
        kw["decode_quant"] = "int8"
    else:
        params = quant.calibrate_params(params, tier.split("_")[1])
    engine = Engine(cfg, params, ServeConfig(max_len=32), **kw)
    tokens = torch.randint(0, cfg.vocab, (2, 9), device="cuda",
                           generator=gen)
    matmul_cuda.launches = matmul_q_cuda.launches = 0
    got = engine.generate({"tokens": tokens}, n_tokens=6, stop_tokens=())
    per_forward = cfg.n_layers * 7 + 1
    if tier == "decode_int8":    # prefill full precision, decode quantized
        expect = (per_forward, per_forward * 5)
    else:                        # the head's table is not calibrated
        expect = (6, (per_forward - 1) * 6)
    assert (matmul_cuda.launches, matmul_q_cuda.launches) == expect
    with dispatch.use(backend="torch"):
        want = engine.generate({"tokens": tokens}, n_tokens=6,
                               stop_tokens=())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_row_with_no_valid_key(gen, dtype):
    """Non-causal, windowed, Tq > Tk: rows past Tk + window - 1 see no key
    and give the mean of V, as mha_ref does, with lse NEG_INF; the
    backward gives what autograd of mha_ref gives there."""
    q = torch.randn(2, 4, 150, 64, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(2, 2, 70, 64, device="cuda", generator=gen
                        ).to(dtype) for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, causal=False, window=20,
                                  return_residuals=True)
    ro, rl = mha_ref(q, k, v, causal=False, window=20, return_lse=True)
    assert (rl[..., 89:] == -1e30).all() and (rl[..., :89] > -1e29).all()
    tol = TOL[dtype] if dtype == torch.float32 else dict(atol=2e-2,
                                                         rtol=2e-2)
    torch.testing.assert_close(o, ro, **tol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    # The backward: every key's dV takes those rows' dO / Tk, dQ and dK
    # nothing from them, as autograd of mha_ref gives.
    dy = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, dy, causal=False,
                                   window=20)
    want = flash_attention_bwd_ref(q, k, v, o, lse, dy, causal=False,
                                   window=20)
    for name, g, gw in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - gw.float()).abs().max().item()
        assert err <= GRAD_BAND[dtype] * gw.float().abs().max().item(), name


@pytest.mark.parametrize("tq,tk,hq,hkv,d,causal,window", [
    (512, 512, 9, 3, 64, True, None),      # the training shape, B = 8
    (500, 500, 9, 3, 64, True, None),      # ragged T
    (130, 130, 6, 2, 32, True, 50),        # d = 32, windowed, group 3
    (300, 300, 4, 1, 128, True, 100),      # d = 128, windowed, group 4
    (256, 256, 8, 2, 128, False, None),    # non-causal
    (150, 70, 4, 2, 64, False, 20),        # Tq > Tk: rows with no key
    (70, 150, 3, 1, 128, False, None),     # Tq < Tk
    (100, 230, 4, 2, 32, True, None),      # causal, Tq < Tk
])
def test_flash_backward_wgmma(gen, tq, tk, hq, hkv, d, causal, window):
    """The wgmma + TMA flash backward against flash_attention_bwd_ref, on
    the attention layer's views (dY the merged heads' gradient, viewed),
    from the forward kernel's residuals; its fused delta against the
    standalone pass bit for bit, and two calls bit for bit alike."""
    b = 8 if tq == 512 else 2
    q, k, v = _qkv(gen, b, hq, hkv, tq, tk, d)
    dy = torch.randn(b, tq, hq, d, device="cuda", generator=gen).to(
        torch.bfloat16).transpose(1, 2)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  return_residuals=True)
    assert FB.plan_call(q, k, v, o, dy) == "wgmma"
    reset_flash_bwd_counts()
    *got, delta = flash_attention_bwd_cuda(q, k, v, o, lse, dy,
                                           causal=causal, window=window,
                                           return_delta=True)
    want = flash_attention_bwd_ref(q, k, v, o, lse, dy, causal=causal,
                                   window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _rel_close(g, w, GRAD_BAND[torch.bfloat16], name)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, dy, causal=causal,
                                     window=window)
    for g, g2 in zip(got, again):
        torch.testing.assert_close(g2, g, atol=0, rtol=0)
    torch.testing.assert_close(delta, delta_rowsum_cuda(o, dy), atol=0,
                               rtol=0)
    assert flash_attention_bwd_cuda.mainloops == {"wgmma": 2, "wmma": 0,
                                                  "simt": 0}
    assert flash_attention_bwd_cuda.launches == 2


def test_flash_backward_tma_illegal_and_fp32_mainloops(gen):
    """Rows 8 elements apart (bf16): the wmma kernels; fp32: simt; both
    against flash_attention_bwd_ref."""
    def overlapping(h, dtype):
        buf = torch.randn(2 * h * (8 * 96 + 64), device="cuda",
                          generator=gen).to(dtype)
        return buf.as_strided((2, h, 96, 64),
                              (h * (8 * 96 + 64), 8 * 96 + 64, 8, 1))
    for dtype, mainloop in ((torch.bfloat16, "wmma"),
                            (torch.float32, "simt")):
        q, k, v = overlapping(4, dtype), overlapping(2, dtype), \
            overlapping(2, dtype)
        dy = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        o, lse = flash_attention_cuda(q, k, v, return_residuals=True)
        assert FB.plan_call(q, k, v, o, dy) == mainloop
        reset_flash_bwd_counts()
        got = flash_attention_bwd_cuda(q, k, v, o, lse, dy)
        want = flash_attention_bwd_ref(q, k, v, o, lse, dy)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _rel_close(g, w, GRAD_BAND[dtype], f"{mainloop} {name}")
        assert flash_attention_bwd_cuda.mainloops[mainloop] == 1


# --------------------------------------------------------------------------
# the LSTM's chained gate GEMM, the LSTM and its LM; the windowed paths
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["sigmoid", "tanh"])
def test_lstm_gate_gemm_chain(gen, dtype, activation):
    """pre = x @ W (fp32 out), then act(h @ R + pre + b) with pre as an
    fp32 c0 beside operands of ``dtype``: the forward against the plain
    chain, and every gradient (dc0 flowing back into the first GEMM)
    against plain autograd, with 2 launches forward and 4 backward."""
    n, c, k = 40, 72, 96
    x = torch.randn(n, c, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(c, k, device="cuda", generator=gen) * c ** -0.5
         ).to(dtype)
    h = torch.randn(n, k, device="cuda", generator=gen).to(dtype)
    r = (torch.randn(k, k, device="cuda", generator=gen) * k ** -0.5
         ).to(dtype)
    b = torch.randn(k, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(n, k, device="cuda", generator=gen).to(dtype)
    pre = matmul_cuda(x, w, out_dtype=torch.float32)
    assert pre.dtype == torch.float32
    torch.testing.assert_close(pre, matmul_ref(x, w, out_dtype=torch.float32),
                               **TOL[torch.float32])
    got = matmul_cuda(h, r, b, pre, beta=1.0, activation=activation)
    want = matmul_ref(h, r, b, c0=pre, beta=1.0, activation=activation)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, **TOL[dtype])
    grads = {}
    for backend in ("cuda", "torch"):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, h, r,
                                                                 b)]
        before = matmul_cuda.launches
        p = matmul(leaves[0], leaves[1], out_dtype=torch.float32,
                   backend=backend)
        y = matmul(leaves[2], leaves[3], leaves[4], p, beta=1.0,
                   activation=activation, backend=backend)
        grads[backend] = torch.autograd.grad(y, leaves, dy)
        assert matmul_cuda.launches - before == (6 if backend == "cuda"
                                                 else 0)
    for name, g, want in zip(("dx", "dw", "dh", "dr", "db"), grads["cuda"],
                             grads["torch"]):
        assert g.dtype == dtype
        _rel_close(g, want, GRAD_BAND[dtype], name)


def test_lstm_and_lstm_lm_kernels_match_plain(gen):
    """fp32: the LSTM forward (8 matmul launches a step) and the LSTM-LM's
    loss and gradients, on the kernels against the plain path."""
    from repro_torch.layers import lstm
    from repro_torch.models import lstm_lm
    p = lstm.init(24, 32, generator=gen)
    x = torch.randn(5, 6, 24, device="cuda", generator=gen)
    before = matmul_cuda.launches
    h, s = lstm.forward(p, x)
    assert matmul_cuda.launches - before == 8 * 5
    with dispatch.use(backend="torch"):
        hr, sr = lstm.forward(p, x)
    torch.testing.assert_close(h, hr, **TOL[torch.float32])
    torch.testing.assert_close(s, sr, **TOL[torch.float32])
    cfg = lstm_lm.LSTMLMCfg(vocab=96, d_model=32, n_layers=2)
    params = lstm_lm.init_params(cfg, gen)
    tokens = torch.randint(0, 96, (3, 7), device="cuda", generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    (loss, _), grads = lstm_lm.loss_and_grads(params, batch, cfg)
    with dispatch.use(backend="torch"):
        (want, _), wgrads = lstm_lm.loss_and_grads(params, batch, cfg)
    torch.testing.assert_close(loss, want, atol=1e-5, rtol=1e-5)
    for (name, g), (_, w) in zip(lstm_lm.named_leaves(grads),
                                 lstm_lm.named_leaves(wgrads)):
        _rel_close(g, w, GRAD_BAND[torch.float32], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_windowed_head_dim_128(gen, dtype):
    """starcoder2's attention shape, reduced: head_dim 128, 12 / 1 heads,
    T = 300 past a window of 128."""
    q, k, v = _qkv(gen, 2, 12, 1, 300, 300, 128, dtype)
    o, lse = flash_attention_cuda(q, k, v, window=128,
                                  return_residuals=True)
    ro, rl = mha_ref(q, k, v, window=128, return_lse=True)
    tol = TOL[dtype] if dtype == torch.float32 else dict(atol=2e-2,
                                                         rtol=2e-2)
    torch.testing.assert_close(o, ro, **tol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)


def test_windowed_engines_kernels_match_plain(gen):
    """Reduced starcoder2 (window 8, the plain GELU FFN) in fp32: the
    static engine with prompts past the window (6 GEMMs a layer and the
    head a forward, a windowed flash a layer a prefill) and the
    continuous one on the slotted pool, kernels against the plain path."""
    cfg = configs.get("starcoder2-15b").reduced()
    params = api.init_params(cfg, gen)
    engine = Engine(cfg, params, ServeConfig(max_len=40))
    tokens = torch.randint(0, cfg.vocab, (2, 13), device="cuda",
                           generator=gen)
    reset_matmul_counts()
    flash_attention_cuda.launches = 0
    got = engine.generate({"tokens": tokens}, n_tokens=12, stop_tokens=())
    assert matmul_cuda.launches == (cfg.n_layers * 6 + 1) * 12
    assert flash_attention_cuda.launches == cfg.n_layers
    with dispatch.use(backend="torch"):
        want = engine.generate({"tokens": tokens}, n_tokens=12,
                               stop_tokens=())
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                    max_tokens=m, stop_tokens=())
            for n, m in zip([3, 13, 6, 9, 2], [9, 5, 7, 4, 12])]

    def serve():
        ce = ContinuousEngine(cfg, params, PoolConfig(n_slots=3, max_len=40))
        assert not ce.paged
        return ce.serve(reqs)

    out = serve()
    with dispatch.use(backend="torch"):
        assert serve() == out


def test_engine_sampled_default_generator_on_card(gen):
    """Sampled static decoding with no generator draws from one on the
    card, seeded 0: deterministic under it."""
    from repro_torch.serve import engine as engine_mod
    cfg = configs.get("smollm-135m").reduced()
    engine = Engine(cfg, api.init_params(cfg, gen),
                    ServeConfig(max_len=32, temperature=1.0))
    tokens = torch.randint(0, cfg.vocab, (2, 7), device="cuda",
                           generator=gen)
    devices = []
    real = engine_mod._gumbel

    def spy(shape, generator, device):
        devices.append(generator.device.type)
        return real(shape, generator, device)

    engine_mod._gumbel = spy
    try:
        a = engine.generate({"tokens": tokens}, n_tokens=5, stop_tokens=())
        b = engine.generate({"tokens": tokens}, n_tokens=5, stop_tokens=())
    finally:
        engine_mod._gumbel = real
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert devices and set(devices) == {"cuda"}


# ---------------------------------------------------------------------------
# block policies and the measured autotuner on the card
# ---------------------------------------------------------------------------

GRID_CASES = [   # (op, triple, nb, dtype, quant)
    ("matmul", (8, 7168, 20480), 1, torch.bfloat16, None),
    ("matmul", (300, 576, 1536), 1, torch.bfloat16, None),
    ("matmul", (512, 512, 4096), 1, torch.float32, None),
    ("brgemm", (64, 64, 256), 16, torch.bfloat16, None),
    ("batched_matmul", (64, 128, 64), 32, torch.bfloat16, None),
    ("matmul", (8, 1536, 4096), 1, torch.int8, "int8"),
    ("matmul", (64, 576, 4096), 1, torch.float8_e4m3fn, "fp8"),
    ("brgemm", (64, 64, 256), 16, torch.int8, "int8"),
    ("batched_matmul", (128, 128, 128), 8, torch.int8, "int8"),
]


@pytest.fixture
def fresh_cache(monkeypatch, tmp_path):
    from repro_torch.core import autotune
    monkeypatch.setenv(dispatch.TUNING_CACHE_ENV, str(tmp_path / "c.json"))
    monkeypatch.setenv(autotune.ENV_MAX_CANDIDATES, "4")
    dispatch.clear_tuning_cache()
    yield tmp_path / "c.json"
    dispatch.clear_tuning_cache()


@pytest.mark.parametrize("op,triple,nb,dtype,quant", GRID_CASES)
def test_every_candidate_plan_launches_and_matches(gen, op, triple, nb,
                                                   dtype, quant):
    """Each plan of the grid the autotuner searches runs on the kernels
    and agrees with the plain version (the heuristic's bands)."""
    from repro_torch.core import autotune, blocking
    m, n, k = triple
    geometry = blocking.default_geometry(op, m, n, k, dtype, quant=quant)
    if op != "matmul":
        geometry = dataclasses.replace(geometry, nb=nb)
    grid = blocking.candidate_grid(op, m, n, k, dtype, geometry=geometry,
                                   quant=quant)
    assert len(grid) > 1
    outs = []
    for plan in grid:
        fn = autotune.proxy_runner(op, m, n, k, dtype, plan,
                                   geometry=geometry, quant=quant)
        outs.append(fn().float())
    want = outs[0]          # ones: every plan computes the same integers
    for plan, got in zip(grid, outs):
        torch.testing.assert_close(got, want, atol=0, rtol=0, msg=str(plan))
    assert want.flatten()[0].item() == k * (nb if op == "brgemm" else 1)


def test_autotune_measures_on_the_card_and_persists(gen, fresh_cache):
    from repro_torch.core import autotune
    x = torch.randn(8, 7168, device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn(7168, 4096, device="cuda", generator=gen)
         * 7168 ** -0.5).to(torch.bfloat16)
    before = autotune.STATS.snapshot()
    with dispatch.use(blocks_policy="autotune"):
        got = matmul_cuda(x, w)
        chosen = plan_call(x, w)
    after = autotune.STATS.snapshot()
    assert after["measured"] - before["measured"] == 4
    assert after["failed"] == before["failed"]
    torch.testing.assert_close(got.float(), matmul_ref(x, w).float(),
                               **TOL[torch.bfloat16])
    dispatch.clear_tuning_cache()        # a new process: the file answers
    with dispatch.use(blocks_policy="autotune"):
        assert plan_call(x, w) == chosen
    assert autotune.STATS.snapshot()["measured"] == after["measured"]


def test_resolve_blocks_raises_on_a_miss_while_capturing(gen, fresh_cache):
    x = torch.randn(64, 576, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(576, 576, device="cuda", generator=gen).to(torch.bfloat16)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match="captured"):
            with torch.cuda.graph(graph):
                with dispatch.use(blocks_policy="autotune"):
                    matmul_cuda(x, w)
    torch.cuda.synchronize()
    with dispatch.use(blocks_policy="autotune"):
        want = matmul_cuda(x, w)                # warms the cache
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = matmul_cuda(x, w)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_backward_resolves_under_the_forwards_policy(gen, fresh_cache):
    """Autograd runs a CUDA backward on a thread of its own: the GEMMs of
    matmul's and brgemm's backward, and the flash backward, still resolve
    under the forward's policy."""
    seen = []

    def policy(op, m, n, k, dtype, backend, geometry=None, quant=None):
        from repro_torch.core import blocking
        seen.append((op, m, n, k))
        return blocking.default_plan(op, m, n, k, dtype, geometry=geometry,
                                     quant=quant)

    x = torch.randn(64, 96, device="cuda", generator=gen,
                    requires_grad=True)
    w = torch.randn(96, 128, device="cuda", generator=gen,
                    requires_grad=True)
    a = torch.randn(4, 64, 32, device="cuda", generator=gen,
                    requires_grad=True)
    b = torch.randn(4, 32, 48, device="cuda", generator=gen,
                    requires_grad=True)
    q = torch.randn(1, 2, 64, 64, device="cuda", generator=gen,
                    requires_grad=True)
    with dispatch.use(blocks_policy=policy):
        loss = (matmul(x, w).sum() + brgemm(a, b).sum()
                + flash_attention(q, q, q).sum())
    assert ("matmul", 64, 96, 128) not in seen     # dx not resolved yet
    loss.backward()          # outside the context: the snapshot carries it
    assert ("matmul", 64, 96, 128) in seen        # dx = g @ W.T
    assert ("matmul", 96, 128, 64) in seen        # dw = X.T @ g
    assert ("batched_matmul", 64, 32, 48) in seen  # dA_i = g @ B_i.T
    assert ("flash_attention_bwd", 64, 64, 64) in seen


def test_remat_bit_equal_on_the_card(gen):
    """Reduced smollm in bf16 on the kernels: the loss and each gradient
    with ``cfg.remat`` equal those without (the embedding's, a scatter-add
    with atomics, within two plain runs' spread)."""
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(configs.get("smollm-135m").reduced(),
                              dtype="bfloat16")
    model = api.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (4, 64), device="cuda",
                           generator=gen)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    runs = []
    for remat in (False, False, True):
        metrics, grads = ts.loss_and_grads(
            model, batch, dataclasses.replace(cfg, remat=remat))
        runs.append((metrics["loss"].clone(),
                     {n: g.clone() for n, g in grads.items()}))
    (l0, g0), (_, g1), (lr, gr) = runs
    assert torch.equal(l0, lr)
    for n, g in g0.items():
        spread = (g - g1[n]).float().abs().max().item()
        assert (gr[n] - g).float().abs().max().item() <= spread, n
        if n != "embed.table":
            assert torch.equal(gr[n], g), n


# ==========================================================================
# Mixture-of-Experts and MLA (grok-1-314b, deepseek-v3-671b)
# ==========================================================================

def _mla_qkv(gen, b, h, t, dq, dv, dtype):
    """MLA's views: q and k (B, H, T, dq) built whole, v a (B, H, T, dv)
    slice of the per-head (nope + v) expansion, as ``layers/attention.py``
    hands them over."""
    q = torch.randn(b, h, t, dq, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, h, t, dq, device="cuda", generator=gen).to(dtype)
    kv = torch.randn(b, t, h, 2 * dv, device="cuda", generator=gen).to(dtype)
    return q, k, kv.transpose(1, 2)[..., dv:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dq,dv", [(192, 128), (24, 16)],
                         ids=["mla", "mla_reduced_padded"])
def test_flash_mla_head_dims(gen, dtype, dq, dv):
    """q / k of dq against v of dv at the explicit scale (nope + rope) ** -0.5,
    causal, T = 200: the (192, 128) instantiation on wgmma for bf16 (simt
    for fp32), and (24, 16) zero-padded to (32, 32), the output sliced
    back; lse too."""
    q, k, v = _mla_qkv(gen, 2, 6, 200, dq, dv, dtype)
    scale = dq ** -0.5
    flash_attention_cuda.mainloops = dict.fromkeys(FK.MAINLOOPS, 0)
    o, lse = flash_attention_cuda(q, k, v, scale=scale,
                                  return_residuals=True)
    want = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert flash_attention_cuda.mainloops[want] == 1
    ro, rl = mha_ref(q, k, v, scale=scale, return_lse=True)
    assert o.shape == (2, 6, 200, dv)
    tol = TOL[dtype] if dtype == torch.float32 else dict(atol=2e-2,
                                                         rtol=2e-2)
    torch.testing.assert_close(o, ro, **tol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    with pytest.raises(ValueError, match="fit no instantiation"):
        flash_attention_cuda(*_mla_qkv(gen, 1, 1, 8, 264, 128, dtype))


# (E, G * cap, k, n, activation) of the expert GEMMs: grok-1 at prefill (2
# rows of 512: cap 160) and at a slot decode (4 groups of 4), deepseek-v3
# at prefill (cap 20) and at the static decode (one group of 4).
EXPERT_SHAPES = [(8, 320, 6144, 32768, "silu"), (8, 16, 32768, 6144, "none"),
                 (256, 40, 7168, 2048, "silu"), (256, 4, 2048, 7168, "none")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,m,k,n,act", EXPERT_SHAPES,
                         ids=["grok_gate_prefill", "grok_down_slots",
                              "deepseek_gate_prefill",
                              "deepseek_down_decode"])
def test_batched_matmul_expert_shapes(gen, dtype, e, m, k, n, act):
    """The expert GEMMs at the two models' shapes, the gate's silu fused:
    bf16 on the wgmma mainloop, fp32 on simt, against the plain version
    (one bf16 ulp; fp32 sums in other orders)."""
    a = torch.randn(e, m, k, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(e, k, n, device="cuda", generator=gen)
         * k ** -0.5).to(dtype)
    assert plan_batched_call(a, w).mainloop == (
        "wgmma" if dtype == torch.bfloat16 else "simt")
    got = batched_matmul_cuda(a, w, activation=act)
    torch.testing.assert_close(got, batched_matmul_ref(a, w, activation=act),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_kernels_match_plain(gen, dtype):
    """A reduced MoE layer with a shared expert, at prefill (a group a
    row, capacity binding) and at a slot decode: 3 batched_matmul and 4
    matmul launches a forward, the output against the plain path's."""
    from repro_torch.layers import moe
    cfg = moe.MoECfg(d_model=64, d_ff=128, n_experts=8, top_k=2, n_shared=1,
                     capacity_factor=0.5)
    layer = moe.MoE(cfg, dtype=dtype, device="cuda")
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, device="cuda", generator=gen)
                    * p.shape[-2] ** -0.5)
    for x, rows in ((torch.randn(3, 40, 64, device="cuda", generator=gen),
                     False),
                    (torch.randn(4, 1, 64, device="cuda", generator=gen),
                     True)):
        x = x.to(dtype)
        reset_matmul_counts()
        with torch.no_grad():
            got, aux = layer(x, row_groups=rows)
            assert batched_matmul_cuda.launches == 3
            assert matmul_cuda.launches == 4
            with dispatch.use(backend="torch"):
                want, waux = layer(x, row_groups=rows)
        torch.testing.assert_close(got, want, **(
            TOL[dtype] if dtype == torch.float32 else dict(atol=5e-2,
                                                           rtol=5e-2)))
        torch.testing.assert_close(aux["dropped_fraction"],
                                   waux["dropped_fraction"])


@pytest.mark.parametrize("name", ["grok-1-314b", "deepseek-v3-671b"])
def test_moe_engines_kernels_match_plain(gen, name):
    """Reduced grok-1 / deepseek-v3 in fp32, 2 layers: both engines'
    greedy tokens on the kernels equal the plain path's (the slotted and
    paged pools)."""
    cfg = dataclasses.replace(configs.get(name).reduced(), n_layers=2)
    params = api.init_params(cfg, gen)
    engine = Engine(cfg, params, ServeConfig(max_len=40))
    tokens = torch.randint(0, cfg.vocab, (2, 17), device="cuda",
                           generator=gen)
    got = engine.generate({"tokens": tokens}, n_tokens=12, stop_tokens=())
    with dispatch.use(backend="torch"):
        want = engine.generate({"tokens": tokens}, n_tokens=12,
                               stop_tokens=())
    assert torch.equal(got, want)
    reqs = [Request(prompt=list(range(3, 3 + n)), max_tokens=6,
                    stop_tokens=()) for n in (5, 19, 2, 11)]
    for kw in ({}, {"page_size": 8}):
        ce = ContinuousEngine(cfg, params, PoolConfig(n_slots=3, max_len=40,
                                                      **kw))
        out = ce.serve(reqs)
        with dispatch.use(backend="torch"):
            ref = ContinuousEngine(cfg, params, PoolConfig(
                n_slots=3, max_len=40, **kw)).serve(reqs)
        assert out == ref


# ==========================================================================
# the recurrent families (xlstm-1.3b, recurrentgemma-9b)
# ==========================================================================

@pytest.mark.parametrize("t,window", [(300, None), (300, 128), (520, 256)],
                         ids=["causal", "windowed", "windowed_long"])
@pytest.mark.parametrize("dtype,mainloop", [
    (torch.bfloat16, "wgmma"), (torch.bfloat16, "wmma"),
    (torch.float32, "simt")], ids=["bf16_wgmma", "bf16_wmma", "fp32_simt"])
def test_flash_head_dim_256(gen, dtype, mainloop, t, window):
    """RecurrentGemma's attention: 16 q heads over one kv head of 256,
    causal, and windowed with the window under T, on the (256, 256)
    instantiation of each mainloop (fp32 on 32-row tiles), against
    mha_ref; lse too."""
    q, k, v = _qkv(gen, 2, 16, 1, t, t, 256, dtype)
    FK.reset_flash_counts()
    o, lse = flash_attention_cuda(q, k, v, causal=True, window=window,
                                  return_residuals=True, plan=mainloop)
    assert flash_attention_cuda.mainloops[mainloop] == 1
    assert FK.head_dims(256, 256) == (256, 256)
    ro, rl = mha_ref(q, k, v, causal=True, window=window, return_lse=True)
    tol = TOL[dtype] if dtype == torch.float32 else dict(atol=2e-2,
                                                         rtol=2e-2)
    torch.testing.assert_close(o, ro, **tol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 512])
def test_matmul_four_columns_fp32_out_with_bias(gen, dtype, m):
    """mLSTM's input and forget gates: (m, 2048) @ (2048, 4) with a bias
    into fp32, on the non-TMA mainloop (n % 8 != 0), against plain."""
    x = torch.randn(m, 2048, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(2048, 4, device="cuda", generator=gen)
         * 2048 ** -0.5).to(dtype)
    bias = torch.full((4,), 3.0, device="cuda").to(dtype)
    assert plan_call(x, w).mainloop != "wgmma"
    got = matmul_cuda(x, w, bias, out_dtype=torch.float32)
    want = matmul_ref(x, w, bias, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, 4)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["xlstm-1.3b", "recurrentgemma-9b"])
def test_recurrent_engines_kernels_match_plain(gen, name):
    """Reduced xlstm / recurrentgemma in fp32: both engines' greedy tokens
    on the kernels equal the plain path's (prompts past recurrentgemma's
    window, slots reused)."""
    cfg = configs.get(name).reduced()
    params = api.init_params(cfg, gen)
    engine = Engine(cfg, params, ServeConfig(max_len=48))
    tokens = torch.randint(0, cfg.vocab, (2, 16), device="cuda",
                           generator=gen)
    got = engine.generate({"tokens": tokens}, n_tokens=12, stop_tokens=())
    with dispatch.use(backend="torch"):
        want = engine.generate({"tokens": tokens}, n_tokens=12,
                               stop_tokens=())
    assert torch.equal(got, want)
    reqs = [Request(prompt=list(range(3, 3 + n)), max_tokens=6,
                    stop_tokens=()) for n in (5, 16, 2, 11, 32)]
    ce = ContinuousEngine(cfg, params, PoolConfig(n_slots=3, max_len=48))
    out = ce.serve(reqs)
    with dispatch.use(backend="torch"):
        ref = ContinuousEngine(cfg, params, PoolConfig(
            n_slots=3, max_len=48)).serve(reqs)
    assert out == ref


def test_recurrentgemma_train_step_at_head_size_256(gen):
    """recurrentgemma's train step at its head size 256 (reduced width),
    in fp32 and in bf16: on the kernels the flash backward's (256, 256)
    instantiation runs on simt in fp32 and on wgmma in bf16, and the losses
    of two steps equal the plain path's within TRAIN_BAND's band of the
    dtype (1e-4 fp32, 2e-2 bf16)."""
    base = dataclasses.replace(configs.get("recurrentgemma-9b").reduced(),
                               head_dim=256, n_layers=3)
    ocfg = AdamWCfg()
    tokens = torch.randint(0, base.vocab, (2, 40), device="cuda",
                           generator=gen)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    for dtype, mainloop, band in (("float32", "simt", 1e-4),
                                  ("bfloat16", "wgmma", 2e-2)):
        cfg = dataclasses.replace(base, dtype=dtype)
        losses = {}
        for backend in ("cuda", "torch"):
            state = init_state(cfg, ocfg, torch.Generator().manual_seed(0),
                               "cuda")
            state["opt"]["step"] = 1500          # a non-zero learning rate
            reset_flash_bwd_counts()
            step = make_train_step(cfg, ocfg, backend=backend)
            losses[backend] = [float(step(state, batch)[1]["loss"])
                               for _ in range(2)]
            calls = 2 if backend == "cuda" else 0
            assert flash_attention_bwd_cuda.launches == calls
            assert flash_attention_bwd_cuda.mainloops[mainloop] == calls
        np.testing.assert_allclose(losses["cuda"], losses["torch"],
                                   atol=band, rtol=0, err_msg=dtype)


# --------------------------------------------------------------------------
# training every family: the backward's new head-size pairs, Tq != Tk, the
# batched GEMM's backward, and each family's train step
# --------------------------------------------------------------------------

# (b, hq, hkv, tq, tk, d, dv, causal, window); the first six in fp32 and
# bf16, seamless's 4096 frames in bf16 (the train path's dtype).
BWD_PAIRS = [
    (1, 4, 1, 300, 300, 256, 256, True, None),    # (256, 256), MQA
    (1, 8, 1, 520, 520, 256, 256, True, 128),     # windowed, MQA
    (2, 4, 2, 150, 70, 256, 256, False, 20),      # rows with no key
    (2, 4, 4, 200, 200, 192, 128, True, None),    # MLA's pair
    (1, 4, 4, 130, 300, 192, 128, False, None),   # MLA's, Tq < Tk
    (2, 4, 4, 100, 100, 24, 16, True, None),      # reduced MLA's, padded
]
BWD_FRAMES = [
    (2, 16, 16, 4096, 4096, 64, 64, False, None),  # seamless's encoder
    (2, 16, 16, 256, 4096, 64, 64, False, None),  # its cross-attention
    (2, 16, 16, 256, 1000, 64, 64, False, None),  # over ragged frames
]


@pytest.mark.parametrize("dtype,b,hq,hkv,tq,tk,d,dv,causal,window", [
    (dtype, *case) for dtype in (torch.float32, torch.bfloat16)
    for case in BWD_PAIRS] + [(torch.bfloat16, *case)
                              for case in BWD_FRAMES])
def test_flash_backward_new_pairs_and_cross_lengths(gen, dtype, b, hq, hkv,
                                                    tq, tk, d, dv, causal,
                                                    window):
    """The flash backward at head-size pairs (256, 256) and (192, 128),
    the reduced MLA's (24, 16) zero-padded to (32, 32), and non-causal at
    Tq != Tk, against plain autograd through mha_ref: each gradient within
    GRAD_BAND of its largest entry, of its unpadded shape; bf16 on wgmma,
    fp32 on simt; two calls bit for bit alike."""
    q, k = (torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype)
            .transpose(1, 2) for h, t in ((hq, tq), (hkv, tk)))
    v = torch.randn(b, tk, hkv, dv, device="cuda", generator=gen).to(
        dtype).transpose(1, 2)
    dy = torch.randn(b, tq, hq, dv, device="cuda", generator=gen).to(
        dtype).transpose(1, 2)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  return_residuals=True)
    planned = FB.plan_call(q, k, v, o, dy)
    assert planned == ("wgmma" if dtype == torch.bfloat16 else "simt")
    reset_flash_bwd_counts()
    got = flash_attention_bwd_cuda(q, k, v, o, lse, dy, causal=causal,
                                   window=window)
    want = flash_attention_bwd_ref(q, k, v, o, lse, dy, causal=causal,
                                   window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        _rel_close(g, w, GRAD_BAND[dtype], name)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, dy, causal=causal,
                                     window=window)
    for g, g2 in zip(got, again):
        torch.testing.assert_close(g2, g, atol=0, rtol=0)
    assert flash_attention_bwd_cuda.mainloops[planned] == 2


def test_flash_backward_refuses_a_pair_too_wide(gen):
    """A pair no instantiation holds raises; nothing runs the plain
    version instead."""
    q = torch.randn(1, 2, 8, 264, device="cuda", generator=gen)
    v = torch.randn(1, 2, 8, 128, device="cuda", generator=gen)
    lse = torch.zeros(1, 2, 8, device="cuda")
    with pytest.raises(ValueError, match="fit no instantiation"):
        flash_attention_bwd_cuda(q, q, v, v, lse, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,m,k,n,act,bias,bcast", [
    (8, 96, 128, 64, "silu", False, None),     # an MoE's gate GEMM
    (8, 96, 64, 128, "none", False, None),     # its down GEMM
    (4, 50, 40, 72, "gelu", True, "a"),        # broadcast a, a bias
    (4, 50, 40, 72, "relu", True, "b"),        # broadcast b
])
def test_batched_backward_matches_plain_autograd(gen, dtype, nb, m, k, n,
                                                 act, bias, bcast):
    """``batched_matmul``'s backward on the kernels (``_BatchedCuda``: the
    batched kernel for dA and dB, the transposed operand read in place, the
    pre-activation recomputed where the activation needs it, a broadcast
    operand summed over the batch) against plain autograd through
    batched_matmul_ref, within GRAD_BAND of each gradient's largest entry,
    with the launches the code gives."""
    a = torch.randn(*((m, k) if bcast == "a" else (nb, m, k)), device="cuda",
                    generator=gen).to(dtype)
    b = (torch.randn(*((k, n) if bcast == "b" else (nb, k, n)),
                     device="cuda", generator=gen) * k ** -0.5).to(dtype)
    bi = torch.randn(n, device="cuda", generator=gen).to(dtype) \
        if bias else None
    dy = torch.randn(nb, m, n, device="cuda", generator=gen).to(dtype)
    grads = []
    for backend in ("cuda", "torch"):
        leaves = [t.clone().requires_grad_() for t in (a, b)]
        lb = bi.clone().requires_grad_() if bias else None
        reset_matmul_counts()
        batched_matmul(*leaves, lb, activation=act,
                       backend=backend).backward(dy)
        grads.append([t.grad for t in leaves] + ([lb.grad] if bias else []))
        if backend == "cuda":
            assert batched_matmul_cuda.launches == 3 + \
                fusion.needs_preact(act)
    for name, g, w in zip(("da", "db", "dbias"), *grads):
        assert g.shape == w.shape, name
        _rel_close(g, w, GRAD_BAND[dtype], name)


@pytest.mark.parametrize("name", ["grok-1-314b", "deepseek-v3-671b",
                                  "xlstm-1.3b", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_family_train_step_kernels_against_plain(gen, name):
    """A reduced train step of each family on the kernels (the MoE
    experts' batched backward, MLA's (24, 16) flash backward padded,
    recurrentgemma's windowed flash, seamless's cross-attention at
    Tq != Tk) against the plain path, as chip_smoke's train_families phase
    holds them: in fp32 and in bf16, every gradient (``grad_errors``,
    floored at FAM_GRAD_FLOOR of its layer) within the larger of
    FAM_BAND's and twice the plain path's own FAM_SPREAD, every kernel
    launch of the bf16 pass against its plain version on its own inputs
    (``checked_launches``); then a bf16 step's launches as chip_smoke
    derives them from the code, every flash and batched call on wgmma."""
    b, t = 2, 32
    batch = {"tokens": torch.randint(0, configs.get(name).reduced().vocab,
                                     (b, t), device="cuda", generator=gen)}
    batch["labels"] = batch["tokens"].roll(-1, 1)
    src = None
    if name == "seamless-m4t-large-v2":
        src = 40
        batch["src_embeds"] = torch.randn(b, src, 128, device="cuda",
                                          generator=gen)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(configs.get(name).reduced(), dtype=dtype)
        model = api.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0))
        checked = {}
        with chip_smoke.checked_launches(checked, bf16_truth=True):
            errs, finite, (spread, _) = chip_smoke.grad_errors(
                model, batch, cfg, chip_smoke.FAM_GRAD_FLOOR,
                chip_smoke.FAM_SPREAD[dtype])
        limit = max(chip_smoke.FAM_BAND[dtype]["grad_rel_l2"],
                    2 * max(spread.values()))
        assert finite and max(errs.values()) <= limit, (dtype, max(
            errs.items(), key=lambda kv: kv[1]), limit)
        assert "matmul" in checked and all(
            v["over_band"] <= 1.0 for v in checked.values()), checked
    counters = chip_smoke.fam_counters()
    state = init_state(cfg, AdamWCfg(), torch.Generator().manual_seed(0),
                       "cuda")
    chip_smoke.reset_fam_counts(counters)
    make_train_step(cfg, AdamWCfg())(state, batch)
    launches = {k: c.launches for k, c in counters.items()}
    assert launches == chip_smoke.fam_step_launches(cfg, b, t, src)
    _, off = chip_smoke.fam_mainloops(counters, launches)
    assert not off, off


# --------------------------------------------------------------------------
# the encoder-decoder (seamless-m4t-large-v2)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tk", [(2, 256, 4096), (1, 128, 4096),
                                     (1, 37, 1000), (1, 1000, 1000)])
def test_flash_non_causal_cross_lengths(gen, dtype, b, tq, tk):
    """Cross-attention and the encoder: 16 heads of 64, non-causal, the
    queries' length apart from the memory's (4096, and a ragged 1000 whose
    last key tile is partial), against mha_ref; lse too."""
    q, _, _ = _qkv(gen, b, 16, 16, tq, tq, 64, dtype)
    _, k, v = _qkv(gen, b, 16, 16, tk, tk, 64, dtype)
    o, lse = flash_attention_cuda(q, k, v, causal=False,
                                  return_residuals=True)
    ro, rl = mha_ref(q, k, v, causal=False, return_lse=True)
    tol = TOL[dtype] if dtype == torch.float32 else dict(atol=2e-2,
                                                         rtol=2e-2)
    torch.testing.assert_close(o, ro, **tol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("m", [1, 4, 256])
def test_matmul_ragged_vocab_head(gen, m):
    """seamless's untied head: (m, 1024) bf16 @ (1024, 256206) into fp32,
    rows of the weight and of the output not 16-byte aligned, against
    matmul_ref."""
    x = torch.randn(m, 1024, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(1024, 256206, device="cuda", generator=gen)
         * 1024 ** -0.5).bfloat16()
    assert plan_call(x, w).mainloop == "wmma"
    got = matmul_cuda(x, w, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, 256206)
    torch.testing.assert_close(got, matmul_ref(x, w, out_dtype=torch.float32),
                               **TOL[torch.float32])


def test_encdec_paged_pool_keeps_cross_leaves(gen):
    """The paged pool's resident cross K and V on the card: ``insert``
    writes the slot's row, a paged decode on the kernels reads and leaves
    them, and its logits equal the slotted pool's decode."""
    from repro_torch.serve import PagedKVCache, SlotKVCache
    cfg = configs.get("seamless-m4t-large-v2").reduced()
    params = api.init_params(cfg, gen)
    src = torch.randn(1, 24, cfg.d_model, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab, (1, 9), device="cuda",
                           generator=gen)
    paged = PagedKVCache(cfg, 2, 32, page_size=8, src_len=24)
    slotted = SlotKVCache(cfg, 2, 32, src_len=24)
    with torch.inference_mode():
        rcache = paged.request_cache()
        logits, rcache = api.prefill(params, {"src_embeds": src,
                                              "tokens": tokens}, cfg, rcache)
        assert paged.insert(1, rcache, 9)
        slotted.insert(1, rcache)
        one = api.stack_layers(rcache)
        before = {k: paged.data[k].clone() for k in ("cross.k", "cross.v")}
        for k in before:
            assert torch.equal(paged.data[k][:, 1], one[k][:, 0])
        tok = torch.tensor([[0], [int(logits.argmax())]], device="cuda",
                           dtype=torch.int32)
        positions = np.array([0, 9])
        got, _, _ = api.decode_step_paged(
            params, tok, cfg, paged.data, paged.page_tables, positions,
            page_size=8)
        want, _ = api.decode_step_slots(params, tok, cfg, slotted.cache,
                                        positions)
    for k in before:
        assert torch.equal(before[k], paged.data[k])
    torch.testing.assert_close(got[1], want[1], **TOL[torch.float32])


def test_encdec_engines_kernels_match_plain(gen):
    """Reduced seamless in fp32: both engines' greedy tokens on the kernels
    (slotted, paged, chunked) equal the plain path's, one-token prompts
    among the requests."""
    cfg = configs.get("seamless-m4t-large-v2").reduced()
    params = api.init_params(cfg, gen)
    engine = Engine(cfg, params, ServeConfig(max_len=48, src_len=40))
    batch = {"src_embeds": torch.randn(2, 40, cfg.d_model, device="cuda",
                                       generator=gen),
             "tokens": torch.randint(0, cfg.vocab, (2, 16), device="cuda",
                                     generator=gen)}
    got = engine.generate(batch, n_tokens=12, stop_tokens=())
    with dispatch.use(backend="torch"):
        want = engine.generate(batch, n_tokens=12, stop_tokens=())
    assert torch.equal(got, want)
    reqs = [Request(prompt=list(range(3, 3 + n)), max_tokens=6,
                    stop_tokens=(), src_embeds=torch.randn(
                        40, cfg.d_model, device="cuda", generator=gen))
            for n in (5, 16, 1, 11, 24)]
    for pool in ({}, {"page_size": 8}, {"page_size": 8, "prefill_chunk": 8}):
        pcfg = PoolConfig(n_slots=3, max_len=48, src_len=40, **pool)
        out = ContinuousEngine(cfg, params, pcfg).serve(reqs)
        with dispatch.use(backend="torch"):
            ref = ContinuousEngine(cfg, params, pcfg).serve(reqs)
        assert out == ref, pool


@pytest.mark.parametrize("tier", ["decode_int8", "calibrated_int8",
                                  "calibrated_fp8"])
def test_encdec_quant_tiers_match_plain_greedy(gen, tier):
    """Reduced seamless in fp32 under each quant tier: the static engine's
    greedy tokens on the kernels equal the plain path's, with the launches
    the code gives (a prefill 6 GEMMs an encoder layer, 10 a decoder layer
    and the head; a decode step 8 a decoder layer and the head; every
    weight calibrated, the untied head too)."""
    cfg = configs.get("seamless-m4t-large-v2").reduced()
    params = api.init_params(cfg, gen)
    kw = {}
    if tier == "decode_int8":
        kw["decode_quant"] = "int8"
    else:
        params = quant.calibrate_params(params, tier.split("_")[1])
    engine = Engine(cfg, params, ServeConfig(max_len=32, src_len=40), **kw)
    batch = {"src_embeds": torch.randn(2, 40, cfg.d_model, device="cuda",
                                       generator=gen),
             "tokens": torch.randint(0, cfg.vocab, (2, 9), device="cuda",
                                     generator=gen)}
    matmul_cuda.launches = matmul_q_cuda.launches = 0
    got = engine.generate(batch, n_tokens=6, stop_tokens=())
    prefill = 6 * cfg.n_enc_layers + 10 * cfg.n_layers + 1
    decode = 8 * cfg.n_layers + 1
    expect = ((prefill, decode * 5) if tier == "decode_int8"
              else (0, prefill + decode * 5))
    assert (matmul_cuda.launches, matmul_q_cuda.launches) == expect
    with dispatch.use(backend="torch"):
        want = engine.generate(batch, n_tokens=6, stop_tokens=())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_router_replicas_match_one_engine(gen):
    """Two replicas on the card behind ``EngineRouter`` (least depth, so
    both serve): every request's greedy tokens equal one
    ``ContinuousEngine``'s of the same pool, the decode step being
    row-independent at a fixed slot count."""
    from repro_torch.serve import EngineReplica, EngineRouter
    cfg = configs.get("smollm-135m").reduced()
    params = api.init_params(cfg, gen)
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                    max_tokens=m, stop_tokens=())
            for n, m in zip([5, 20, 3, 17, 7, 11], [6, 4, 8, 3, 5, 7])]
    pcfg = PoolConfig(n_slots=3, max_len=32)
    want = ContinuousEngine(cfg, params, pcfg).serve(reqs)
    reset_matmul_counts()
    router = EngineRouter([EngineReplica(name, ContinuousEngine(
        cfg, params, pcfg)) for name in ("a", "b")])
    got = router.serve(reqs)
    assert matmul_cuda.launches > 0
    assert {t.replica.name for t in router.tickets.values()} == {"a", "b"}
    assert all(t.status == "completed" for t in router.tickets.values())
    assert [got[t] for t in sorted(got)] == [want[r] for r in sorted(want)]


def test_instrumented_card_engine_is_freed(gen):
    """``FaultInjector.instrument`` leaves no engine alive on the card:
    after ``del`` and a collection the engine is gone and its pool's
    memory with it."""
    import gc
    import weakref

    from repro_torch.serve import FaultInjector
    cfg = configs.get("smollm-135m").reduced()
    params = api.init_params(cfg, gen)
    engine = FaultInjector().instrument(
        ContinuousEngine(cfg, params, PoolConfig(n_slots=2, max_len=32)),
        "a")
    engine.serve([Request(prompt=[1, 2, 3], max_tokens=4, stop_tokens=())])
    torch.cuda.synchronize()
    ref = weakref.ref(engine)
    held = torch.cuda.memory_allocated()
    del engine
    gc.collect()
    assert ref() is None
    assert torch.cuda.memory_allocated() < held


# ---------------------------------------------------------------------------
# bf16 accumulation: each kernel against its blockwise plain version, at
# the reference's rounding points (core/blocking.py::accum_block), by
# chip_smoke.accum_check's measures and limits: within them, and the same
# wrapper with rounding block 0 (fp32 accumulation) told apart.
# ---------------------------------------------------------------------------

def accum_held(kernel, real, args, kw):
    res = chip_smoke.accum_check(kernel, args, kw, real)
    assert res["excess"] <= 1.0, (kernel, res)
    assert res["control"] is not None and res["control"] > 1.0, (kernel, res)


@pytest.mark.parametrize("dtype,case", [
    (torch.bfloat16, (96, 1300, 200, 0, 0, 0)),   # wgmma, a split plan
    (torch.bfloat16, (77, 1100, 133, 1, 1, 3)),   # wmma: unaligned rows
    (torch.float32, (40, 700, 72, 0, 1, 0)),      # simt
])
def test_accum_matmul_kernel(gen, dtype, case):
    m, k, n, xt, wt, pad = case
    x, w = _operands(gen, m, k, n, dtype, xt, wt, pad)
    rk = blocking.accum_block("matmul", k)
    assert plan_call(x, w, round_k=rk).splits == 1
    reset_matmul_counts()
    got = matmul_cuda(x, w, out_dtype=torch.float32, round_k=rk)
    assert matmul_cuda.split_launches == 0
    # rounded at the end: every output a bf16 value
    assert torch.equal(got, got.bfloat16().float())
    accum_held("matmul", matmul_cuda, (x, w),
               dict(out_dtype=torch.float32, round_k=rk))
    accum_held("matmul", matmul_cuda, (x, w), dict(round_k=rk))


@pytest.mark.parametrize("dtype,col_major", [
    (torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, False)])
def test_accum_stacked_and_batched_kernels(gen, dtype, col_major):
    nb, m, k, n = 4, 40, 300, 72
    a = chip_smoke.batched_entries(nb, m, k, col_major, dtype, gen)
    b = chip_smoke.batched_entries(nb, k, n, False, dtype, gen, k ** -0.5)
    rk = blocking.accum_block("brgemm", k)
    assert plan_stacked_call(a, b, round_k=rk).splits == 1
    reset_matmul_counts()
    brgemm_stacked_cuda(a, b, out_dtype=torch.float32, round_k=rk)
    assert brgemm_stacked_cuda.split_launches == 0
    accum_held("brgemm_stacked", brgemm_stacked_cuda, (a, b),
               dict(out_dtype=torch.float32, round_k=rk))
    a = chip_smoke.batched_entries(3, m, 1100, col_major, dtype, gen)
    b = chip_smoke.batched_entries(3, 1100, n, False, dtype, gen, 0.03)
    rk = blocking.accum_block("batched_matmul", 1100)
    accum_held("batched_matmul", batched_matmul_cuda, (a, b),
               dict(out_dtype=torch.float32, round_k=rk))


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (2, 32, 32, 3, 7, 64, 2, 3)),     # the stem: wmma
    (torch.bfloat16, (2, 14, 14, 64, 3, 64, 1, 1)),    # im2col wgmma
    (torch.bfloat16, (2, 14, 14, 160, 3, 32, 1, 1)),   # 64 + 64 + 32 channels
    (torch.bfloat16, (2, 14, 14, 256, 1, 64, 1, 0)),   # 1x1: SPLIT_K
    (torch.float32, (1, 9, 9, 40, 3, 8, 2, 1)),        # simt
])
def test_accum_conv_kernel(gen, dtype, shape):
    n, h, w_, c, r, k, stride, pad = shape
    x = torch.randn(n, h, w_, c, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(r, r, c, k, device="cuda", generator=gen)
         * (r * r * c) ** -0.5).to(dtype)
    kw = dict(stride=stride, padding=pad, out_dtype=torch.float32,
              round_c=blocking.accum_block("conv2d", c))
    reset_conv_counts()
    conv2d_cuda(x, w, **kw)
    assert conv2d_cuda.split_launches == 0
    accum_held("conv2d", conv2d_cuda, (x, w), kw)


@pytest.mark.parametrize("d,dv,mainloop,dtype", [
    (64, 64, "wgmma", torch.bfloat16), (32, 32, "wgmma", torch.bfloat16),
    (128, 128, "wgmma", torch.bfloat16), (192, 128, "wgmma", torch.bfloat16),
    (256, 256, "wgmma", torch.bfloat16), (64, 64, "wmma", torch.bfloat16),
    (64, 64, "simt", torch.float32)])
@pytest.mark.parametrize("kw,tq,tk", [
    (dict(causal=True), 300, 300), (dict(causal=True, window=100), 200, 200),
    (dict(causal=False), 70, 333)])
def test_accum_flash_kernels(gen, d, dv, mainloop, dtype, kw, tq, tk):
    q = torch.randn(2, 6, tq, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(2, 2, tk, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(2, 2, tk, dv, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(2, 6, tq, dv, device="cuda", generator=gen).to(dtype)
    kw = dict(kw, plan=mainloop,
              round_k=blocking.accum_block("flash_attention", tk))
    accum_held("flash_attention", flash_attention_cuda, (q, k, v),
               dict(kw, return_residuals=True))
    o, lse = flash_attention_cuda(q, k, v, return_residuals=True, **kw)
    accum_held("flash_attention_bwd", flash_attention_bwd_cuda,
               (q, k, v, o, lse, dy), kw)


def test_accum_quantized_gemm_unchanged(gen):
    """matmul_q keeps its storage's accumulator under the context: the same
    bits with and without it."""
    x = torch.randn(64, 576, device="cuda", generator=gen).bfloat16()
    w = torch.randn(576, 192, device="cuda", generator=gen).bfloat16()
    want = matmul(x, w, quant="int8")
    with dispatch.use(accum_dtype="bfloat16"):
        got = matmul(x, w, quant="int8")
    assert torch.equal(got, want)


def test_accum_train_step_rounds_forward_and_flash(gen):
    """A bf16 step of the reduced smollm on the kernels under bf16
    accumulation runs, its loss near fp32 accumulation's."""
    cfg = dataclasses.replace(configs.get("smollm-135m").reduced(),
                              dtype="bfloat16")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 256), device="cuda",
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab, (2, 256), device="cuda",
                                     generator=gen)}
    losses = {}
    for accum in (None, "bfloat16"):
        state = init_state(cfg, AdamWCfg(),
                           torch.Generator("cuda").manual_seed(1))
        _, m = make_train_step(cfg, AdamWCfg(), accum_dtype=accum)(state,
                                                                   batch)
        losses[accum] = float(m["loss"])
    assert abs(losses["bfloat16"] - losses[None]) < 0.1

"""Card-only tests of the port's CUDA kernels, of serving and of training
through them, of ResNet-50's path (the convolution, the stacked and
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
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import dispatch, fusion
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
from repro_torch.kernels.conv2d import conv2d, conv2d_cuda, conv2d_ref
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


@pytest.mark.parametrize("spec", ["int8", "fp8"])
def test_quantized_entry_points_launch_once(gen, spec):
    x = torch.randn(3, 5, 64, device="cuda", generator=gen)
    w = torch.randn(64, 32, device="cuda", generator=gen)
    a = torch.randn(4, 16, 64, device="cuda", generator=gen)
    b = torch.randn(4, 64, 32, device="cuda", generator=gen)
    counters = (matmul_q_cuda, brgemm_q_cuda, batched_matmul_q_cuda)
    before = [c.launches for c in counters]
    with torch.no_grad():
        got = [matmul(x, w, quant=spec), brgemm(a, b, quant=spec),
               batched_matmul(a, b, quant=spec)]
        assert [c.launches - n for c, n in zip(counters, before)] == [1] * 3
        with dispatch.use(backend="torch"):
            want = [matmul(x, w, quant=spec), brgemm(a, b, quant=spec),
                    batched_matmul(a, b, quant=spec)]
    assert [c.launches - n for c, n in zip(counters, before)] == [1] * 3
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

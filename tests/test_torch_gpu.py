"""Card-only tests of the port's CUDA kernels and of serving through them.

Marked ``gpu``; each test skips without a CUDA device (decided in a
fixture, so every test collects alike everywhere).  This file imports no
JAX: the machine with the card has none.  Run them there with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Tolerances as in ``chip_smoke.py``: fp32 sums in different orders
(1e-4), one bf16 ulp for bf16 outputs (1e-2), a few for bf16 attention
(2e-2).
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.core import dispatch, fusion
from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
from repro_torch.kernels.flash_attention import flash_attention_cuda, mha_ref
from repro_torch.models import api
from repro_torch.serve import Engine, ServeConfig

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


def test_cuda_backend_refuses_autograd(gen):
    cfg = configs.get("smollm-135m").reduced()
    params = api.init_params(cfg, gen)
    with pytest.raises(NotImplementedError, match="forward only"):
        api.forward(params, {"tokens": torch.zeros(1, 4, dtype=torch.long,
                                                   device="cuda")}, cfg)

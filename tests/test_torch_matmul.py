"""The matmul kernel's plan and its split-K sum, on the CPU.

``plan`` (``kernels/brgemm/kernel.py``) is plain Python: its choices are
held at every GEMM shape of the main paths (serving and training of
smollm-135m at chip_smoke.py's sizes, ResNet-50's weight gradients and
head at N = 32): the long reductions split (training's dW, ResNet's
weight gradients, decode's down projection), prefill, the rest of decode
and the LM head do not,
every bf16 operand the paths hand over is one TMA can read (the wgmma
mainloop), an operand TMA cannot describe takes the wmma body, fp32 the
simt one.  ``plan_call`` is held on CPU tensors laid out as the paths lay
them out.

A plain model of what the kernel computes under a plan that splits (fp32
partial sums over the plan's runs of k, added in split order, then the
epilogue once) is held against the reference's ``matmul_ref`` and its
``matmul_pallas`` in interpret mode, at ``tests/test_torch_kernels.py``'s
tolerances: fp32 3e-5 (sums in other orders), one bf16 ulp for bf16 out
(1e-2), the exp epilogue 1e-4 relative.

``conv2d.ops.patches`` lays the window operand out with a row stride of a
multiple of 8 elements, so that TMA can read the stem's ``cols.T``: its
values, and the weight gradient ``conv2d_bwd`` takes through it, are those
of the stacked taps it replaced.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.brgemm import ref as jref
from repro.kernels.brgemm.kernel import matmul_pallas
from repro_torch import configs
from repro_torch.core import fusion
from repro_torch.kernels.brgemm import matmul_ref
from repro_torch.kernels.brgemm.kernel import (MAINLOOPS, MIN_SPLIT_K, SMS,
                                               plan, plan_call)
from repro_torch.kernels.conv2d import conv2d_bwd, conv2d_ref
from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.kernels.conv2d.ops import patches
from repro_torch.models.resnet import ResNetCfg

RNG = np.random.default_rng(17)
F32 = dict(atol=3e-5, rtol=3e-5)
BF16_OUT = dict(atol=1e-2, rtol=1e-2)

CFG = configs.get("smollm-135m")
D, DQ, DKV, FF, V = (CFG.d_model, CFG.n_heads * CFG.dh,
                     CFG.n_kv_heads * CFG.dh, CFG.d_ff, CFG.vocab)
TOKENS = 8 * 512      # chip_smoke.py's prefill and train batch x sequence

# (name, m, k, n) of smollm-135m's GEMMs on the main paths.
SERVE = [("prefill.q", TOKENS, D, DQ), ("prefill.kv", TOKENS, D, DKV),
         ("prefill.o", TOKENS, DQ, D), ("prefill.gate_up", TOKENS, D, FF),
         ("prefill.down", TOKENS, FF, D), ("train.lm_head", TOKENS, D, V),
         ("train.dx.lm_head", TOKENS, V, D), ("train.dx.q", TOKENS, DQ, D),
         ("train.dx.kv", TOKENS, DKV, D), ("train.dx.gate_up", TOKENS, FF, D),
         ("train.dx.down", TOKENS, D, FF), ("train.dw.lm_head", D, TOKENS, V),
         ("lm_head.decode", 8, D, V), ("decode.q", 8, D, DQ),
         ("decode.kv", 8, D, DKV), ("decode.gate_up", 8, D, FF)]
LONG_K = [("train.dw.q", D, TOKENS, DQ), ("train.dw.kv", D, TOKENS, DKV),
          ("train.dw.o", DQ, TOKENS, D), ("train.dw.gate_up", D, TOKENS, FF),
          ("train.dw.down", FF, TOKENS, D), ("decode.down", 8, FF, D)]


def resnet_wgrads(n=32, hw=224):
    """(name, m = R*S*C, k = N*P*Q, n = K) of ResNet-50's weight-gradient
    GEMMs, one per distinct convolution."""
    cfg, out, seen = ResNetCfg(), [], set()
    h = conv_ref.out_size(hw, 7, 2, 3)
    out.append(("resnet.stem", 7 * 7 * 3, n * h * h, cfg.width))
    h = conv_ref.out_size(h, 3, 2, 1)          # the max pool
    cin = cfg.width
    for stage, blocks in enumerate(cfg.stage_blocks):
        mid = cfg.width * 2 ** stage
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            ho = conv_ref.out_size(h, 3, stride, 1)
            for name, rsc, k_out, p in (
                    ("a", cin, mid, h), ("b", 9 * mid, mid, ho),
                    ("c", mid, 4 * mid, ho)) + (
                    (("proj", cin, 4 * mid, ho),) if b == 0 else ()):
                key = (rsc, n * p * p, k_out)
                if key not in seen:
                    seen.add(key)
                    out.append((f"resnet.s{stage}{name}", *key))
            cin, h = 4 * mid, ho
    return out


def _check_covers(p, k):
    span = p.chunk * p.bk
    assert (p.splits - 1) * span < k <= p.splits * span


@pytest.mark.parametrize("name,m,k,n", SERVE, ids=[c[0] for c in SERVE])
def test_plan_short_reductions_and_lm_head_do_not_split(name, m, k, n):
    p = plan(m, n, k, True, True)
    assert p.mainloop == "wgmma" and p.splits == 1
    assert p.bm == (64 if m <= 64 else 128)
    _check_covers(p, k)


@pytest.mark.parametrize("name,m,k,n", LONG_K + resnet_wgrads(),
                         ids=[c[0] for c in LONG_K + resnet_wgrads()])
def test_plan_long_reductions_split(name, m, k, n):
    p = plan(m, n, k, True, True)
    assert p.mainloop == "wgmma"
    _check_covers(p, k)
    if 2 * p.tiles > SMS:            # the tiles alone fill the card
        assert p.splits == 1
        return
    assert p.splits > 1
    assert p.tiles < p.splits * p.tiles <= SMS     # one wave of blocks
    assert p.chunk * p.bk >= MIN_SPLIT_K


def test_plan_stem_fills_the_card():
    p = plan(147, 64, 32 * 112 * 112, True, True)
    assert (p.mainloop, p.bm, p.tiles) == ("wgmma", 128, 2)
    assert SMS - p.tiles < p.splits * p.tiles <= SMS and p.splits > 60
    # fp32: the simt tile, split as far
    p32 = plan(147, 64, 32 * 112 * 112, False, False)
    assert p32.mainloop == "simt" and p32.splits * p32.tiles > SMS
    _check_covers(p32, 32 * 112 * 112)


def test_plan_call_reads_the_paths_layouts():
    bf = torch.bfloat16
    x = torch.zeros(64, 576, dtype=bf)
    table = torch.zeros(1000, 576, dtype=bf)
    g = torch.zeros(64, 1000, dtype=bf)
    assert plan_call(x, table.T).mainloop == "wgmma"       # the head
    assert plan_call(g, table).mainloop == "wgmma"         # its dX
    assert plan_call(x.T, g).mainloop == "wgmma"           # its dW
    assert plan_call(x.float(), table.T.float()).mainloop == "simt"
    # The stem's window operand: rows 152 apart since patches pads them;
    # 147 apart (not a multiple of 8) TMA cannot read: the wmma body.
    img = torch.zeros(2, 16, 16, 3, dtype=bf)
    cols = patches(img, 7, 7, 2, 3)
    gy = torch.zeros(cols.size(0), 64, dtype=bf)
    assert cols.stride(0) == 152
    assert plan_call(cols.T, gy).mainloop == "wgmma"
    assert plan_call(cols.contiguous().T, gy).mainloop == "wmma"
    # A base 2 bytes off 16-byte alignment, or a row stride of 7: wmma.
    buf = torch.zeros(65, 576, dtype=bf)
    assert plan_call(buf.view(-1)[1:64 * 576 + 1].view(64, 576),
                     table.T).mainloop == "wmma"
    assert plan_call(torch.zeros(9, 7, dtype=bf),
                     torch.zeros(7, 8, dtype=bf)).mainloop == "wmma"
    assert set(MAINLOOPS) == {"wgmma", "wmma", "simt"}


def splitk_model(x, w, p, bias=None, c0=None, *, activation="none",
                 alpha=1.0, beta=0.0, out_dtype=None):
    """What the kernel computes under plan ``p``: fp32 partial products
    over its runs of ``p.chunk * p.bk`` of k, added in split order, then
    alpha, beta * c0, bias, the activation and the cast, once."""
    span = p.chunk * p.bk
    xf, wf = x.float(), w.float()
    acc = None
    for s in range(p.splits):
        part = xf[:, s * span:(s + 1) * span] @ wf[s * span:(s + 1) * span]
        acc = part if acc is None else acc + part
    acc = acc * alpha
    if c0 is not None and beta != 0.0:
        acc = acc + beta * c0.float()
    if bias is not None:
        acc = acc + bias.float()
    return fusion.apply(activation, acc).to(out_dtype or x.dtype)


def randn(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _tol(activation, out_dtype):
    if out_dtype == "bfloat16":
        return BF16_OUT
    return dict(atol=3e-5, rtol=1e-4) if activation == "exp" else F32


M, K, N = 9, 1024, 24          # one tile, k long enough to split


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["plain", "bias", "c0", "bias+c0"])
@pytest.mark.parametrize("activation", list(fusion.ACTIVATIONS))
@pytest.mark.parametrize("is_bf16", [True, False], ids=["wgmma", "simt"])
def test_split_sum_matches_reference(is_bf16, activation, epilogue,
                                     out_dtype):
    p = plan(M, N, K, is_bf16, is_bf16)
    assert p.splits > 1 and p.mainloop == ("wgmma" if is_bf16 else "simt")
    x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
    bias, c0 = randn(N), randn(M, N)
    use_bias, use_c0 = "bias" in epilogue, "c0" in epilogue
    kw = dict(activation=activation, alpha=0.75, beta=0.5 if use_c0 else 0.0)
    got = splitk_model(torch.from_numpy(x), torch.from_numpy(w), p,
                       torch.from_numpy(bias) if use_bias else None,
                       torch.from_numpy(c0) if use_c0 else None,
                       out_dtype=getattr(torch, out_dtype), **kw)
    want = jref.matmul_ref(jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(bias) if use_bias else None,
                           c0=jnp.asarray(c0) if use_c0 else None,
                           out_dtype=getattr(jnp, out_dtype), **kw)
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_tol(activation, out_dtype))
    port = matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(bias) if use_bias else None,
                      c0=torch.from_numpy(c0) if use_c0 else None,
                      out_dtype=getattr(torch, out_dtype), **kw)
    np.testing.assert_allclose(got.float().numpy(), port.float().numpy(),
                               **_tol(activation, out_dtype))


@pytest.mark.parametrize("activation,epilogue,out_dtype", [
    ("none", "plain", "float32"),
    ("silu", "plain", "bfloat16"),
    ("gelu", "bias", "float32"),
    ("relu", "c0", "float32"),
    ("tanh", "bias+c0", "bfloat16"),
    ("exp", "bias", "float32"),
])
def test_split_sum_matches_pallas_interpret(activation, epilogue, out_dtype):
    p = plan(M, N, K, True, True)
    x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
    bias, c0 = randn(N), randn(M, N)
    use_bias, use_c0 = "bias" in epilogue, "c0" in epilogue
    kw = dict(activation=activation, alpha=1.5, beta=0.25 if use_c0 else 0.0)
    got = splitk_model(torch.from_numpy(x), torch.from_numpy(w), p,
                       torch.from_numpy(bias) if use_bias else None,
                       torch.from_numpy(c0) if use_c0 else None,
                       out_dtype=getattr(torch, out_dtype), **kw)
    want = matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                         jnp.asarray(bias) if use_bias else None,
                         jnp.asarray(c0) if use_c0 else None,
                         out_dtype=getattr(jnp, out_dtype), interpret=True,
                         **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_tol(activation, out_dtype))


def test_split_sum_of_bf16_operands():
    """bf16 operands: every product exact in fp32, so the split sum and
    the reference's differ only in the order of fp32 additions."""
    p = plan(M, N, K, True, True)
    x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    got = splitk_model(xb, wb, p, out_dtype=torch.float32)
    want = jref.matmul_ref(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16),
                           out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _stacked_patches(x, r, s, stride, padding):
    """The window operand as it was built before its rows were padded: the
    R*S taps stacked, contiguous."""
    n, h, wi, c = x.shape
    if r == s == 1 and stride == 1 and padding == 0:
        return x.reshape(n * h * wi, c)
    p = conv_ref.out_size(h, r, stride, padding)
    q = conv_ref.out_size(wi, s, stride, padding)
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    taps = [xp[:, i:i + (p - 1) * stride + 1:stride,
               j:j + (q - 1) * stride + 1:stride]
            for i in range(r) for j in range(s)]
    return torch.stack(taps, dim=3).reshape(n * p * q, r * s * c)


PATCH_CASES = [(2, 9, 3, 7, 2, 3), (1, 8, 4, 3, 1, 1), (2, 7, 4, 1, 2, 0),
               (1, 6, 3, 1, 1, 0), (2, 10, 6, 3, 2, 1)]


@pytest.mark.parametrize("n,h,c,r,stride,padding", PATCH_CASES)
def test_patches_pads_rows_and_keeps_values(n, h, c, r, stride, padding):
    x = torch.from_numpy(randn(n, h, h, c))
    cols = patches(x, r, r, stride, padding)
    old = _stacked_patches(x, r, r, stride, padding)
    torch.testing.assert_close(cols, old, atol=0, rtol=0)
    if (r, stride, padding) == (1, 1, 0):     # x itself, viewed
        assert cols.data_ptr() == x.data_ptr()
    else:
        assert cols.stride(0) % 8 == 0 and cols.stride(1) == 1
    # A transposed view (as the layer's saved input may be) too.
    xt = x.transpose(1, 2)
    torch.testing.assert_close(patches(xt, r, r, stride, padding),
                               _stacked_patches(xt, r, r, stride, padding),
                               atol=0, rtol=0)


@pytest.mark.parametrize("n,h,c,r,stride,padding", PATCH_CASES)
def test_conv_bwd_weight_gradient_unchanged(n, h, c, r, stride, padding):
    k = 5
    x = torch.from_numpy(randn(n, h, h, c))
    w = torch.from_numpy(randn(r, r, c, k, scale=(c * r * r) ** -0.5))
    kw = dict(stride=stride, padding=padding, activation="none")
    y = conv2d_ref(x, w, **kw)
    dy = torch.from_numpy(randn(*y.shape))
    _, dw, _ = conv2d_bwd(conv2d_ref, matmul_ref, x, w, None, y, dy,
                          needs=(False, True, False), **kw)
    cols = _stacked_patches(x, r, r, stride, padding)
    want = matmul_ref(cols.T, dy.reshape(-1, k), out_dtype=torch.float32
                      ).reshape(r, r, c, k)
    torch.testing.assert_close(dw, want, **F32)

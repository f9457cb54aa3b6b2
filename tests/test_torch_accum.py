"""bf16 accumulation (``use(accum_dtype=...)``) in the port against the JAX
package, on the CPU.

Inputs are made from numpy seeds and cross as numpy arrays.  What is held,
and with which band:

  * resolution: the call's argument, else the innermost context, else
    fp32, as the reference's ``resolve_accum_dtype``;
  * the ``"torch"`` backends of ``matmul``, ``brgemm`` and
    ``batched_matmul`` against the reference's XLA backends under
    ``repro.use(accum_dtype=jnp.bfloat16)``: both round the product once
    to bf16, so they differ by at most one bf16 ulp of the largest output
    (a sum order that flips one rounding); ``conv2d`` and flash ignore
    the context on both sides;
  * each blockwise plain version (the one the kernels are held against on
    the card) against the reference's Pallas kernel under
    ``acc_dtype=jnp.bfloat16, interpret=True``, at shapes of three or more
    of the reference's reduction blocks.  The reference rounds each
    block's partial sum on its own before adding it and the port does
    not: about half a bf16 ulp of the accumulator a block, then one more
    for the output's own rounding, so the band is (blocks / 2 + 1) ulps
    of the largest |output|.  Each is also held to fp32 accumulation at
    the reference's own 0.1 / 0.1 (``tests/test_dispatch.py``);
  * the reduced smollm (the port's random weights from a seed, carried
    to the reference) through ``Engine`` and ``ContinuousEngine`` (``torch``
    backend) against the reference's under the same setting: prefill
    logits within LOGITS, and greedy tokens equal up to the first step
    whose reference top-two logit gap is within LOGITS (after which the
    two streams are no longer comparable);
  * one ``make_train_step`` step: the loss within LOSS and the gradients
    (AdamW's first moment after one step) within GRAD of the reference's.
    The reference's autodiff also rounds the backward products to bf16
    (their preferred element type); the port's backward GEMMs run in fp32,
    as the reference's kernel VJPs do, so the gradients differ by about a
    bf16 ulp (2^-8 relative);
  * ``chip_smoke.accum_check``, which holds the kernels on the card, on
    stand-ins for a wrapper: one that rounds where the blockwise version
    does passes and its fp32 control is told apart; one that accumulates
    in fp32 whatever it is asked, and one that writes zeros, fail;
  * the kernels' wiring with stand-ins for the CUDA wrappers: the forward
    launches get the reference's rounding block, the backward GEMMs 0,
    and the flash backward its forward's; a cached split-K plan is taken
    unsplit under bf16 accumulation.
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro
from repro import configs as jconfigs
from repro.core import dispatch as jdispatch
from repro.kernels.brgemm import kernel as jkernel
from repro.kernels.brgemm.ops import batched_matmul as jbatched_matmul
from repro.kernels.brgemm.ops import brgemm as jbrgemm
from repro.kernels.brgemm.ops import matmul as jmatmul
from repro.kernels.conv2d.kernel import conv2d_pallas
from repro.kernels.flash_attention.bwd import flash_attention_bwd_pallas
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.models import api as japi
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro.serve import PoolConfig as JPoolConfig
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.train import optimizer as jopt
from repro.train import train_step as jts
import repro_torch
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import blocking, dispatch
from repro_torch.core.blocking import Plan
from repro_torch.kernels.brgemm import kernel as K
from repro_torch.kernels.brgemm import ops as bops
from repro_torch.kernels.brgemm import ref as R
from repro_torch.kernels.conv2d import ref as CR
from repro_torch.kernels.conv2d.ops import conv2d
from repro_torch.kernels.flash_attention import bwd as FB
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import api as tapi
from repro_torch.serve import (ContinuousEngine, Engine, PoolConfig, Request,
                               ServeConfig)
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

RNG = np.random.default_rng(29)
BF16 = jnp.bfloat16
LOGITS = 5e-2       # bf16-rounded activations through 2 layers and the head
LOSS = 1e-2
GRAD = dict(atol=1e-3, rtol=5e-2)
REF_BAND = dict(atol=0.1, rtol=0.1)   # the reference's own, against fp32
MAX_LEN = 32


def randn(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def ulp(x) -> float:
    """One bf16 ulp of the largest |x|."""
    top = float(np.abs(np.asarray(x, np.float64)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def held(got, want, blocks, what):
    """got within (blocks / 2 + 1) bf16 ulps of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    band = (blocks / 2 + 1) * ulp(want)
    err = np.abs(got - want).max()
    assert err <= band, f"{what}: {err} > {band} ({blocks} blocks)"


# --------------------------------------------------------------------------
# resolution
# --------------------------------------------------------------------------

def test_accum_dtype_resolution_precedence():
    assert dispatch.resolve_accum_dtype() == torch.float32
    assert jdispatch.resolve_accum_dtype() == jnp.float32
    with repro_torch.use(accum_dtype="bfloat16"), \
            repro.use(accum_dtype=jnp.bfloat16):
        assert dispatch.resolve_accum_dtype() == torch.bfloat16
        assert jdispatch.resolve_accum_dtype() == jnp.bfloat16
        # the call's argument wins, as the reference's
        assert dispatch.resolve_accum_dtype(torch.float32) == torch.float32
        assert jdispatch.resolve_accum_dtype(jnp.float32) == \
            jnp.float32
        with repro_torch.use(accum_dtype=torch.float32):
            assert dispatch.resolve_accum_dtype() == torch.float32
        with repro_torch.use(backend="torch"):    # an unset field inherits
            assert dispatch.resolve_accum_dtype() == torch.bfloat16
        assert dispatch.snapshot()[3] == torch.bfloat16
    assert dispatch.resolve_accum_dtype() == torch.float32
    assert dispatch.accum_block("matmul", 700) == 0
    with repro_torch.use(accum_dtype=torch.bfloat16):
        assert dispatch.accum_block("matmul", 700) == 512
        assert dispatch.accum_block("matmul", 200) == 256
        assert dispatch.accum_block("conv2d", 3) == 128
        assert dispatch.accum_block("flash_attention", 300) == 128
    for bad in ("float16", torch.float16, "bf16", 3):
        with pytest.raises(ValueError, match="accum_dtype"):
            with repro_torch.use(accum_dtype=bad):
                pass


# --------------------------------------------------------------------------
# the "torch" backends against the reference's XLA backends
# --------------------------------------------------------------------------

def _gemm_case(op):
    if op == "matmul":
        return (randn(6, 300), randn(300, 20, scale=0.1)), jmatmul, \
            bops.matmul
    if op == "brgemm":
        return (randn(3, 6, 100), randn(3, 100, 20, scale=0.1)), jbrgemm, \
            bops.brgemm
    return (randn(2, 6, 300), randn(2, 300, 20, scale=0.1)), \
        jbatched_matmul, bops.batched_matmul


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["matmul", "brgemm", "batched_matmul"])
def test_torch_backends_round_once_as_the_xla_path(op, dtype):
    (a, b), jfn, tfn = _gemm_case(op)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with repro.use(accum_dtype=BF16, backend="xla"):
        want = np.asarray(jfn(j(a, jdt), j(b, jdt), out_dtype=jnp.float32))
    with repro_torch.use(accum_dtype="bfloat16", backend="torch"):
        got = tfn(t(a, tdt), t(b, tdt), out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= ulp(want), op
    # rounded once: every output is a bf16 value
    assert np.array_equal(got, t(got).to(torch.bfloat16).float().numpy())


def test_conv_and_flash_torch_backends_ignore_the_context():
    x, w = t(randn(1, 6, 6, 4)), t(randn(3, 3, 4, 8))
    q = t(randn(1, 2, 40, 16))
    want = (conv2d(x, w, padding=1, backend="torch"),
            flash_attention(q, q, q, backend="torch"))
    with repro_torch.use(accum_dtype="bfloat16"):
        got = (conv2d(x, w, padding=1, backend="torch"),
               flash_attention(q, q, q, backend="torch"))
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


# --------------------------------------------------------------------------
# the blockwise plain versions against the reference's Pallas kernels
# --------------------------------------------------------------------------

def _against_fp32(got, want_fp32, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want_fp32, np.float32),
                               err_msg=what, **REF_BAND)


@pytest.mark.parametrize("op", ["matmul", "brgemm_stacked", "batched_matmul"])
def test_gemm_blockwise_against_pallas(op):
    # three of the reference's k-blocks: 512 + 512 + 276 for matmul and
    # batched_matmul; three entries of one 256-block for the stacked walk
    if op == "matmul":
        a, b = randn(8, 1300), randn(1300, 16, scale=0.05)
        pallas, plain, blocks = jkernel.matmul_pallas, R.matmul_ref, 3
        rk = blocking.accum_block("matmul", 1300)
    elif op == "brgemm_stacked":
        a, b = randn(3, 8, 200), randn(3, 200, 16, scale=0.05)
        pallas, plain, blocks = jkernel.brgemm_stacked_pallas, R.brgemm_ref, 3
        rk = blocking.accum_block("brgemm", 200)
    else:
        a, b = randn(2, 8, 1100), randn(2, 1100, 16, scale=0.05)
        pallas, plain = jkernel.batched_matmul_pallas, R.batched_matmul_ref
        blocks = 3
        rk = blocking.accum_block("batched_matmul", 1100)
    want = np.asarray(pallas(j(a, BF16), j(b, BF16), interpret=True,
                             acc_dtype=BF16, out_dtype=jnp.float32))
    got = plain(t(a, torch.bfloat16), t(b, torch.bfloat16), round_k=rk,
                out_dtype=torch.float32).numpy()
    held(got, want, blocks, op)
    _against_fp32(got, plain(t(a, torch.bfloat16), t(b, torch.bfloat16),
                             out_dtype=torch.float32), op)


def test_conv_blockwise_against_pallas():
    # nine (tap, 128-channel block) steps; the stem's 3 channels a tap
    for c, pad in ((3, 1), (5, 0)):
        x, w = randn(1, 6, 6, c), randn(3, 3, c, 8, scale=0.2)
        want = np.asarray(conv2d_pallas(
            j(x, BF16), j(w, BF16), padding=pad, interpret=True,
            acc_dtype=BF16, out_dtype=jnp.float32))
        rc = blocking.accum_block("conv2d", c)
        got = CR.conv2d_ref(t(x, torch.bfloat16), t(w, torch.bfloat16),
                            padding=pad, round_c=rc,
                            out_dtype=torch.float32).numpy()
        held(got, want, 9, f"conv c={c}")
        _against_fp32(got, CR.conv2d_ref(t(x), t(w), padding=pad), "conv")


def test_flash_blockwise_against_pallas():
    kw = dict(causal=True, window=150)
    # 320 keys and q rows: three of the reference's 128-blocks each way
    q, k, v = randn(1, 2, 320, 32), randn(1, 1, 320, 32), randn(1, 1, 320, 32)
    dy = randn(1, 2, 320, 32)
    tq, tk, tv, tdy = (t(a, torch.bfloat16) for a in (q, k, v, dy))
    rk = blocking.accum_block("flash_attention", 320)
    o, lse = FR.flash_fwd_blockwise(tq, tk, tv, round_k=rk, **kw)
    jo, jlse = flash_attention_pallas(j(q, BF16), j(k, BF16), j(v, BF16),
                                      interpret=True, acc_dtype=BF16,
                                      return_residuals=True, **kw)
    held(o.float().numpy(), np.asarray(jo.astype(jnp.float32)), 3,
         f"flash forward {kw}")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-5)
    _against_fp32(o.float(), FR.mha_ref(tq, tk, tv, **kw).float(), "fwd")
    # the backward from the same residuals on both sides
    y = o
    got = FR.flash_bwd_blockwise(tq, tk, tv, y, lse, tdy, round_k=rk, **kw)
    want = flash_attention_bwd_pallas(
        j(q, BF16), j(k, BF16), j(v, BF16),
        jnp.asarray(y.float().numpy()).astype(BF16), jnp.asarray(lse.numpy()),
        j(dy, BF16), interpret=True, acc_dtype=BF16, **kw)
    fp32 = FR.flash_attention_bwd_ref(tq, tk, tv, y, lse, tdy, **kw)
    for name, g, wnt, f in zip(("dq", "dk", "dv"), got, want, fp32):
        held(g.float().numpy(), np.asarray(wnt.astype(jnp.float32)), 3,
             f"flash backward {name} {kw}")
        _against_fp32(g.float(), f.float(), name)


def _check_cases():
    """One launch of each kernel the smoke's ``accum_check`` holds:
    (kernel, args, kwargs), bf16, three or more rounding blocks."""
    g = torch.Generator().manual_seed(29)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).bfloat16()
    q, k, v, dy = (rnd(1, 2, 300, 32) for _ in range(4))
    kw = dict(causal=True, round_k=blocking.accum_block("flash_attention",
                                                        300))
    o, lse = FR.flash_fwd_blockwise(q, k, v, **kw)
    return {
        "matmul": ((rnd(24, 1300), rnd(1300, 40, scale=0.03)),
                   dict(round_k=blocking.accum_block("matmul", 1300))),
        "conv2d": ((rnd(1, 12, 12, 3), rnd(7, 7, 3, 16, scale=0.1)),
                   dict(stride=2, padding=3,
                        round_c=blocking.accum_block("conv2d", 3))),
        "flash_attention": ((q, k, v), dict(kw, return_residuals=True)),
        "flash_attention_bwd": ((q, k, v, o, lse, dy), kw),
    }


@pytest.mark.parametrize("kernel", ["matmul", "conv2d", "flash_attention",
                                    "flash_attention_bwd"])
def test_smoke_accum_check_tells_fp32_accumulation_apart(kernel):
    """``chip_smoke.accum_check`` on stand-ins for a kernel's wrapper: one
    that rounds where the blockwise plain version does passes, and its
    fp32 control is told apart; one that accumulates in fp32 whatever it
    is asked, and one that writes zeros, fail."""
    import chip_smoke
    args, kw = _check_cases()[kernel]

    def rounds(*a, **k):
        return chip_smoke.accum_plain(kernel, a, k)

    def fp32(*a, **k):
        return chip_smoke.accum_plain(kernel, a, chip_smoke._fp32_accum(k))

    def zeros(*a, **k):
        out = fp32(*a, **k)
        if kernel == "flash_attention":
            return torch.zeros_like(out[0]), out[1]
        if isinstance(out, tuple):
            return tuple(torch.zeros_like(x) for x in out)
        return torch.zeros_like(out)
    res = chip_smoke.accum_check(kernel, args, kw, rounds)
    assert res["excess"] <= 1.0 and res["control"] > 1.0, res
    for wrong in (fp32, zeros):
        res = chip_smoke.accum_check(kernel, args, kw, wrong)
        assert res["excess"] > 1.0, (wrong.__name__, res)


# --------------------------------------------------------------------------
# the kernels' wiring, with stand-ins for the CUDA wrappers
# --------------------------------------------------------------------------

def test_gemm_wiring_rounds_the_forward_only(monkeypatch):
    calls = []

    def fake(x, w, bias=None, c0=None, *, round_k=0, **kw):
        calls.append(round_k)
        return R.matmul_ref(x, w, bias, c0=c0, round_k=round_k, **kw)

    monkeypatch.setattr(K, "matmul_cuda", fake)
    x = t(randn(4, 700)).requires_grad_()
    w = t(randn(700, 8, scale=0.05)).requires_grad_()
    with repro_torch.use(accum_dtype="bfloat16"):
        y = bops._matmul_cuda(x, w, None, None, activation="gelu", alpha=1.0,
                              beta=0.0, out_dtype=None)
    y.sum().backward()
    # the forward at the reference's bk; the pre-activation recompute and
    # both backward products in fp32
    assert calls == [512, 0, 0, 0]
    calls.clear()
    with torch.no_grad():
        bops._matmul_cuda(x, w, None, None, activation="none", alpha=1.0,
                          beta=0.0, out_dtype=None)
    assert calls == [0]


def test_flash_backward_takes_its_forwards_accumulation(monkeypatch):
    seen = []

    def fwd(q, k, v, *, round_k=0, **kw):
        seen.append(("fwd", round_k))
        return FR.mha_ref(q, k, v, causal=kw["causal"], window=kw["window"],
                          scale=kw["scale"], return_lse=True)

    def bwd(q, k, v, y, lse, dy, *, round_k=0, **kw):
        seen.append(("bwd", round_k))
        return FR.flash_attention_bwd_ref(q, k, v, y, lse, dy, **kw)

    monkeypatch.setattr(FK, "flash_attention_cuda", fwd)
    monkeypatch.setattr(FB, "flash_attention_bwd_cuda", bwd)
    q = t(randn(1, 2, 16, 8)).requires_grad_()
    with repro_torch.use(accum_dtype="bfloat16"):
        o = fops._flash_cuda(q, q, q, causal=True, window=None, scale=None,
                             return_residuals=False)
    o.sum().backward()       # outside the context: the forward's carries
    with repro_torch.use(accum_dtype="bfloat16"):
        fops._flash_bwd_cuda(q, q, q, o, None, o, causal=True, window=None,
                             scale=None)
    assert seen == [("fwd", 128), ("bwd", 128), ("bwd", 128)]


def test_a_cached_split_plan_runs_unsplit_under_bf16_accumulation():
    split = Plan("wgmma", 64, 64, 4, 3, 1)
    x = torch.zeros(8, 768, dtype=torch.bfloat16)
    w = torch.zeros(768, 64, dtype=torch.bfloat16)
    a = torch.zeros(4, 8, 768, dtype=torch.bfloat16)
    b = torch.zeros(4, 768, 64, dtype=torch.bfloat16)
    dispatch.clear_tuning_cache()
    try:
        with repro_torch.use(blocks_policy=lambda *args, **kw: split):
            assert K.plan_call(x, w) == split
            assert K.plan_stacked_call(a, b) == split
            rk = blocking.accum_block("matmul", 768)
            p = K.plan_call(x, w, round_k=rk)
            assert (p.splits, p.chunk) == (1, 12)
            p = K.plan_stacked_call(a, b, round_k=rk)
            assert (p.splits, p.chunk) == (1, 48)
    finally:
        dispatch.clear_tuning_cache()


# --------------------------------------------------------------------------
# the reduced smollm: engines and a train step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get("smollm-135m").reduced()
    tcfg = tconfigs.get("smollm-135m").reduced()
    # the port's random weights from a seed, handed to the reference
    model = tapi.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    jparams = jax.tree.map(jnp.asarray, interop.params_to_numpy(model))
    return jcfg, tcfg, jparams, model


@functools.lru_cache(maxsize=None)
def _ref_forward(jcfg):
    """The reference's logits, jitted under the bf16-accumulation context
    (captured when it traces)."""
    with repro.use(accum_dtype=BF16, backend="xla"):
        fn = jax.jit(lambda p, x: japi.forward(p, {"tokens": x}, jcfg)[0])

    def logits(params, tokens):
        with repro.use(accum_dtype=BF16, backend="xla"):
            return fn(params, jnp.asarray(tokens))
    return logits


def _ref_gaps(jcfg, jparams, prompt, toks):
    """The reference's top-two logit gap at each generated token, under
    bf16 accumulation, from one forward over the prompt and the tokens."""
    seq = np.asarray(list(prompt) + list(toks)[:-1], np.int32)[None]
    logits = _ref_forward(jcfg)(jparams, seq)
    top2 = np.sort(np.asarray(logits[0, len(prompt) - 1:]), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _held_tokens(got, want, gaps, what):
    """Equal up to the first step whose reference gap is within LOGITS."""
    for i, (g, w) in enumerate(zip(got, want)):
        if gaps[i] <= LOGITS:
            return
        assert g == w, f"{what}: token {i} {g} != {w} (gap {gaps[i]})"
    assert len(got) == len(want), what


def test_engine_under_bf16_accumulation_matches_reference(pair):
    jcfg, tcfg, jparams, model = pair
    toks = RNG.integers(0, tcfg.vocab, (2, 9)).astype(np.int32)
    jlogits = _ref_forward(jcfg)(jparams, toks)
    with repro_torch.use(accum_dtype="bfloat16"), torch.no_grad():
        tlogits, _ = tapi.forward(model, {"tokens": torch.from_numpy(toks)},
                                  tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGITS, rtol=0)
    want = np.asarray(JEngine(jcfg, jparams, JServeConfig(max_len=MAX_LEN),
                              accum_dtype=BF16).generate(
        {"tokens": jnp.asarray(toks)}, n_tokens=6, stop_tokens=()))
    got = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN), device="cpu",
                 accum_dtype="bfloat16").generate(
        {"tokens": torch.from_numpy(toks)}, n_tokens=6,
        stop_tokens=()).numpy()
    for r in range(2):
        _held_tokens(got[r].tolist(), want[r].tolist(),
                     _ref_gaps(jcfg, jparams, toks[r], want[r]), f"row {r}")
    with pytest.raises(ValueError, match="accum_dtype"):
        Engine(tcfg, model, ServeConfig(max_len=8), device="cpu",
               accum_dtype="int8")


def test_continuous_engine_under_bf16_accumulation_matches_reference(pair):
    jcfg, tcfg, jparams, model = pair
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab, 6).tolist() for _ in range(3)]
    new = [5, 3, 6]
    want = JContinuousEngine(
        jcfg, jparams, JPoolConfig(n_slots=2, max_len=MAX_LEN),
        accum_dtype="bfloat16").serve(
            [JRequest(prompt=p, max_tokens=m, stop_tokens=())
             for p, m in zip(prompts, new)])
    eng = ContinuousEngine(tcfg, model, PoolConfig(n_slots=2,
                                                   max_len=MAX_LEN),
                           device="cpu", accum_dtype="bfloat16")
    got = eng.serve([Request(prompt=p, max_tokens=m, stop_tokens=())
                     for p, m in zip(prompts, new)])
    assert sorted(got) == sorted(want)
    for rid, p in zip(sorted(want), prompts):
        _held_tokens(list(got[rid]), list(want[rid]),
                     _ref_gaps(jcfg, jparams, p, want[rid]), f"request {rid}")


def test_train_step_under_bf16_accumulation_matches_reference(pair):
    jcfg, tcfg, jparams, _ = pair
    state = {"opt": jopt.adamw_init(jparams, jopt.AdamWCfg())}
    tree = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32),
             "labels": rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)}
    jstate, jmetrics = jax.jit(jts.make_train_step(
        jcfg, jopt.AdamWCfg(), backend="xla", accum_dtype=BF16))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate = {"opt": interop.opt_state_from_numpy(tree["opt"], tcfg, "cpu")}
    tstate, tmetrics = tts.make_train_step(
        tcfg, topt.AdamWCfg(), accum_dtype="bfloat16")(tstate, batch)
    assert abs(float(tmetrics["loss"]) - float(jmetrics["loss"])) <= LOSS
    # the first moment after one step is (1 - b1) g: the gradients
    want = dict(interop.named_leaves(
        jax.tree.map(np.asarray, jstate["opt"]["m"]), tcfg))
    for name, m in tstate["opt"]["m"].items():
        np.testing.assert_allclose(m.numpy(), want[name], err_msg=name,
                                   **GRAD)
    # and the loss moved off fp32 accumulation's by no more than the band
    fp32_state = {"opt": interop.opt_state_from_numpy(tree["opt"], tcfg,
                                                      "cpu")}
    _, fp32 = tts.make_train_step(tcfg, topt.AdamWCfg())(fp32_state, batch)
    assert abs(float(tmetrics["loss"]) - float(fp32["loss"])) <= 0.1

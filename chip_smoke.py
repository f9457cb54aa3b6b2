"""Drive the PyTorch port's serving, training, ResNet-50, batch-reduce
GEMM and quantized serving paths on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):
  1. device  — a CUDA card of compute capability 9.0; its name and power
               limit as nvidia-smi gives them.
  2. build   — the six kernel families (brgemm, flash_attention,
               flash_attention_bwd, conv2d, brgemm_batched, brgemm_quant)
               built from ``src/repro_torch/kernels/*/csrc`` by nvcc for
               sm_90a, in parallel; build seconds and the -Xptxas -v summary.
  3. parity  — each kernel against its plain PyTorch version on the card, at
               the main paths' shapes: smollm-135m's (B = 8 prompts of 512
               tokens; training's backward GEMMs, X or W read transposed in
               place; the flash forward causal, windowed and not, d = 32,
               64 and 128, Tq != Tk, and on views TMA cannot read; the flash
               backward and its fused delta, on wgmma for bf16 (two calls
               bit for bit alike) and on views TMA cannot read; a flash row
               with no valid key, forward and backward); matmul's plans
               (each layout of X and W, split and not, every epilogue,
               ragged shapes, row strides TMA cannot read) and ResNet-50's
               stem weight gradient against float64; the direct
               convolution forward and its
               dgrad dual at ResNet-50's layer shapes (N = 32); the stacked
               brgemm at the paper's cases (on wgmma for bf16, split or not,
               with each epilogue, transposed, and on strides TMA cannot
               read) and the batched GEMM broadcast and
               transposed as brgemm's backward reads it, ragged in m, n and
               k, with each epilogue, and on strides TMA cannot read (the
               wmma tile); in fp32 and bf16,
               within stated bands; the quantized GEMMs (int8, e4m3, e5m2;
               bf16 and fp32 out) at the quantized serving path's shapes and
               the paper's cases.
  4. serve   — full-width smollm-135m (random weights from a seed)
               ``Engine.generate``: 8 prompts x 512 tokens, 64 greedy
               tokens, bf16.  Once on the kernels (counting launches, and
               matmul's and the flash forward's calls by mainloop: bf16 on
               wgmma only, fp32 on simt, in this phase, train, resnet and
               quant; the flash backward's alike in train, batched_matmul's
               and brgemm_stacked's in brgemm) and
               once with ``use(backend="torch")``; prefill logits compared;
               then the same in fp32, where the greedy tokens must match.
               Prefill and decode-step times of the kernel path, the
               device's busy and idle share of decode steps under
               torch.profiler, and the host's time by function under
               cProfile.
  5. train   — full-width smollm-135m (random weights from a seed), B = 8
               sequences of 512 tokens of the ported synthetic stream:
               4 steps of ``make_train_step`` on the kernels (counting
               launches), then the same 4 steps from the same state and
               batches with ``use(backend="torch")``; step-0 loss and
               every parameter's step-0 gradient compared, and the loss
               trajectory; in bf16, then in fp32 with tighter bands.  Step
               time, tokens/s, peak memory, and the device's busy and idle
               share of a step under torch.profiler.
  6. resnet  — full-width ResNet-50 (random weights from a seed), 32 images
               of 224 x 224: one forward and one gradient step on the
               kernels (exact launch counts), then on the plain path;
               logits, loss and every parameter's gradient compared; bf16,
               then fp32.  Forward ms, images/s, step ms, peak memory, and
               the device's busy and idle share under torch.profiler.
  7. brgemm  — the paper's ``brgemm`` (forward and backward) and
               ``batched_matmul`` entry points at the paper's cases, on the
               kernels (exact launch counts) and on the plain path.
  8. quant   — the serving run of phase 4 (bf16) in three quant tiers:
               ``decode_quant="int8"`` on full-precision weights, weights
               calibrated to int8, weights calibrated to fp8 (e4m3); on the
               kernels (exact launch counts) and on the plain path; prefill
               logits within a band, prefill and decode-step times and the
               device's idle share beside phase 4's; the calibrated int8
               tier in fp32, where the greedy tokens must match; then
               ``brgemm(quant=)`` and ``batched_matmul(quant=)`` at the
               paper's cases.
  9. times   — each kernel's device time (a CUDA graph of its calls; the
               profiler where a call cannot be captured) and back-to-back wall
               time (CUDA events) at each main-path shape, serving's,
               training's, ResNet-50's, brgemm's and the quantized
               serving's, beside its bound (at the input type's peak), its
               plain version and one library call.
Then the kernels line, the card line, and ``{"ok": true, ...}`` last.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import cProfile
import dataclasses
import json
import math
import pstats
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SEED = 0
BATCH, PROMPT, NEW_TOKENS, MAX_LEN = 8, 512, 64, 1024
# T = 512, not SmolLM's 2048: the plain path on the card keeps a T^2 fp32
# score tensor per layer for autograd, which at 2048 and 30 layers would
# press on 80 GB.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 4
FAMILIES = ("brgemm", "flash_attention", "flash_attention_bwd", "conv2d",
            "brgemm_batched", "brgemm_quant")
RESNET_BATCH, RESNET_HW = 32, 224
# ResNet-50's convolution layers as the paper's Table 2 lists them
# (benchmarks/common.py): id, C, K, H (= W), R (= S), stride.  The
# reference's model puts the stride on the 3x3 convolution, so its own
# shapes (resnet_convs) add a few; parity runs both.
RESNET50_LAYERS = [
    (1, 3, 64, 224, 7, 2), (2, 64, 256, 56, 1, 1), (3, 64, 64, 56, 1, 1),
    (4, 64, 64, 56, 3, 1), (5, 256, 64, 56, 1, 1), (6, 256, 512, 56, 1, 2),
    (7, 256, 128, 56, 1, 2), (8, 128, 128, 28, 3, 1),
    (9, 128, 512, 28, 1, 1), (10, 512, 128, 28, 1, 1),
    (11, 512, 1024, 28, 1, 2), (12, 512, 256, 28, 1, 2),
    (13, 256, 256, 14, 3, 1), (14, 256, 1024, 14, 1, 1),
    (15, 1024, 256, 14, 1, 1), (16, 1024, 2048, 14, 1, 2),
    (17, 1024, 512, 14, 1, 2), (18, 512, 512, 7, 3, 1),
    (19, 512, 2048, 7, 1, 1), (20, 2048, 512, 7, 1, 1)]
# The paper's brgemm cases (benchmarks/bench_brgemm.py), (B, m, k, n), and
# one that fills the card.
BRGEMM_CASES = [(16, 64, 64, 64), (32, 128, 128, 128), (64, 64, 256, 64),
                (8, 4096, 1024, 1024)]

# Tolerances, |kernel - plain| <= atol + rtol * |plain|, and why:
#   fp32 GEMM / attention: both accumulate fp32 in different orders, with no
#     TF32 on either side; the observed spread is ~1e-6 of values ~5.
#   bf16-out GEMM: both round the same fp32 sum to bf16, so they differ by at
#     most one bf16 ulp where the sums fall on either side of a rounding
#     boundary (2^-7 relative at |x| in [1, 2), 1.6e-2 at |x| in [2, 4)).
#   bf16 attention: the kernel rounds p = exp(s - m_running) to bf16, the
#     plain version p / l after a full softmax; a few bf16 ulps.
#   lse: fp32 on both sides.
#   delta: fp32 sums of d = 64 products on both sides; the fused delta and
#     the standalone kernel's share one reduction and must agree exactly.
TOL = {
    ("matmul", torch.float32): (1e-4, 1e-4),
    ("matmul", torch.bfloat16): (1e-2, 1e-2),
    ("flash_attention", torch.float32): (1e-4, 1e-4),
    ("flash_attention", torch.bfloat16): (2e-2, 2e-2),
    ("lse", None): (1e-4, 1e-5),
    ("delta", None): (1e-4, 1e-4),
}
# Flash backward, kernel against plain autograd of mha_ref, as
# max |kernel - plain| <= band * max |plain| per gradient: fp32 sums in
# other orders (1e-4); in bf16 the kernel rounds P and dS to bf16 before
# each product, as the reference's kernel does, while the plain version
# differentiates in fp32 and rounds once at the end: a few bf16 ulps of the
# largest entry (3e-2).
GRAD_BAND = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Full-width training, kernels vs plain on one card, bands stated before the
# first run: the step-0 loss (~log 49152 = 10.8) and the 4-step trajectory
# (absolute), and every parameter's step-0 gradient as relative L2 error
# ||g_kernel - g_plain|| / ||g_plain||.  bf16 rounds every activation and
# every gradient to bf16 at other places on the two paths, through 30
# layers and back; fp32 differs in sum order only (GEMMs, and the
# embedding's scatter-add, whose atomics add in a run-dependent order).
TRAIN_BAND = {torch.bfloat16: {"loss": 2e-2, "grad_rel_l2": 5e-2},
              torch.float32: {"loss": 1e-4, "grad_rel_l2": 1e-4}}
# Full-width serving, kernels vs plain on one card, prefill logits (fp32
# values ~N(0, 1) over 49152 entries): bf16 runs round every activation to
# bf16 in 30 layers on both paths, and a one-ulp flip early spreads, so the
# bf16 band is wide; fp32 runs agree to fp32 sum order.
LOGITS_BAND = {torch.bfloat16: 0.25, torch.float32: 1e-3}
# The convolution and the stacked / batched GEMMs against their plain
# versions: fp32 within 1e-4 of the largest |output| (sums in other
# orders); bf16 outputs within one bf16 ulp (both round one fp32 sum).
CONV_BAND = 1e-4
# Full-width ResNet-50, kernels vs plain on one card, as relative L2 error
# of the logits, relative error of the loss and each parameter's gradient's
# relative L2 error, stated before the first run: fp32 differs in sum order
# only; bf16 rounds every convolution's output, and the gradients'
# operands, to bf16 at other places through 53 layers and back.  The run
# showed the network too chaotic at its random initialisation for these
# alone to hold (phase_resnet says what is held instead).
RESNET_BAND = {torch.float32: 1e-3, torch.bfloat16: 5e-2}

# The quantized GEMMs against their plain versions, |kernel - plain| <= atol
# + rtol |plain|, stated before the first run: int8 with no activation
# exactly, with bf16 or fp32 out (the int32 sum is exact, the plain version
# takes the same integer in float64, and both round the same fp32 epilogue,
# acc * (sx * sw), * alpha, + bias, one rounding each, then the same cast);
# int8 with an activation: the kernel's expf / tanhf against PyTorch's, a
# few fp32 ulps (1e-5), or one bf16 ulp where that flips a bf16 rounding;
# fp8: exact operands and products, fp32 sums in other orders, as the fp32
# GEMM (1e-4), one bf16 ulp for bf16 out.
def quant_tol(fmt, out_dtype, activation="none"):
    if fmt == torch.int8 and activation == "none":
        return (0.0, 0.0)
    if out_dtype == torch.bfloat16:
        return TOL[("matmul", torch.bfloat16)]
    return (1e-5, 1e-5) if fmt == torch.int8 else TOL[("matmul",
                                                        torch.float32)]


# Full-width quantized serving, prefill logits.  The quantized GEMMs agree
# exactly on equal inputs, but the attention (the flash kernel against
# mha_ref) and the full-precision GEMMs (the head; decode_int8's prefill)
# sum in other orders, and such a difference now and then flips an
# activation's int8 rounding (a step of 1/127 of its row's absmax) that
# later layers carry, and flip more roundings: rounding is discontinuous,
# so the two paths drift apart by quantization steps, not by ulps.
#   bf16: phase 4's band of 0.25 alone does not hold on an H100
#     (calibrated int8: 0.281 from the plain path, against 0.088 at full
#     precision), so, as phase_resnet does, each bf16 tier is held against
#     the plain path in fp32 on the same bf16 weight values (calibrated
#     alike): the kernels within 0.25 of it, or no further from it than
#     1.25 times the plain bf16 path is.
#   fp32 (calibrated int8): on an H100 the kernel path's logits lie 0.186
#     from the plain path's and 51.6 % of its greedy tokens equal the
#     plain path's, with every quantized GEMM exact.  So it is held two
#     ways.  With the prefill attention of the kernel
#     path swapped for the plain one, the quantized GEMMs are the kernels
#     left (with the head's full-precision GEMM): greedy tokens equal to
#     the plain path's and prefill logits within phase 4's fp32 band
#     (1e-3).  With the flash kernel in place, the kernel path's logits
#     differ from the plain path's by at most twice (relative L2) what the
#     plain path's own logits move when only its prefill attention runs on
#     the flash kernel.
QUANT_LOGITS_BAND = {torch.bfloat16: 0.25, torch.float32: 1e-3}
QUANT_TIERS = (   # name, Engine quant kwargs, calibration
    ("decode_int8", {"decode_quant": "int8"}, None),
    ("calibrated_int8", {}, "int8"),
    ("calibrated_fp8", {}, "fp8"),
)

# Published dense peaks (NVIDIA data sheets), by the card nvidia-smi names:
# bf16 tensor FLOP/s, int8 / fp8 tensor OP/s, HBM bytes/s.
PEAKS = {
    "sxm": (989e12, 1979e12, 3.35e12),
    "pcie": (756e12, 1513e12, 2.0e12),
    "nvl": (835e12, 1671e12, 3.9e12),
}
EIGHT_BIT = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name: str, dtype=torch.bfloat16):
    """(tensor-core peak for ``dtype``'s inputs, memory bytes/s)."""
    low = name.lower()
    bf16, eight, bw = PEAKS["pcie" if "pcie" in low else "nvl" if "nvl" in
                            low else "sxm"]
    return (eight if dtype in EIGHT_BIT else bf16), bw


# --------------------------------------------------------------------------
# 1-2. device and build
# --------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (Hopper),"
                         f" got {cap}")
    line = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(cap), "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return line


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(FAMILIES)) as ex:   # one nvcc each, together
        built = list(ex.map(_build.build, FAMILIES))
    wall = time.perf_counter() - t0
    for b in built:
        lines = [ln.strip() for ln in b.ptxas.splitlines()
                 if "registers" in ln or "spill" in ln]
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "Used " in ln]
        spills = sum(1 for ln in lines for st, ld in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if int(st) or int(ld))
        smem = [int(s) for s in re.findall(r"(\d+) bytes smem", b.ptxas)]
        emit({"phase": "build", "kernel": b.name, "nvcc_s": b.seconds,
              "library": b.path.name, "kernels_compiled": len(regs),
              "registers_min_max": [min(regs), max(regs)] if regs else None,
              # static shared memory; the flash kernel's is dynamic
              "static_smem_bytes_max": max(smem, default=0),
              "entries_with_spills": spills,
              "ptxas_sample": [ln for ln in lines if "Used" in ln][:4]})
    emit({"phase": "build", "wall_s": wall})


# --------------------------------------------------------------------------
# 3. kernels against their plain versions
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Gemm:
    name: str
    m: int
    k: int
    n: int
    activation: str = "none"
    # How the operands lie, as the path hands them over:
    #   "fwd"  x row-major, w row-major           (x @ W)
    #   "head" x row-major, w = table.T col-major (x @ table.T), fp32 out
    #   "dx"   x = g row-major, w = W.T col-major (g @ W.T)
    #   "dx_head" x = g, w = table row-major      (g @ table)
    #   "dw"   x = X.T col-major, w = g row-major (X.T @ g)
    #   "pre"  as "fwd", fp32 out                 (silu pre-activation)
    kind: str = "fwd"
    per_forward: int = 0      # launches in one serving forward
    per_step: int = 0         # launches in one train step

    @property
    def out_dtype(self):
        return torch.float32 if self.kind in ("head", "pre") else None


def main_path_gemms(cfg):
    """Serving's GEMMs; the prefill ones (m = 8 x 512 tokens) are also the
    train step's forward GEMMs."""
    d, dq, dkv, f = cfg.d_model, cfg.n_heads * cfg.dh, \
        cfg.n_kv_heads * cfg.dh, cfg.d_ff
    L, out = cfg.n_layers, []
    for phase, m in (("prefill", BATCH * PROMPT), ("decode", BATCH)):
        step = L if phase == "prefill" else 0
        out += [Gemm(f"{phase}.q", m, d, dq, per_forward=L, per_step=step),
                Gemm(f"{phase}.kv", m, d, dkv, per_forward=2 * L,
                     per_step=2 * step),
                Gemm(f"{phase}.o", m, dq, d, per_forward=L, per_step=step),
                Gemm(f"{phase}.gate_silu", m, d, f, "silu", per_forward=L,
                     per_step=step),
                Gemm(f"{phase}.up", m, d, f, per_forward=L, per_step=step),
                Gemm(f"{phase}.down", m, f, d, per_forward=L,
                     per_step=step)]
    # The head sees the last position only, in prefill and in decode.
    out.append(Gemm("lm_head", BATCH, d, cfg.vocab, kind="head",
                    per_forward=1))
    return out


def train_gemms(cfg):
    """The train step's GEMMs beyond serving's prefill shapes: the head at
    every position, each projection's dX and dW, and the gate's
    pre-activation recompute, with their launches per step."""
    d, dq, dkv, f, v = cfg.d_model, cfg.n_heads * cfg.dh, \
        cfg.n_kv_heads * cfg.dh, cfg.d_ff, cfg.vocab
    L, m = cfg.n_layers, TRAIN_BATCH * TRAIN_SEQ
    out = [Gemm("train.lm_head", m, d, v, kind="head", per_step=1),
           Gemm("train.dx.lm_head", m, v, d, kind="dx_head", per_step=1),
           Gemm("train.dw.lm_head", d, m, v, kind="dw", per_step=1),
           Gemm("train.pre.gate", m, d, f, kind="pre", per_step=L)]
    for name, k, n, per in (("q", d, dq, L), ("kv", d, dkv, 2 * L),
                            ("o", dq, d, L), ("gate_up", d, f, 2 * L),
                            ("down", f, d, L)):
        out += [Gemm(f"train.dx.{name}", m, n, k, kind="dx", per_step=per),
                Gemm(f"train.dw.{name}", k, m, n, kind="dw", per_step=per)]
    return out


def gemm_inputs(g: Gemm, dtype, gen):
    """x (m, k) and w (k, n) laid out as the path hands them over; values
    scaled so that outputs are O(1)."""
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    if g.kind == "dw":                    # X.T of an activation (k, m)
        return randn(g.k, g.m).T, randn(g.k, g.n, scale=g.k ** -0.5)
    x = randn(g.m, g.k)
    if g.kind in ("head", "dx"):          # table.T or W.T, read in place
        return x, randn(g.n, g.k, scale=g.k ** -0.5).T
    return x, randn(g.k, g.n, scale=g.k ** -0.5)


def close(got, ref, atol, rtol):
    diff = (got.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return ok, diff.max().item(), (diff / ref.float().abs().clamp_min(1e-3)
                                   ).max().item()


def qkv_views(b, hq, hkv, t, d, dtype, gen, tk=None):
    """(B, T, H, d) activations viewed as (B, H, T, d), as the attention
    layer's head split hands them over (q, k, v, and a dY of q's shape);
    k and v ``tk`` long where given."""
    return tuple(torch.randn(b, n, h, d, device="cuda", generator=gen)
                 .to(dtype).transpose(1, 2)
                 for h, n in ((hq, t), (hkv, tk or t), (hkv, tk or t),
                              (hq, t)))


def batched_entries(nb, r, c, col_major, dtype, gen, scale=1.0):
    """(nb, r, c) entries (a 2-D (r, c) matrix for nb = 0), row- or
    column-major, each memory row padded to a multiple of 8 elements, as
    TMA reads them."""
    inner, outer = (r, c) if col_major else (c, r)
    lead = (nb,) if nb else ()
    buf = (torch.randn(*lead, outer, -(-inner // 8) * 8, device="cuda",
                       generator=gen) * scale).to(dtype)[..., :inner]
    return buf.transpose(-1, -2) if col_major else buf


def overlapping_rows(b, h, t, d, dtype, gen):
    """A (B, H, T, d) view whose rows overlap (8 elements apart): legal for
    the first flash kernel, not for TMA (plan: wmma in bf16)."""
    buf = torch.randn(b * h * (8 * t + d), device="cuda",
                      generator=gen).to(dtype)
    return buf.as_strided((b, h, t, d), (h * (8 * t + d), 8 * t + d, 8, 1))


def plan_cases(dtype, gen):
    """(case, x, w, kwargs) covering matmul's plans beyond the main paths'
    shapes: each layout of X and W, with and without a split of k, every
    epilogue (bias, c0 with beta, alpha, each activation, bf16 and fp32
    out); a ragged m, k and n that TMA reads through padded row strides;
    row strides TMA cannot describe (the wmma body in bf16)."""
    from repro_torch.core import fusion

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    def operands(m, k, n, xt, wt, pad=0):
        # rows `pad` elements longer than needed; pad < 0: rounded up to 8
        def rows(inner):
            return -(-inner // 8) * 8 if pad < 0 else inner + pad
        x = randn(k, rows(m))[:, :m].T if xt else randn(m, rows(k))[:, :k]
        w = (randn(n, rows(k), scale=k ** -0.5)[:, :k].T if wt
             else randn(k, rows(n), scale=k ** -0.5)[:, :n])
        return x, w

    out = []
    for m, k, n in ((304, 576, 576), (96, 4096, 200)):   # no split, split
        for xt in (0, 1):
            for wt in (0, 1):
                x, w = operands(m, k, n, xt, wt)
                out.append((f"m{m} k{k} n{n}", x, w, {}))
        for i, act in enumerate(fusion.ACTIVATIONS):
            x, w = operands(m, k, n, i % 2, i // 2 % 2)
            kw = dict(activation=act, alpha=0.5, beta=0.75,
                      out_dtype=torch.float32 if i % 3 == 1 else None)
            out.append((f"m{m} k{k} n{n} bias c0 {act}", x, w,
                        dict(bias=randn(n), c0=randn(m, n), **kw)))
    x, w = operands(77, 100, 133, 0, 0, pad=-1)
    out.append(("ragged m77 k100 n133, rows padded to 8", x, w, {}))
    x, w = operands(77, 100, 133, 1, 1, pad=3)
    out.append(("ragged m77 k100 n133, rows 80 and 103 apart", x, w, {}))
    x, w = operands(96, 4096, 200, 1, 0, pad=3)
    out.append(("m96 k4096 n200, rows 99 apart", x, w, {}))
    return out


def stem_wgrad_errors(dtype, gen):
    """ResNet-50's stem weight gradient at N = 32, fp32 out: the window
    operand as conv2d's backward makes it (rows padded to 152) read
    transposed, k = 401,408, against float64, in units of the fp32
    summation bound checked_launches holds (<= 1 passes)."""
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.conv2d.ops import patches
    x = torch.randn(RESNET_BATCH, RESNET_HW, RESNET_HW, 3, device="cuda",
                    generator=gen).to(dtype)
    cols = patches(x, 7, 7, 2, 3)
    g = (torch.randn(cols.size(0), 64, device="cuda", generator=gen)
         * 1e-2).to(dtype)
    got = matmul_cuda(cols.T, g, out_dtype=torch.float32)
    ref = matmul_ref(cols.T, g, out_dtype=torch.float32)
    truth = cols.T.double() @ g.double()
    tol = (CONV_BAND * truth.abs().max() + 4 * math.sqrt(cols.size(0))
           * 2.0 ** -24 * (cols.T.double().abs() @ g.double().abs()))
    over = ((got.double() - truth).abs() / tol).max().item()
    plain = ((ref.double() - truth).abs() / tol).max().item()
    return over, plain, (got.double() - truth).abs().max().item()


def phase_parity(cfg):
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.brgemm.kernel import plan_call
    from repro_torch.kernels.flash_attention import (
        delta_rowsum_cuda, delta_rowsum_ref, flash_attention_bwd_cuda,
        flash_attention_bwd_ref, flash_attention_cuda, mha_ref)
    from repro_torch.kernels.flash_attention import bwd as FB
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"matmul": 0.0, "flash_attention": 0.0,
             "flash_attention_bwd": 0.0, "delta_rowsum": 0.0}
    failed = []

    def record(kernel, case, dtype, got, ref, tol):
        ok, abs_err, rel_err = close(got, ref, *tol)
        worst[kernel] = max(worst[kernel], abs_err)
        emit({"phase": "parity", "kernel": kernel, "case": case,
              "dtype": str(dtype).replace("torch.", ""),
              "max_abs_err": abs_err, "max_rel_err": rel_err,
              "atol": tol[0], "rtol": tol[1], "ok": ok})
        if not ok:
            failed.append(f"{kernel}:{case}:{dtype}")

    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[("matmul", dtype)]
        for g in main_path_gemms(cfg) + [
                g for g in train_gemms(cfg) if g.kind in ("dx", "dx_head",
                                                          "dw")]:
            if g.name.endswith(".up") or g.name.endswith(".o"):
                continue          # same (m, k, n) as q / gate
            x, w = gemm_inputs(g, dtype, gen)
            got = matmul_cuda(x, w, activation=g.activation,
                              out_dtype=g.out_dtype)
            ref = matmul_ref(x, w, activation=g.activation,
                             out_dtype=g.out_dtype)
            record("matmul", f"{g.name} m{g.m} k{g.k} n{g.n} "
                   f"{g.activation} x{'T' if x.stride(0) == 1 else ''}"
                   f"w{'T' if w.stride(0) == 1 else ''}", dtype, got, ref,
                   TOL[("matmul", torch.float32)] if g.out_dtype else tol)
            del x, w, got, ref
        x = torch.randn(300, 576, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(576, 576, device="cuda", generator=gen)
             / 24).to(dtype)
        bias = torch.randn(576, device="cuda", generator=gen).to(dtype)
        c0 = torch.randn(300, 576, device="cuda", generator=gen).to(dtype)
        record("matmul", "bias m300 k576 n576 gelu", dtype,
               matmul_cuda(x, w, bias, activation="gelu"),
               matmul_ref(x, w, bias, activation="gelu"), tol)
        record("matmul", "c0 beta=0.5 alpha=2 m300 k576 n576", dtype,
               matmul_cuda(x, w, c0=c0, alpha=2.0, beta=0.5),
               matmul_ref(x, w, c0=c0, alpha=2.0, beta=0.5), tol)
        xr = torch.randn(77, 100, device="cuda", generator=gen).to(dtype)
        wr = (torch.randn(100, 133, device="cuda", generator=gen)
              / 10).to(dtype)
        record("matmul", "ragged m77 k100 n133", dtype, matmul_cuda(xr, wr),
               matmul_ref(xr, wr), tol)
        for case, x, w, kw in plan_cases(dtype, gen):
            p = plan_call(x, w)
            if dtype == torch.bfloat16 and ("apart" in case) != (
                    p.mainloop == "wmma"):
                failed.append(f"matmul:{case}: planned {p.mainloop}")
            out_tol = (TOL[("matmul", torch.float32)]
                       if kw.get("out_dtype") else tol)
            record("matmul", f"{case} x{'T' if x.stride(0) == 1 else ''}"
                   f"w{'T' if w.stride(0) == 1 else ''} {p.mainloop} "
                   f"splits {p.splits}", dtype, matmul_cuda(x, w, **kw),
                   matmul_ref(x, w, **kw), out_tol)
        over, plain, err = stem_wgrad_errors(dtype, gen)
        worst["matmul"] = max(worst["matmul"], err)
        emit({"phase": "parity", "kernel": "matmul",
              "case": "stem wgrad (147, 401408) @ (401408, 64) vs float64",
              "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
              "over_band": over, "plain_over_band": plain, "ok": over <= 1})
        if not over <= 1:
            failed.append(f"matmul:stem wgrad:{dtype}")

        ftol = TOL[("flash_attention", dtype)]
        h, hkv_, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
        for case, (b, hq, hkv, t, tk, d), causal, window in (
                ("prefill", (BATCH, h, hkv_, PROMPT, None, dh), True, None),
                ("ragged T500", (BATCH, h, hkv_, 500, None, dh), True, None),
                ("d32", (2, 4, 2, 256, None, 32), True, None),
                ("d128 window 100", (2, 4, 1, 300, None, 128), True, 100),
                ("non-causal group 4", (2, 8, 2, 200, None, 64), False,
                 None),
                ("non-causal Tq < Tk d32", (2, 4, 2, 70, 150, 32), False,
                 None),
                ("window 33 Tq < Tk d128", (2, 2, 2, 200, 260, 128), False,
                 33),
                ("Tq 40 group 1", (2, 3, 3, 40, None, 64), True, None)):
            q, k, v, _ = qkv_views(b, hq, hkv, t, d, dtype, gen, tk)
            planned = FK.plan_call(q, k, v)
            if planned != ("wgmma" if dtype == torch.bfloat16 else "simt"):
                failed.append(f"flash_attention:{case}: planned {planned}")
            o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                          window=window,
                                          return_residuals=True)
            ro, rl = mha_ref(q, k, v, causal=causal, window=window,
                             return_lse=True)
            shape = (f"q{tuple(q.shape)} kv{tuple(k.shape)} "
                     f"{'causal' if causal else 'non-causal'} {planned}")
            record("flash_attention", f"{case} {shape}", dtype, o, ro, ftol)
            record("flash_attention", f"{case} lse", dtype, lse, rl,
                   TOL[("lse", None)])
            record("flash_attention", f"{case} without lse", dtype,
                   flash_attention_cuda(q, k, v, causal=causal,
                                        window=window), o, (0.0, 0.0))
        # Rows 8 elements apart: TMA cannot read them; bf16 runs the wmma
        # kernel.
        q, k, v = (overlapping_rows(2, hh, 96, 64, dtype, gen)
                   for hh in (4, 2, 2))
        planned = FK.plan_call(q, k, v)
        if planned != ("wmma" if dtype == torch.bfloat16 else "simt"):
            failed.append(f"flash_attention:overlapping rows: planned "
                          f"{planned}")
        o, lse = flash_attention_cuda(q, k, v, return_residuals=True)
        ro, rl = mha_ref(q, k, v, return_lse=True)
        record("flash_attention", f"overlapping rows q(2, 4, 96, 64) "
               f"{planned}", dtype, o, ro, ftol)
        record("flash_attention", "overlapping rows lse", dtype, lse, rl,
               TOL[("lse", None)])
        # Its backward: bf16 on the wmma kernel.
        dy = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        planned = FB.plan_call(q, k, v, o, dy)
        if planned != ("wmma" if dtype == torch.bfloat16 else "simt"):
            failed.append(f"flash_attention_bwd:overlapping rows: planned "
                          f"{planned}")
        want = flash_attention_bwd_ref(q, k, v, o, lse, dy)
        for name, got, ref in zip(("dq", "dk", "dv"),
                                  flash_attention_bwd_cuda(q, k, v, o, lse,
                                                           dy), want):
            scale = ref.float().abs().max().item()
            record("flash_attention_bwd", f"overlapping rows {name} "
                   f"{planned}", dtype, got, ref,
                   (GRAD_BAND[dtype] * scale, GRAD_BAND[dtype]))

        # A row with no valid key (non-causal, windowed, Tq > Tk: rows at
        # q_pos >= Tk + window - 1 = 89): the mean of V, lse NEG_INF.
        q = torch.randn(2, 4, 150, 64, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(2, 2, 70, 64, device="cuda", generator=gen
                            ).to(dtype) for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, causal=False, window=20,
                                      return_residuals=True)
        ro, rl = mha_ref(q, k, v, causal=False, window=20, return_lse=True)
        shape = "q(2, 4, 150, 64) kv(2, 2, 70, 64) non-causal window 20"
        record("flash_attention", f"no valid key (rows 89-149) {shape}",
               dtype, o, ro, ftol)
        record("flash_attention", "no valid key lse", dtype, lse, rl,
               TOL[("lse", None)])
        # Its backward: every key's dV takes those rows' dO / Tk, and dQ,
        # dK nothing from them, as autograd of mha_ref gives.
        dy = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        planned = FB.plan_call(q, k, v, o, dy)
        if planned != ("wgmma" if dtype == torch.bfloat16 else "simt"):
            failed.append(f"flash_attention_bwd:no valid key: planned "
                          f"{planned}")
        grads = flash_attention_bwd_cuda(q, k, v, o, lse, dy, causal=False,
                                         window=20)
        want = flash_attention_bwd_ref(q, k, v, o, lse, dy, causal=False,
                                       window=20)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
            scale = ref.float().abs().max().item()
            record("flash_attention_bwd", f"no valid key backward {name} "
                   f"{shape} {planned}", dtype, got, ref,
                   (GRAD_BAND[dtype] * scale, GRAD_BAND[dtype]))
        del q, k, v, o, lse, ro, rl, dy, grads, want

        # The backward: the forward's residuals from the kernel, as in
        # training; dY a view of the merged heads' gradient.
        band = GRAD_BAND[dtype]
        for case, (b, hq, hkv, t, d), window in (
                ("train", (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads,
                           TRAIN_SEQ, cfg.dh), None),
                ("ragged T500", (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads,
                                 500, cfg.dh), None),
                ("d32", (2, 4, 2, 256, 32), None),
                ("window 100", (2, 4, 2, 300, 64), 100),
                ("d128 window 100", (2, 4, 1, 300, 128), 100),
                ("context 2048", (1, cfg.n_heads, cfg.n_kv_heads, 2048,
                                  cfg.dh), None)):
            q, k, v, dy = qkv_views(b, hq, hkv, t, d, dtype, gen)
            o, lse = flash_attention_cuda(q, k, v, window=window,
                                          return_residuals=True)
            planned = FB.plan_call(q, k, v, o, dy)
            if planned != ("wgmma" if dtype == torch.bfloat16 else "simt"):
                failed.append(f"flash_attention_bwd:{case}: planned "
                              f"{planned}")
            *grads, delta = flash_attention_bwd_cuda(
                q, k, v, o, lse, dy, window=window, return_delta=True)
            want = flash_attention_bwd_ref(q, k, v, o, lse, dy,
                                           window=window)
            shape = f"q{tuple(q.shape)} kv{tuple(k.shape)} causal" + (
                f" window {window}" if window else "") + f" {planned}"
            again = flash_attention_bwd_cuda(q, k, v, o, lse, dy,
                                             window=window)
            for name, got, ref, got2 in zip(("dq", "dk", "dv"), grads, want,
                                            again):
                scale = ref.float().abs().max().item()
                record("flash_attention_bwd", f"{case} {name} {shape}",
                       dtype, got, ref, (band * scale, band))
                record("flash_attention_bwd", f"{case} {name} two calls",
                       dtype, got2, got, (0.0, 0.0))
            record("delta_rowsum", f"{case} fused vs standalone", dtype,
                   delta, delta_rowsum_cuda(o, dy), (0.0, 0.0))
            record("delta_rowsum", f"{case} standalone vs plain", dtype,
                   delta_rowsum_cuda(o, dy), delta_rowsum_ref(o, dy),
                   TOL[("delta", None)])
            del q, k, v, dy, o, lse, grads, want
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    return worst


@dataclasses.dataclass(frozen=True)
class Conv:
    """One convolution of ResNet-50 at batch RESNET_BATCH (NHWC, square)."""
    name: str
    c: int
    k: int
    h: int
    r: int
    stride: int
    padding: int
    count: int = 1          # convolutions of one forward with this shape

    @property
    def p(self):
        return (self.h + 2 * self.padding - self.r) // self.stride + 1

    @property
    def key(self):
        return (self.c, self.k, self.h, self.r, self.stride, self.padding)

    @property
    def flops(self):
        return 2 * RESNET_BATCH * self.p ** 2 * self.k * self.r ** 2 * self.c


def resnet_convs(cfg, hw=RESNET_HW):
    """Every convolution of one ResNet forward, in the model's order."""
    from repro_torch.models.resnet import block_stride
    w = cfg.width
    out = [Conv("stem", 3, w, hw, 7, 2, 3)]
    h = -(-((hw - 1) // 2 + 1) // 2)        # the stem, then the 3x3/2 pool
    cin = w
    for si, blocks in enumerate(cfg.stage_blocks):
        cmid = w * 2 ** si
        cout = 4 * cmid
        for bi in range(blocks):
            st, tag = block_stride(si, bi), f"stage{si + 1}.{bi}"
            ho = (h - 1) // st + 1
            out += [Conv(f"{tag}.conv1", cin, cmid, h, 1, 1, 0),
                    Conv(f"{tag}.conv2", cmid, cmid, h, 3, st, 1),
                    Conv(f"{tag}.conv3", cmid, cout, ho, 1, 1, 0)]
            if st != 1 or cin != cout:
                out.append(Conv(f"{tag}.proj", cin, cout, h, 1, st, 0))
            cin, h = cout, ho
    return out


def unique_convs(convs):
    """The distinct shapes, each with its first name and its count."""
    by_key = {}
    for cv in convs:
        first = by_key.get(cv.key)
        by_key[cv.key] = cv if first is None else dataclasses.replace(
            first, count=first.count + 1)
    return list(by_key.values())


def conv_inputs(cv, dtype, gen):
    """x (N, H, W, C) and w (R, S, C, K), values scaled so that outputs are
    O(1)."""
    x = torch.randn(RESNET_BATCH, cv.h, cv.h, cv.c, device="cuda",
                    generator=gen).to(dtype)
    w = (torch.randn(cv.r, cv.r, cv.c, cv.k, device="cuda", generator=gen)
         * (cv.c * cv.r ** 2) ** -0.5).to(dtype)
    return x, w


def dgrad_inputs(cv, w, dtype, gen):
    """The dual convolution's (input, weights, padding) for a random
    dL/dy of the conv's output shape, as the backward hands them over."""
    from repro_torch.kernels.conv2d import dual_operands
    g = torch.randn(RESNET_BATCH, cv.p, cv.p, cv.k, device="cuda",
                    generator=gen).to(dtype)
    return dual_operands(g, w, (cv.h, cv.h), cv.stride, cv.padding)


def band(ref):
    """fp32 output: CONV_BAND of the largest |output|; bf16: one ulp."""
    if ref.dtype == torch.float32:
        return CONV_BAND * ref.abs().max().item(), 0.0
    return TOL[("matmul", torch.bfloat16)]


def phase_parity_paper(cfg):
    """The convolution (forward and dgrad), the stacked brgemm and the
    batched GEMM against their plain versions."""
    from repro_torch.kernels.brgemm import (batched_matmul_cuda,
                                            batched_matmul_ref, brgemm_ref,
                                            brgemm_stacked_cuda)
    from repro_torch.kernels.brgemm.kernel import (plan_batched_call,
                                                   plan_stacked_call)
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"conv2d": 0.0, "brgemm_stacked": 0.0, "batched_matmul": 0.0}
    failed = []

    def record(kernel, case, dtype, got, ref):
        tol = band(ref)
        ok, abs_err, rel_err = close(got, ref, *tol)
        worst[kernel] = max(worst[kernel], abs_err)
        emit({"phase": "parity", "kernel": kernel, "case": case,
              "dtype": str(dtype).replace("torch.", ""),
              "max_abs_err": abs_err, "max_rel_err": rel_err,
              "atol": tol[0], "rtol": tol[1], "ok": ok})
        if not ok:
            failed.append(f"{kernel}:{case}:{dtype}")

    table = [Conv(f"L{i}", c, k, h, r, st, r // 2)
             for i, c, k, h, r, st in RESNET50_LAYERS]
    keys = {cv.key for cv in table}
    shapes = table + [cv for cv in unique_convs(resnet_convs(cfg))
                      if cv.key not in keys]
    for dtype in (torch.float32, torch.bfloat16):
        for cv in shapes:
            shape = (f"{cv.name} N{RESNET_BATCH} C{cv.c} K{cv.k} H{cv.h} "
                     f"{cv.r}x{cv.r}/{cv.stride} pad {cv.padding}")
            x, w = conv_inputs(cv, dtype, gen)
            kw = dict(stride=cv.stride, padding=cv.padding)
            record("conv2d", f"fwd {shape}", dtype, conv2d_cuda(x, w, **kw),
                   conv2d_ref(x, w, **kw))
            gd, wd, pd = dgrad_inputs(cv, w, dtype, gen)
            record("conv2d", f"dgrad {shape}", dtype,
                   conv2d_cuda(gd, wd, padding=pd, out_dtype=torch.float32),
                   conv2d_ref(gd, wd, padding=pd, out_dtype=torch.float32))
            del x, w, gd, wd
        # Fused bias and activation, ragged channels on every edge.
        cv = Conv("ragged", 12, 20, 9, 3, 2, 1)
        x, w = conv_inputs(cv, dtype, gen)
        bias = torch.randn(cv.k, device="cuda", generator=gen).to(dtype)
        kw = dict(stride=2, padding=1, activation="gelu")
        record("conv2d", "bias gelu N32 C12 K20 H9 3x3/2", dtype,
               conv2d_cuda(x, w, bias, **kw), conv2d_ref(x, w, bias, **kw))

        # stacked: at the paper's cases (split or not, by the plan) and
        # ragged in m, n and k (rows padded to 8 elements, k = 100: TMA's
        # zero fill ends each entry's k), on wgmma in bf16: plain, with
        # bias, C0 and gelu, and with both operands column-major; then rows
        # 36 apart, which TMA cannot read (wmma).
        for nb, m, k, n in BRGEMM_CASES + [(5, 70, 100, 130)]:
            scale = (nb * k) ** -0.5
            a = batched_entries(nb, m, k, False, dtype, gen)
            b = batched_entries(nb, k, n, False, dtype, gen, scale)
            at = batched_entries(nb, m, k, True, dtype, gen)
            bt = batched_entries(nb, k, n, True, dtype, gen, scale)
            bias = torch.randn(n, device="cuda", generator=gen).to(dtype)
            c0 = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
            kw = dict(activation="gelu", alpha=0.5, beta=0.75)
            for case, lhs, rhs, epi in (
                    ("A_i @ B_i", a, b, {}),
                    ("bias c0 gelu", a, b, dict(bias=bias, c0=c0, **kw)),
                    ("both column-major", at, bt, {})):
                p = plan_stacked_call(lhs, rhs)
                if p.mainloop != ("wgmma" if dtype == torch.bfloat16
                                  else "simt"):
                    failed.append(f"brgemm_stacked:{case}: planned "
                                  f"{p.mainloop}")
                record("brgemm_stacked", f"{case} B{nb} m{m} k{k} n{n} "
                       f"{p.mainloop} splits {p.splits}", dtype,
                       brgemm_stacked_cuda(lhs, rhs, **epi),
                       brgemm_ref(lhs, rhs, **epi))
            del a, b, at, bt
        a = torch.randn(3, 77, 36, device="cuda", generator=gen).to(dtype)
        b = (torch.randn(3, 36, 200, device="cuda", generator=gen)
             / 10).to(dtype)
        p = plan_stacked_call(a, b)
        if p.mainloop != ("wmma" if dtype == torch.bfloat16 else "simt"):
            failed.append(f"brgemm_stacked:rows 36 apart: planned "
                          f"{p.mainloop}")
        record("brgemm_stacked", f"B3 m77 k36 n200, rows 36 apart "
               f"{p.mainloop}", dtype, brgemm_stacked_cuda(a, b),
               brgemm_ref(a, b))
        del a, b
        # batched: no broadcast; then the backward's two products, g
        # broadcast and B^T / A^T read in place as transposed views; B
        # broadcast; both operands column-major.  At the paper's cases, and
        # ragged in m, n and k with rows padded to 8 elements (k = 100: TMA's
        # zero fill ends each entry's k), on wgmma in bf16; then rows 36
        # apart, which TMA cannot read (wmma).
        for nb, m, k, n in BRGEMM_CASES + [(5, 70, 100, 130)]:
            a = batched_entries(nb, m, k, False, dtype, gen)
            b = batched_entries(nb, k, n, False, dtype, gen, k ** -0.5)
            g = batched_entries(0, m, n, False, dtype, gen)
            for case, lhs, rhs in (
                    ("A_i @ B_i", a, b),
                    ("g @ B_i^T (A broadcast)", g, b.transpose(1, 2)),
                    ("A_i^T @ g (B broadcast)", a.transpose(1, 2), g),
                    ("A_i @ B_0 (B broadcast)", a, b[0]),
                    ("A_i @ B_i both column-major",
                     batched_entries(nb, m, k, True, dtype, gen),
                     batched_entries(nb, k, n, True, dtype, gen,
                                     k ** -0.5))):
                p = plan_batched_call(lhs, rhs)
                if p.mainloop != ("wgmma" if dtype == torch.bfloat16
                                  else "simt"):
                    failed.append(f"batched_matmul:{case}: planned "
                                  f"{p.mainloop}")
                record("batched_matmul", f"{case} B{nb} m{m} k{k} n{n} "
                       f"{p.mainloop}", dtype,
                       batched_matmul_cuda(lhs, rhs),
                       batched_matmul_ref(lhs, rhs))
            bias = torch.randn(n, device="cuda", generator=gen).to(dtype)
            for i, act in enumerate(("relu", "gelu", "silu", "tanh")):
                kw = dict(activation=act, alpha=2.0,
                          out_dtype=torch.float32 if i % 2 else None)
                record("batched_matmul", f"bias {act} alpha 2 out "
                       f"{kw['out_dtype'] or dtype} B{nb} m{m} k{k} n{n}",
                       dtype, batched_matmul_cuda(a, b, bias, **kw),
                       batched_matmul_ref(a, b, bias, **kw))
            del a, b, g
        a = torch.randn(3, 77, 36, device="cuda", generator=gen).to(dtype)
        b = (torch.randn(3, 36, 200, device="cuda", generator=gen)
             / 6).to(dtype)
        p = plan_batched_call(a, b)
        if p.mainloop != ("wmma" if dtype == torch.bfloat16 else "simt"):
            failed.append(f"batched_matmul:rows 36 apart: planned "
                          f"{p.mainloop}")
        record("batched_matmul", f"A_i @ B_i B3 m77 k36 n200, rows 36 "
               f"apart {p.mainloop}", dtype, batched_matmul_cuda(a, b),
               batched_matmul_ref(a, b))
        del a, b
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    return worst


def quantized(x, w, fmt):
    """(xq, sx, wq, sw): x quantized per row, w per output channel, as the
    quantized path hands them over (w keeps its layout)."""
    from repro_torch import quant
    name = str(fmt).replace("torch.", "")
    xq, sx = quant.quantize(x, name, axis=(-1,))
    wq, sw = quant.quantize(w, name, axis=(-2,))
    return xq, sx, wq, sw


def phase_parity_quant(cfg):
    """The three quantized GEMMs against their plain versions: matmul_q at
    the quantized serving path's shapes (prefill, decode, the head on the
    column-major table.T), brgemm_q and batched_matmul_q at the paper's
    cases (one with a 2-D broadcast operand), in int8, e4m3 and e5m2, with
    bf16 and fp32 out."""
    from repro_torch import quant
    from repro_torch.kernels.brgemm import (
        batched_matmul_q_cuda, batched_matmul_q_ref, brgemm_q_cuda,
        brgemm_q_ref, matmul_q_cuda, matmul_q_ref)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = {"matmul_q": 0.0, "brgemm_q": 0.0, "batched_matmul_q": 0.0}
    failed = []

    def record(kernel, case, fmt, out_dtype, got, ref, tol):
        ok, abs_err, rel_err = close(got, ref, *tol)
        worst[kernel] = max(worst[kernel], abs_err)
        emit({"phase": "parity", "kernel": kernel, "case": case,
              "dtype": str(fmt).replace("torch.", ""),
              "out_dtype": str(out_dtype).replace("torch.", ""),
              "max_abs_err": abs_err, "max_rel_err": rel_err,
              "atol": tol[0], "rtol": tol[1], "ok": ok})
        if not ok:
            failed.append(f"{kernel}:{case}:{fmt}:{out_dtype}")

    gemms = [g for g in main_path_gemms(cfg)
             if not g.name.endswith((".up", ".o"))]   # same shapes as q, gate
    for fmt in EIGHT_BIT:
        for out_dtype in (torch.float32, torch.bfloat16):
            for g in gemms:
                x, w = gemm_inputs(g, torch.float32, gen)
                xq, sx, wq, sw = quantized(x, w, fmt)
                kw = dict(activation=g.activation, out_dtype=out_dtype)
                record("matmul_q", f"{g.name} m{g.m} k{g.k} n{g.n} "
                       f"{g.activation} w{'T' if wq.stride(0) == 1 else ''}",
                       fmt, out_dtype, matmul_q_cuda(xq, wq, sx, sw, **kw),
                       matmul_q_ref(xq, wq, sx, sw, **kw),
                       quant_tol(fmt, out_dtype, g.activation))
                del x, w, xq, wq
            # the epilogue: bias, alpha, gelu; ragged m, k, n
            x = torch.randn(77, 100, device="cuda", generator=gen)
            w = torch.randn(100, 133, device="cuda", generator=gen) / 10
            bias = torch.randn(133, device="cuda", generator=gen)
            xq, sx, wq, sw = quantized(x, w, fmt)
            kw = dict(activation="gelu", alpha=0.5, out_dtype=out_dtype)
            record("matmul_q", "ragged m77 k100 n133 bias gelu alpha 0.5",
                   fmt, out_dtype, matmul_q_cuda(xq, wq, sx, sw, bias, **kw),
                   matmul_q_ref(xq, wq, sx, sw, bias, **kw),
                   quant_tol(fmt, out_dtype, "gelu"))
            name = str(fmt).replace("torch.", "")
            for nb, m, k, n in BRGEMM_CASES:
                a = torch.randn(nb, m, k, device="cuda", generator=gen)
                b = (torch.randn(nb, k, n, device="cuda", generator=gen)
                     * (nb * k) ** -0.5)
                # batch-shared scales, as brgemm(quant=) makes them
                aq, sa = quant.quantize(a, name, axis=(0, 2))
                bq, sb = quant.quantize(b, name, axis=(0, 1))
                case = f"B{nb} m{m} k{k} n{n}"
                kw = dict(out_dtype=out_dtype)
                record("brgemm_q", case, fmt, out_dtype,
                       brgemm_q_cuda(aq, bq, sa, sb, **kw),
                       brgemm_q_ref(aq, bq, sa, sb, **kw),
                       quant_tol(fmt, out_dtype))
                # per-entry scales; then A broadcast, as one 2-D operand
                aq, sa = quant.quantize(a, name, axis=(-1,))
                bq, sb = quant.quantize(b * nb ** 0.5, name, axis=(-2,))
                record("batched_matmul_q", case, fmt, out_dtype,
                       batched_matmul_q_cuda(aq, bq, sa, sb, **kw),
                       batched_matmul_q_ref(aq, bq, sa, sb, **kw),
                       quant_tol(fmt, out_dtype))
                record("batched_matmul_q", f"{case} A broadcast", fmt,
                       out_dtype,
                       batched_matmul_q_cuda(aq[0], bq, sa[0], sb, **kw),
                       batched_matmul_q_ref(aq[0], bq, sa[0], sb, **kw),
                       quant_tol(fmt, out_dtype))
                del a, b, aq, bq
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"quantized kernels disagree with their plain "
                             f"versions: {failed}")
    return worst


# --------------------------------------------------------------------------
# 4. full-width serving
# --------------------------------------------------------------------------

def make_engine(cfg, dtype):
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(cfg, dtype=str(dtype).replace("torch.", ""))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = api.init_params(cfg, gen, device="cuda")
    return cfg, params, Engine(cfg, params, ServeConfig(max_len=MAX_LEN))


def prompts(cfg):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return torch.randint(0, cfg.vocab, (BATCH, PROMPT), device="cuda",
                         generator=gen, dtype=torch.int32)


def prefill_logits(cfg, params, tokens, backend):
    from repro_torch.models import api
    with torch.inference_mode():
        cache = api.init_cache(cfg, BATCH, MAX_LEN, device="cuda")
        logits, _ = api.prefill(params, {"tokens": tokens}, cfg, cache,
                                backend=backend)
    return logits


def counted_mainloops(fn, name, dtype, n_launches):
    """``fn``'s calls by mainloop since its counters were zeroed: a main
    path's bf16 calls run on wgmma only, its fp32 calls on simt.  Returns
    the record's field; raises where another mainloop ran."""
    only = "wgmma" if dtype == torch.bfloat16 else "simt"
    counts = dict(fn.mainloops)
    if counts[only] != n_launches or sum(counts.values()) != n_launches:
        raise AssertionError(f"{dtype} {name} calls off the {only} "
                             f"mainloop: {counts} of {n_launches}")
    return {f"{name}_mainloops": counts}


def mainloop_check(dtype, n_launches):
    """matmul_cuda's calls by mainloop (counted_mainloops), and its split
    launches."""
    from repro_torch.kernels.brgemm import matmul_cuda
    return {**counted_mainloops(matmul_cuda, "matmul", dtype, n_launches),
            "matmul_split_launches": matmul_cuda.split_launches}


def flash_mainloop_check(dtype, n_launches, n_bwd=None):
    """The flash forward's calls by mainloop (counted_mainloops), and the
    backward's where ``n_bwd`` is given."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    out = counted_mainloops(flash_attention_cuda, "flash_attention", dtype,
                            n_launches)
    if n_bwd is not None:
        out.update(counted_mainloops(flash_attention_bwd_cuda,
                                     "flash_attention_bwd", dtype, n_bwd))
    return out


def phase_serve(base_cfg):
    from repro_torch.core import dispatch
    from repro_torch.kernels.brgemm import matmul_cuda
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_flash_counts)
    main_launches = None
    for dtype in (torch.bfloat16, torch.float32):
        cfg, params, engine = make_engine(base_cfg, dtype)
        tokens = prompts(cfg)
        engine.generate({"tokens": tokens[:, :16]}, n_tokens=2,
                        stop_tokens=())           # warm-up, not counted
        torch.cuda.synchronize()
        # The main path: counts zeroed just before, read just after.
        reset_matmul_counts()
        reset_flash_counts()
        t0 = time.perf_counter()
        ids = engine.generate({"tokens": tokens}, n_tokens=NEW_TOKENS,
                              stop_tokens=())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"matmul": matmul_cuda.launches,
                    "flash_attention": flash_attention_cuda.launches}
        per_forward = cfg.n_layers * 7 + 1
        expect = {"matmul": per_forward * NEW_TOKENS,
                  "flash_attention": cfg.n_layers}
        if launches != expect:
            raise AssertionError(f"launch counts {launches} != {expect}")
        by_mainloop = {**mainloop_check(dtype, launches["matmul"]),
                       **flash_mainloop_check(dtype,
                                              launches["flash_attention"])}
        with dispatch.use(backend="torch"):
            ids_plain = engine.generate({"tokens": tokens},
                                        n_tokens=NEW_TOKENS, stop_tokens=())
        torch.cuda.synchronize()
        if (matmul_cuda.launches, flash_attention_cuda.launches) != (
                expect["matmul"], expect["flash_attention"]):
            raise AssertionError("the plain run launched a kernel")
        lk = prefill_logits(cfg, params, tokens, None)
        lp = prefill_logits(cfg, params, tokens, "torch")
        err = (lk - lp).abs().max().item()
        finite = bool(torch.isfinite(lk).all())
        shape_ok = tuple(ids.shape) == (BATCH, NEW_TOKENS) and tuple(
            lk.shape) == (BATCH, cfg.vocab)
        match = (ids == ids_plain).float().mean().item()
        rec = {"phase": "serve", "dtype": cfg.dtype, "batch": BATCH,
               "prompt": PROMPT, "new_tokens": NEW_TOKENS,
               "launches": launches, "expected_launches": expect,
               **by_mainloop, "generate_s": seconds,
               "tokens_per_s": BATCH * NEW_TOKENS / seconds,
               "prefill_logits_max_abs_err": err,
               "band": LOGITS_BAND[dtype], "logits_finite": finite,
               "greedy_token_match": match}
        emit(rec)
        if not (finite and shape_ok and err <= LOGITS_BAND[dtype]):
            raise AssertionError(f"serve {cfg.dtype}: finite={finite} "
                                 f"shape_ok={shape_ok} logits err {err}")
        if dtype == torch.float32 and match != 1.0:
            raise AssertionError(f"fp32 greedy tokens differ from the plain "
                                 f"path (match {match})")
        if dtype == torch.bfloat16:      # the main path's dtype
            step_times(cfg, params, tokens)
            main_launches = launches
        del params, engine
        torch.cuda.empty_cache()
    return main_launches


def step_times(cfg, params, tokens, tier="full", prefill_quant=None,
               decode_quant=None):
    """Host-clock prefill and decode-step times of the kernel path, under a
    serving tier's quant configs (None: full precision)."""
    from repro_torch.core import dispatch
    from repro_torch.models import api

    def prefill(cache):
        with dispatch.use(quant=prefill_quant):
            return api.prefill(params, {"tokens": tokens}, cfg, cache)

    def decode(tok, cache, pos):
        with dispatch.use(quant=decode_quant):
            return api.decode_step(params, tok, cfg, cache, pos)

    with torch.inference_mode():
        cache = api.init_cache(cfg, BATCH, MAX_LEN, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        n = 16
        t0 = time.perf_counter()
        for i in range(n):
            logits, cache = decode(tok, cache, PROMPT + i)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_s = (time.perf_counter() - t0) / n
        # Device busy time of a few decode steps: the kernels' own
        # durations under the profiler, against the unprofiled step time.
        prof_steps = 4

        def steps():
            nonlocal logits, cache, tok
            for i in range(prof_steps):
                logits, cache = decode(tok, cache, PROMPT + n + i)
                tok = logits.argmax(-1).to(torch.int32)[:, None]

        by_name = device_ms_by_kernel(steps, prof_steps)
        # Where the host's time goes in the same steps.
        host_ms, host_fns = host_split(steps, prof_steps)
        prefill_busy_ms = sum(device_ms_by_kernel(
            lambda: prefill(cache), 1).values())
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    rec = {"phase": "serve_steps", "tier": tier,
           "prefill_ms": prefill_s * 1e3,
           "prefill_device_busy_ms": prefill_busy_ms,
           "prefill_device_idle_share": 1 - prefill_busy_ms / (prefill_s
                                                                * 1e3),
           "decode_step_ms": decode_s * 1e3,
           "decode_tokens_per_s": BATCH / decode_s,
           "decode_device_busy_ms": busy_ms,
           "decode_device_idle_share": 1 - busy_ms / (decode_s * 1e3),
           "decode_device_ms_by_kernel": {k[:80]: v for k, v in top},
           "decode_host_cprofile_step_ms": host_ms,
           "decode_host_cprofile_cumulative_ms": host_fns}
    emit(rec)
    return rec


# --------------------------------------------------------------------------
# 5. full-width training
# --------------------------------------------------------------------------

def expected_step_launches(cfg):
    """Launches of one train step, from the code: each of the 7 GEMMs of a
    layer and the head launches once forward and twice backward (dX, dW);
    the gate's silu needs its pre-activation, recomputed by the kernel in
    the backward; one flash forward and one flash backward call per
    layer."""
    from repro_torch.core import fusion
    gemms = 7 * cfg.n_layers + 1
    recompute = cfg.n_layers * fusion.needs_preact(cfg.mlp_activation)
    return {"matmul": 3 * gemms + recompute,
            "flash_attention": cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}


def clone_state(state):
    return {"opt": {"step": state["opt"]["step"],
                    **{k: {n: t.clone() for n, t in state["opt"][k].items()}
                       for k in ("m", "v", "master")}}}


def step0_grad_errors(cfg, state, batch):
    """Every parameter's step-0 gradient, kernels against plain, as
    relative L2 error; the working params cast from the master as the step
    does."""
    from repro_torch.core import dispatch
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    model = Transformer(cfg, device="cuda")
    opt.cast_params(state["opt"], dict(model.named_parameters()))
    _, gk = ts.loss_and_grads(model, batch, cfg)   # fresh tensors each call
    with dispatch.use(backend="torch"):
        _, gp = ts.loss_and_grads(model, batch, cfg)
    errs, finite = {}, True
    for n in gk:
        a, b = gk[n].float(), gp[n].float()
        finite &= bool(torch.isfinite(a).all())
        errs[n] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    return errs, finite


def phase_train(base_cfg):
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.core import dispatch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.brgemm import matmul_cuda
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda,
        reset_flash_bwd_counts, reset_flash_counts)
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    counters = {"matmul": matmul_cuda, "flash_attention": flash_attention_cuda,
                "flash_attention_bwd": flash_attention_bwd_cuda}
    main_launches = None
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(base_cfg,
                                  dtype=str(dtype).replace("torch.", ""))
        ocfg = opt.AdamWCfg()
        pipe = TokenPipeline(cfg, ShapeCfg("smoke", "train", TRAIN_SEQ,
                                           TRAIN_BATCH), seed=SEED)
        batches = [next(pipe) for _ in range(TRAIN_STEPS)]
        pipe.close()
        state = ts.init_state(cfg, ocfg, torch.Generator(
            device="cuda").manual_seed(SEED), "cuda")
        plain_state = clone_state(state)
        grad_err, grads_finite = step0_grad_errors(cfg, state, batches[0])
        torch.cuda.empty_cache()

        # The main path: counts zeroed just before, read just after.
        step = ts.make_train_step(cfg, ocfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        reset_matmul_counts()
        reset_flash_counts()
        reset_flash_bwd_counts()
        losses, step_s = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        launches = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        per_step = expected_step_launches(cfg)
        expect = {k: v * TRAIN_STEPS for k, v in per_step.items()}
        if launches != expect:
            raise AssertionError(f"train launch counts {launches} != "
                                 f"{expect}")
        by_mainloop = {**mainloop_check(dtype, launches["matmul"]),
                       **flash_mainloop_check(
                           dtype, launches["flash_attention"],
                           launches["flash_attention_bwd"])}

        plain_step = ts.make_train_step(cfg, ocfg)
        torch.cuda.reset_peak_memory_stats()
        plain_losses, plain_s = [], []
        with dispatch.use(backend="torch"):
            for batch in batches:
                t0 = time.perf_counter()
                plain_state, metrics = plain_step(plain_state, batch)
                torch.cuda.synchronize()
                plain_s.append(time.perf_counter() - t0)
                plain_losses.append(float(metrics["loss"]))
        plain_peak = torch.cuda.max_memory_allocated()
        if {k: c.launches for k, c in counters.items()} != expect:
            raise AssertionError("the plain train run launched a kernel")

        band = TRAIN_BAND[dtype]
        loss0_err = abs(losses[0] - plain_losses[0])
        traj_err = max(abs(a - b) for a, b in zip(losses, plain_losses))
        worst_grad = max(grad_err.items(), key=lambda kv: kv[1])
        steady_s = sorted(step_s[1:])[len(step_s[1:]) // 2]   # median
        rec = {"phase": "train", "dtype": cfg.dtype, "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
               "launches": launches, "expected_launches": expect,
               **by_mainloop,
               "expected_per_step": per_step,
               "losses": losses, "plain_losses": plain_losses,
               "step0_loss_err": loss0_err, "trajectory_max_err": traj_err,
               "loss_band": band["loss"],
               "grad_rel_l2_max": worst_grad[1],
               "grad_rel_l2_worst_param": worst_grad[0],
               "grad_rel_l2_median": sorted(grad_err.values())[
                   len(grad_err) // 2],
               "grad_rel_l2_table": grad_err["embed.table"],
               "grad_band": band["grad_rel_l2"],
               "step_ms": [x * 1e3 for x in step_s],
               "plain_step_ms": [x * 1e3 for x in plain_s],
               "steady_step_ms": steady_s * 1e3,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady_s,
               "peak_mem_gb": peak / 1e9,
               "plain_peak_mem_gb": plain_peak / 1e9}
        ok = (grads_finite and all(math.isfinite(x) for x in losses)
              and loss0_err <= band["loss"] and traj_err <= band["loss"]
              and worst_grad[1] <= band["grad_rel_l2"])
        if dtype == torch.bfloat16:      # the main path's dtype
            # One more step each under the profiler and under cProfile.
            by_name = device_ms_by_kernel(lambda: step(state, batches[0]), 1)
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
            host_ms, host_fns = host_split(lambda: step(state, batches[1]),
                                           1, top=24)
            rec.update({"device_busy_ms": busy,
                        "device_idle_share": 1 - busy / (steady_s * 1e3),
                        "device_ms_by_kernel": {k[:80]: v for k, v in top},
                        "host_cprofile_step_ms": host_ms,
                        "host_cprofile_cumulative_ms": host_fns})
            main_launches = launches
        emit(rec)
        if not ok:
            raise AssertionError(
                f"train {cfg.dtype}: loss err {loss0_err} / {traj_err}, "
                f"worst gradient {worst_grad}, finite {grads_finite}")
        del state, plain_state, step, plain_step
        torch.cuda.empty_cache()
    return main_launches


# --------------------------------------------------------------------------
# 6. full-width ResNet-50
# --------------------------------------------------------------------------

def rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def median(xs):
    return sorted(xs)[len(xs) // 2]


def expected_resnet_launches(cfg):
    """Launches of one forward and of one gradient step, from the code:
    each convolution launches the conv kernel once forward and, but for
    the stem (its image takes no gradient), once for its dgrad dual; its
    weight gradient is one GEMM; the head is one GEMM forward and two
    backward."""
    convs = len(resnet_convs(cfg))
    return ({"conv2d": convs, "matmul": 1},
            {"conv2d": 2 * convs - 1, "matmul": 1 + 2 + convs})


@contextlib.contextmanager
def checked_launches(worst):
    """Inside, every conv2d and matmul kernel launch is also run through
    its plain version on the same inputs; ``worst`` collects, by kernel,
    the largest error over its band and which launch it was.  These are the
    launches of the path itself, with the activations, gradients, dilated
    duals and transposed operands the path hands over.

    A bf16 output is held to one bf16 ulp of the plain version (``band``).
    An fp32 output sums up to 401,408 products (the stem's weight
    gradient), often to a value far smaller than its terms (normalisation
    makes gradients cancel), so it is held against the float64 value with
    the fp32 summation error a correct kernel may make,
    CONV_BAND * max |y| + 4 sqrt(k) 2^-24 (|A| |B|), elementwise (the
    probabilistic bound of fp32 dot products of length k); the plain
    version's own error in those units is reported beside it."""
    import torch.nn.functional as F
    from repro_torch.core import fusion
    from repro_torch.kernels.brgemm import kernel as BK
    from repro_torch.kernels.brgemm import ref as BR
    from repro_torch.kernels.conv2d import kernel as CK
    from repro_torch.kernels.conv2d import ref as CR
    real_conv, real_mm = CK.conv2d_cuda, BK.matmul_cuda

    def note(kernel, what, got, ref, exact, k):
        if got.dtype == torch.float32:
            truth, scale = exact()
            tol = (CONV_BAND * truth.abs().max()
                   + 4 * math.sqrt(k) * 2.0 ** -24 * scale).clamp_min(1e-300)
            excess = ((got.double() - truth).abs() / tol).max().item()
            plain = ((ref.double() - truth).abs() / tol).max().item()
        else:
            atol, rtol = band(ref)
            excess = ((got.float() - ref.float()).abs() / (
                atol + rtol * ref.float().abs()).clamp_min(1e-30)
                      ).max().item()
            plain = None
        if excess >= worst.get(kernel, {}).get("over_band", -1.0):
            worst[kernel] = {"over_band": excess, "launch": what,
                             "plain_over_band": plain}

    def conv(x, w, bias=None, *, stride=1, padding=0, activation="none",
             out_dtype=None):
        kw = dict(stride=stride, padding=padding)
        y = real_conv(x, w, bias, activation=activation, out_dtype=out_dtype,
                      **kw)

        def exact():
            def f(a, b):
                return F.conv2d(a.double().permute(0, 3, 1, 2),
                                b.double().permute(3, 2, 0, 1),
                                **kw).permute(0, 2, 3, 1)
            y64 = f(x, w) + (bias.double() if bias is not None else 0.0)
            return fusion.apply(activation, y64), f(x.abs(), w.abs())

        note("conv2d", f"{tuple(x.shape)} * {tuple(w.shape)} /{stride} "
             f"pad {padding} -> {y.dtype}", y,
             CR.conv2d_ref(x, w, bias, activation=activation,
                           out_dtype=out_dtype, **kw), exact,
             w.shape[0] * w.shape[1] * w.shape[2])
        return y

    def mm(x, w, bias=None, c0=None, *, activation="none", alpha=1.0,
           beta=0.0, out_dtype=None):
        kw = dict(activation=activation, alpha=alpha, beta=beta,
                  out_dtype=out_dtype)
        y = real_mm(x, w, bias, c0, **kw)

        def exact():
            y64 = (x.double() @ w.double()) * alpha
            if c0 is not None and beta != 0.0:
                y64 = y64 + beta * c0.double()
            if bias is not None:
                y64 = y64 + bias.double()
            return (fusion.apply(activation, y64),
                    (x.double().abs() @ w.double().abs()) * abs(alpha))

        note("matmul", f"{tuple(x.shape)} @ {tuple(w.shape)} -> {y.dtype}",
             y, BR.matmul_ref(x, w, bias, c0=c0, **kw), exact, x.shape[1])
        return y

    # The wrappers count into the name they are bound to: these launches
    # are comparisons and leave the path's counters alone.
    conv.launches = 0
    BK.reset_matmul_counts(mm)
    CK.conv2d_cuda, BK.matmul_cuda = conv, mm
    try:
        yield worst
    finally:
        CK.conv2d_cuda, BK.matmul_cuda = real_conv, real_mm


def resnet_errors(got, want):
    """Relative L2 error of the logits, relative error of the loss, and the
    largest and median relative L2 error of a parameter's gradient."""
    from repro_torch.models.resnet import named_leaves
    grads = {n: rel_l2(g, w) for (n, g), (_, w) in zip(
        named_leaves(got["grads"]), named_leaves(want["grads"]))}
    worst = max(grads.items(), key=lambda kv: kv[1])
    return {"logits": rel_l2(got["logits"], want["logits"]),
            "loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_max": worst[1], "grad_worst_param": worst[0],
            "grad_median": median(list(grads.values()))}


def phase_resnet():
    """Full-width ResNet-50, kernels against the plain path.

    ResNet-50 at its random initialisation, normalised with its batch's
    statistics, is chaotic: perturbing the images by one part in 10^6 moves
    the plain fp32 path's gradients by ~3 % and its logits by ~4e-5 on an
    H100 (PERF.md).  So the kernels are held in three
    ways.  Every conv2d and matmul launch of one forward and gradient step
    is compared with its plain version on the same inputs, at the parity
    bands.  In fp32, the logits and the loss must agree with the plain
    path within RESNET_BAND, and each gradient within RESNET_BAND or twice
    the plain path's own change under that 1e-6 perturbation, whichever is
    larger.  In bf16, where the two paths round to bf16 at other places,
    each is measured against the fp32 plain path on the same bf16-valued
    weights and images, and the kernels must be within RESNET_BAND of it,
    or no more than 1.25 times as far from it as the plain bf16 path is.
    """
    from repro_torch.kernels.brgemm import matmul_cuda
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.models import resnet
    cfg = resnet.ResNetCfg()
    counters = {"conv2d": conv2d_cuda, "matmul": matmul_cuda}
    per_fwd, per_step = expected_resnet_launches(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    params32 = resnet.init_params(cfg, gen)
    images = torch.randn(RESNET_BATCH, RESNET_HW, RESNET_HW, 3,
                         device="cuda", generator=gen)
    labels = torch.randint(0, cfg.n_classes, (RESNET_BATCH,), device="cuda",
                           generator=gen)

    def launches():
        return {k: c.launches for k, c in counters.items()}

    def run(params, x, backend=None):
        with torch.no_grad():
            logits = resnet.forward(params, x, cfg, backend=backend)
        loss, grads = resnet.loss_and_grads(params, x, labels, cfg,
                                            backend=backend)
        return {"logits": logits, "loss": loss.item(), "grads": grads}

    main_launches = None
    for dtype in (torch.bfloat16, torch.float32):
        params = resnet.map_params(lambda t: t.to(dtype), params32)
        x = images.to(dtype)

        def fwd(backend=None):
            with torch.no_grad():
                return resnet.forward(params, x, cfg, backend=backend)

        def step(backend=None):
            return resnet.loss_and_grads(params, x, labels, cfg,
                                         backend=backend)

        fwd()
        step()                          # warm-up, not counted
        torch.cuda.synchronize()
        # The main path: counts zeroed just before, read just after.
        for c in counters.values():
            c.launches = 0
        reset_matmul_counts()
        logits = fwd()
        torch.cuda.synchronize()
        fwd_launches = launches()
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        loss, grads = step()
        torch.cuda.synchronize()
        step_launches = launches()
        by_mainloop = mainloop_check(
            dtype, fwd_launches["matmul"] + step_launches["matmul"])
        peak = torch.cuda.max_memory_allocated()
        if fwd_launches != per_fwd or step_launches != per_step:
            raise AssertionError(f"resnet launch counts {fwd_launches} / "
                                 f"{step_launches} != {per_fwd} / "
                                 f"{per_step}")
        kern = {"logits": logits, "loss": loss.item(), "grads": grads}
        torch.cuda.reset_peak_memory_stats()
        plain = run(params, x, "torch")
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated()
        if launches() != step_launches:
            raise AssertionError("the plain resnet run launched a kernel")

        band = RESNET_BAND[dtype]
        if dtype == torch.float32:
            noise = torch.randn(x.shape, device="cuda", generator=gen)
            floor = resnet_errors(run(params, x * (1 + 1e-6 * noise),
                                      "torch"), plain)
            err = resnet_errors(kern, plain)
            limit = {"logits": band, "loss": band,
                     "grad_max": max(band, 2 * floor["grad_max"])}
            ref_name = "the plain fp32 path"
        else:
            ref = run(resnet.map_params(lambda t: t.float(), params),
                      x.float(), "torch")
            floor = resnet_errors(plain, ref)
            err = resnet_errors(kern, ref)
            limit = {q: max(band, 1.25 * floor[q])
                     for q in ("logits", "loss", "grad_max")}
            ref_name = "the plain fp32 path on the bf16 values"
            del ref
        with checked_launches({}) as per_launch:
            run(params, x)
        torch.cuda.synchronize()

        fwd_s, step_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        finite = bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(g).all()) for _, g in
            resnet.named_leaves(grads))
        rec = {"phase": "resnet", "dtype": str(dtype).replace("torch.", ""),
               "batch": RESNET_BATCH, "image": RESNET_HW,
               "launches_forward": fwd_launches,
               "launches_step": step_launches, **by_mainloop,
               "logits_shape": list(logits.shape), "finite": finite,
               "loss": kern["loss"], "plain_loss": plain["loss"],
               "kernel_vs_plain": resnet_errors(kern, plain),
               "held_against": ref_name, "error": err,
               "plain_floor": floor, "limit": limit,
               "per_launch_worst_over_band": per_launch,
               "forward_ms": [t * 1e3 for t in fwd_s],
               "images_per_s": RESNET_BATCH / median(fwd_s),
               "step_ms": [t * 1e3 for t in step_s],
               "step_images_per_s": RESNET_BATCH / median(step_s),
               "peak_mem_gb": peak / 1e9,
               "plain_peak_mem_gb": plain_peak / 1e9}
        if dtype == torch.bfloat16:       # the main path's dtype
            for name, fn, wall in (("forward", fwd, median(fwd_s)),
                                   ("step", step, median(step_s))):
                by_name = device_ms_by_kernel(fn, 1)
                busy = sum(by_name.values())
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
                rec.update({f"{name}_device_busy_ms": busy,
                            f"{name}_device_idle_share": 1 - busy / (
                                wall * 1e3),
                            f"{name}_device_ms_by_kernel": {
                                k[:80]: v for k, v in top}})
            main_launches = {k: fwd_launches[k] + step_launches[k]
                             for k in counters}
        emit(rec)
        ok = (finite and tuple(logits.shape) == (RESNET_BATCH, cfg.n_classes)
              and all(err[q] <= limit[q] for q in limit)
              and set(per_launch) == set(counters)
              and all(v["over_band"] <= 1.0 for v in per_launch.values()))
        if not ok:
            raise AssertionError(f"resnet {dtype}: errors {err} against "
                                 f"{ref_name}, limits {limit}, per-launch "
                                 f"{per_launch}, finite {finite}")
        del params, grads, kern, plain
        torch.cuda.empty_cache()
    return main_launches


# --------------------------------------------------------------------------
# 7. the paper's brgemm and batched_matmul entry points
# --------------------------------------------------------------------------

def phase_brgemm():
    from repro_torch.core.brgemm import batched_matmul, brgemm
    from repro_torch.kernels.brgemm import (batched_matmul_cuda,
                                            brgemm_stacked_cuda)
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    counters = {"brgemm_stacked": brgemm_stacked_cuda,
                "batched_matmul": batched_matmul_cuda}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    main_launches = None
    for dtype in (torch.bfloat16, torch.float32):
        cases = []
        for nb, m, k, n in BRGEMM_CASES:
            a = torch.randn(nb, m, k, device="cuda", generator=gen).to(dtype)
            b = (torch.randn(nb, k, n, device="cuda", generator=gen)
                 * (nb * k) ** -0.5).to(dtype)
            dy = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
            cases.append((a, b, dy))

        def run(backend):
            outs = []
            for a, b, dy in cases:
                leaves = [a.detach().clone().requires_grad_(),
                          b.detach().clone().requires_grad_()]
                y = brgemm(*leaves, backend=backend)
                outs.append((y.detach(), *torch.autograd.grad(y, leaves, dy),
                             batched_matmul(a, b, backend=backend)))
            torch.cuda.synchronize()
            return outs

        # The main path: counts zeroed just before, read just after.
        for c in counters.values():
            c.launches = 0
        reset_matmul_counts()
        got = run(None)
        launches = {k: c.launches for k, c in counters.items()}
        expect = {"brgemm_stacked": len(cases),
                  "batched_matmul": 3 * len(cases)}
        if launches != expect:
            raise AssertionError(f"brgemm launch counts {launches} != "
                                 f"{expect}")
        by_mainloop = {
            **counted_mainloops(batched_matmul_cuda, "batched_matmul", dtype,
                                launches["batched_matmul"]),
            **counted_mainloops(brgemm_stacked_cuda, "brgemm_stacked", dtype,
                                launches["brgemm_stacked"]),
            "brgemm_stacked_split_launches":
                brgemm_stacked_cuda.split_launches}
        want = run("torch")
        if {k: c.launches for k, c in counters.items()} != expect:
            raise AssertionError("the plain brgemm run launched a kernel")
        errs = {}
        for (nb, m, k, n), g, w in zip(BRGEMM_CASES, got, want):
            for name, a, b in zip(("y", "da", "db", "batched"), g, w):
                scale = b.float().abs().max().item()
                errs[f"B{nb} m{m} k{k} n{n} {name}"] = (
                    (a.float() - b.float()).abs().max().item() / scale)
        worst = max(errs.items(), key=lambda kv: kv[1])
        emit({"phase": "brgemm", "dtype": str(dtype).replace("torch.", ""),
              "cases": BRGEMM_CASES, "launches": launches,
              "expected_launches": expect, **by_mainloop,
              "max_err_of_largest": worst[1], "worst": worst[0],
              "band": GRAD_BAND[dtype]})
        if worst[1] > GRAD_BAND[dtype]:
            raise AssertionError(f"brgemm {dtype}: {worst}")
        if dtype == torch.bfloat16:       # the main path's dtype
            main_launches = launches
        del cases, got, want
    return main_launches


# --------------------------------------------------------------------------
# 8. quantized serving, and the quantized brgemm / batched_matmul
# --------------------------------------------------------------------------

def expected_quant_launches(cfg, calibrated):
    """Launches of one NEW_TOKENS-token ``Engine.generate``, from the code:
    decode_quant="int8" runs prefill (one forward) at full precision and
    each decode forward quantized, its head quantizing table.T dynamically;
    a calibrated model runs every forward quantized but the head, whose
    table is not a calibrated weight."""
    per_forward = cfg.n_layers * 7 + 1
    if calibrated:
        return {"matmul": NEW_TOKENS,
                "matmul_q": (per_forward - 1) * NEW_TOKENS,
                "flash_attention": cfg.n_layers}
    return {"matmul": per_forward, "matmul_q": per_forward * (NEW_TOKENS - 1),
            "flash_attention": cfg.n_layers}


@contextlib.contextmanager
def attention_on(backend):
    """Inside, the prefill attention runs on ``backend`` ("torch": mha_ref,
    "cuda": the flash kernel) whatever the rest of the path runs on: the
    op's registry entries swapped, and restored on exit."""
    from repro_torch.core import dispatch
    table = dispatch._REGISTRY["flash_attention"]
    saved = dict(table)
    table["torch"] = table["cuda"] = saved[backend]
    try:
        yield
    finally:
        table.update(saved)


def tier_reference(cfg, calibration):
    """The plain path's model in fp32 on a bf16 tier's own weight values
    (the same seed's draws rounded through bf16), calibrated alike: the
    same int8 / fp8 weights, fp32 activations."""
    from repro_torch import quant
    from repro_torch.models import api
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ref = api.init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    if calibration is not None:
        ref = quant.calibrate_params(ref, calibration)
    return cfg32, ref


def phase_quant(base_cfg):
    from repro_torch import quant
    from repro_torch.core import dispatch
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_q_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_flash_counts)
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    counters = {"matmul": matmul_cuda, "matmul_q": matmul_q_cuda,
                "flash_attention": flash_attention_cuda}
    main_launches = dict.fromkeys(counters, 0)
    failed = []
    runs = [(torch.bfloat16, t) for t in QUANT_TIERS] + [
        (torch.float32, QUANT_TIERS[1])]
    for dtype, (tier, kw, calibration) in runs:
        cfg = dataclasses.replace(base_cfg,
                                  dtype=str(dtype).replace("torch.", ""))
        params = api.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda")
        if calibration is not None:
            params = quant.calibrate_params(params, calibration)
        engine = Engine(cfg, params, ServeConfig(max_len=MAX_LEN), **kw)
        tokens = prompts(cfg)
        engine.generate({"tokens": tokens[:, :16]}, n_tokens=2,
                        stop_tokens=())           # warm-up, not counted
        torch.cuda.synchronize()
        # The main path: counts zeroed just before, read just after.
        for c in counters.values():
            c.launches = 0
        reset_flash_counts()
        t0 = time.perf_counter()
        ids = engine.generate({"tokens": tokens}, n_tokens=NEW_TOKENS,
                              stop_tokens=())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        expect = expected_quant_launches(cfg, calibration is not None)
        if launches != expect:
            raise AssertionError(f"quant {tier} launch counts {launches} != "
                                 f"{expect}")
        by_mainloop = flash_mainloop_check(dtype,
                                           launches["flash_attention"])
        with dispatch.use(backend="torch"):
            ids_plain = engine.generate({"tokens": tokens},
                                        n_tokens=NEW_TOKENS, stop_tokens=())
        torch.cuda.synchronize()
        if {k: c.launches for k, c in counters.items()} != expect:
            raise AssertionError("the plain quant run launched a kernel")
        with dispatch.use(quant=engine.quant):    # the tier's prefill
            lk = prefill_logits(cfg, params, tokens, None)
            lp = prefill_logits(cfg, params, tokens, "torch")
        err = (lk - lp).abs().max().item()
        band = QUANT_LOGITS_BAND[dtype]
        match = (ids == ids_plain).float().mean().item()
        if dtype == torch.bfloat16:
            cfg32, ref = tier_reference(cfg, calibration)
            with dispatch.use(quant=engine.quant):
                lr = prefill_logits(cfg32, ref, tokens, "torch")
            del ref
            rec = {"vs_fp32_plain": (lk - lr).abs().max().item(),
                   "plain_vs_fp32_plain": (lp - lr).abs().max().item()}
            held = {"logits vs fp32 plain": (
                rec["vs_fp32_plain"],
                max(band, 1.25 * rec["plain_vs_fp32_plain"]))}
        else:
            with attention_on("torch"):          # kernel GEMMs, mha_ref
                ids_pa = engine.generate({"tokens": tokens},
                                         n_tokens=NEW_TOKENS, stop_tokens=())
                with dispatch.use(quant=engine.quant):
                    lk_pa = prefill_logits(cfg, params, tokens, None)
            with attention_on("cuda"), dispatch.use(quant=engine.quant):
                lp_ka = prefill_logits(cfg, params, tokens, "torch")
            match_pa = (ids_pa == ids_plain).float().mean().item()
            rec = {"plain_attention_logits_err":
                   (lk_pa - lp).abs().max().item(),
                   "plain_attention_token_match": match_pa,
                   "floor_rel_l2": rel_l2(lp_ka, lp)}
            held = {"plain attention logits": (
                        rec["plain_attention_logits_err"], band),
                    "plain attention token mismatch": (1.0 - match_pa, 0.0),
                    "logits rel l2 vs 2x floor": (
                        rel_l2(lk, lp), 2 * rec["floor_rel_l2"])}
        finite = bool(torch.isfinite(lk).all())
        shape_ok = tuple(ids.shape) == (BATCH, NEW_TOKENS) and tuple(
            lk.shape) == (BATCH, cfg.vocab)
        emit({"phase": "quant", "tier": tier, "dtype": cfg.dtype,
              "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
              "launches": launches, "expected_launches": expect,
              **by_mainloop,
              "generate_s": seconds,
              "tokens_per_s": BATCH * NEW_TOKENS / seconds,
              "prefill_logits_max_abs_err": err,
              "prefill_logits_rel_l2": rel_l2(lk, lp), **rec,
              "held": held, "logits_finite": finite,
              "greedy_token_match": match})
        bad = [k for k, (got, limit) in held.items() if not got <= limit]
        if not (finite and shape_ok) or bad:
            failed.append(f"{tier} {cfg.dtype}: finite={finite} shape_ok="
                          f"{shape_ok} over their limits: {bad}")
        if dtype == torch.bfloat16:      # the main path's dtype
            step_times(cfg, params, tokens, tier, engine.quant,
                       engine.decode_quant)
            for k in counters:
                main_launches[k] += launches[k]
        del params, engine
        torch.cuda.empty_cache()
    main_launches.update(quant_entry_points())
    if failed:
        raise AssertionError(f"quantized serving: {failed}")
    return main_launches


def quant_entry_points():
    """``brgemm(quant="int8")`` and ``batched_matmul(quant="int8")`` at the
    paper's cases, bf16 in and out: one launch a call, and, on the same
    operands (quantized alike on both paths), exactly the plain path's
    result (quant_tol)."""
    from repro_torch.core import dispatch
    from repro_torch.core.brgemm import batched_matmul, brgemm
    from repro_torch.kernels.brgemm import (batched_matmul_q_cuda,
                                            brgemm_q_cuda)
    counters = {"brgemm_q": brgemm_q_cuda,
                "batched_matmul_q": batched_matmul_q_cuda}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    cases = []
    for nb, m, k, n in BRGEMM_CASES:
        a = torch.randn(nb, m, k, device="cuda", generator=gen)
        b = torch.randn(nb, k, n, device="cuda", generator=gen) * k ** -0.5
        cases.append((a.to(torch.bfloat16), b.to(torch.bfloat16)))

    def run():
        with torch.no_grad():
            out = [(brgemm(a, b, quant="int8"),
                    batched_matmul(a, b, quant="int8")) for a, b in cases]
        torch.cuda.synchronize()
        return out

    # The main path: counts zeroed just before, read just after.
    for c in counters.values():
        c.launches = 0
    got = run()
    launches = {k: c.launches for k, c in counters.items()}
    expect = dict.fromkeys(counters, len(cases))
    if launches != expect:
        raise AssertionError(f"quant brgemm launch counts {launches} != "
                             f"{expect}")
    with dispatch.use(backend="torch"):
        want = run()
    if {k: c.launches for k, c in counters.items()} != expect:
        raise AssertionError("the plain quant brgemm run launched a kernel")
    tol = quant_tol(torch.int8, torch.bfloat16)
    errs = {}
    for (nb, m, k, n), g, w in zip(BRGEMM_CASES, got, want):
        for name, a, b in zip(("brgemm", "batched_matmul"), g, w):
            errs[f"{name} B{nb} m{m} k{k} n{n}"] = close(a, b, *tol)
    emit({"phase": "quant", "entry": "brgemm / batched_matmul (quant=int8)",
          "cases": BRGEMM_CASES, "launches": launches,
          "expected_launches": expect,
          "max_abs_err": {k: v[1] for k, v in errs.items()},
          "atol": tol[0], "rtol": tol[1]})
    bad = [k for k, v in errs.items() if not v[0]]
    if bad:
        raise AssertionError(f"quant brgemm disagrees with plain: {bad}")
    return launches


# --------------------------------------------------------------------------
# 9. kernel times
# --------------------------------------------------------------------------

class NoDeviceTime(RuntimeError):
    """The profiler recorded no device event in any attempt."""


def device_ms_by_kernel(run, calls, attempts=3):
    """Device ms per call of each kernel that ``run()`` launches, summed
    from the profiler's device events (the kernels' own durations, so host
    gaps between launches do not count).  A session that comes back with
    no device event at all (seen once in some hundred sessions on the
    card) is run again; a third empty one raises NoDeviceTime."""
    for _ in range(attempts):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                    + ev.device_time_total / 1e3 / calls)
        if by_name:
            return by_name
    raise NoDeviceTime(f"the profiler recorded no device time in "
                       f"{attempts} sessions")


def host_split(run, calls, top=16):
    """(profiled host ms per call, {function: cumulative ms per call}) of
    the port's own functions under cProfile.  cProfile slows every Python
    call, so its milliseconds are read as shares."""
    host = cProfile.Profile()
    host.runcall(run)
    torch.cuda.synchronize()
    stats = pstats.Stats(host).stats   # (file, line, fn) -> (.., tt, ct, ..)
    own = sorted(((f"{Path(f).parent.name}/{Path(f).name}:{fn}", ct)
                  for (f, _, fn), (_, _, _, ct, _) in stats.items()
                  if "repro_torch" in f), key=lambda kv: -kv[1])[:top]
    total = sum(tt for _, _, tt, _, _ in stats.values())
    return total * 1e3 / calls, {k: ct * 1e3 / calls for k, ct in own}


def graph_ms(fn, sets, iters):
    """Device ms per call: CUDA events around the replay of a CUDA graph of
    ``iters`` calls (median of three replays), so the time holds the
    kernels and the gaps between them and no host work.  None where ``fn``
    cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            for i in range(3):
                fn(*sets[i % len(sets)])
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            for i in range(iters):
                fn(*sets[i % len(sets)])
    except Exception:  # noqa: BLE001 - any capture failure: another method
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return median(times)


def time_ms(fn, sets, iters=40):
    """(device ms, wall ms) per call, cycling through input ``sets`` that
    together exceed the 50 MB L2, so that each call finds its operands in
    device memory as the serving path does.  Device ms comes from a CUDA
    graph of the calls (graph_ms).  The profiler's sum of kernel durations
    is the fallback where a call cannot be captured: in a process that has
    run many profiler sessions it drops and gains kernel records (two
    GEMMs of identical work read 0.0092 and 0.0146 ms in one run of this
    script on an H100), and a line says where it was used.  Wall ms comes
    from CUDA events around back-to-back calls and so also holds any host
    gap between launches.  Where the profiler records no device event
    either (seen for some of cuDNN's convolutions at ResNet-50's shapes),
    device ms is the wall time, and a line says so."""
    for i in range(3):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    ms = graph_ms(fn, sets, iters)
    if ms is not None:
        return ms, wall

    def run():
        for i in range(iters):
            fn(*sets[i % len(sets)])

    try:
        ms = sum(device_ms_by_kernel(run, iters).values())
        emit({"device_ms_from": "profiler (capture failed)", "ms": ms,
              "wall_ms": wall})
        return ms, wall
    except NoDeviceTime as exc:
        emit({"profiler_empty": str(exc), "device_ms_from": "cuda events",
              "wall_ms": wall})
        return wall, wall


def n_sets(nbytes):
    return max(2, min(256, math.ceil(120e6 / nbytes)))


def bound(flops, nbytes, card, dtype=torch.bfloat16):
    """(bound ms, what bounds it) at the card's published peaks for inputs
    of ``dtype`` (bf16's, or int8 / fp8's twice as high)."""
    peak, bw = peaks(card, dtype)
    return (max(flops / peak, nbytes / bw) * 1e3,
            "operations" if flops / peak > nbytes / bw else "bytes")


def plan_fields(x, w):
    """A matmul row's plan: mainloop, tile rows and splits of k."""
    from repro_torch.kernels.brgemm.kernel import plan_call
    p = plan_call(x, w)
    return {"mainloop": p.mainloop, "bm": p.bm, "splits": p.splits}


def phase_times(cfg, card):
    import torch.nn.functional as F
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.flash_attention import (
        delta_rowsum_cuda, delta_rowsum_ref, flash_attention_bwd_cuda,
        flash_attention_bwd_ref, flash_attention_cuda, mha_ref)
    from repro_torch.kernels.flash_attention import bwd as FB
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dtype, rows = torch.bfloat16, []

    row = row_recorder(rows, card)

    for g in main_path_gemms(cfg) + train_gemms(cfg):
        out_bytes = 4 if g.out_dtype else 2
        nbytes = (g.m * g.k + g.k * g.n) * 2 + g.m * g.n * out_bytes
        sets = [gemm_inputs(g, dtype, gen) for _ in range(n_sets(nbytes))]
        ms, wall = time_ms(lambda x, w: matmul_cuda(
            x, w, activation=g.activation, out_dtype=g.out_dtype), sets)
        plain, _ = time_ms(lambda x, w: matmul_ref(
            x, w, activation=g.activation, out_dtype=g.out_dtype), sets)
        lib, _ = time_ms(torch.matmul, sets)
        # The serving run: one prefill and NEW_TOKENS - 1 decode forwards;
        # the head at the last position of each.  The quant tiers' runs:
        # decode_int8's prefill at full precision; the calibrated tiers'
        # head, every forward.
        serve = g.per_forward * (NEW_TOKENS - 1 if g.name.startswith(
            "decode") else NEW_TOKENS if g.name == "lm_head" else 1)
        quant = (1 + 2 * NEW_TOKENS if g.name == "lm_head" else
                 g.per_forward if g.name.startswith("prefill") else 0)
        row("matmul", g.name, ms, wall, 2 * g.m * g.n * g.k, nbytes, plain,
            lib, {"serve": serve, "train": g.per_step * TRAIN_STEPS,
                  "quant": quant},
            m=g.m, k=g.k, n=g.n, activation=g.activation, layout=g.kind,
            **plan_fields(*sets[0]))
        del sets

    b, hq, hkv, t, d = BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT, cfg.dh
    pairs = t * (t + 1) // 2                      # causal (q, k) pairs
    q_bytes, kv_bytes = 2 * b * hq * t * d, 2 * b * hkv * t * d
    nbytes = 2 * q_bytes + 2 * kv_bytes           # q, k, v in; o out
    sets = [qkv_views(b, hq, hkv, t, d, dtype, gen)
            for _ in range(n_sets(nbytes))]
    ms, wall = time_ms(lambda q, k, v, _: flash_attention_cuda(q, k, v),
                       sets)
    plain, _ = time_ms(lambda q, k, v, _: mha_ref(q, k, v), sets)
    lib, _ = time_ms(lambda q, k, v, _: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), sets)
    row("flash_attention", "prefill", ms, wall, 4 * b * hq * pairs * d,
        nbytes, plain, lib, {"serve": cfg.n_layers,
                             "train": cfg.n_layers * TRAIN_STEPS,
                             "quant": len(QUANT_TIERS) * cfg.n_layers},
        q=[b, hq, t, d], kv=[b, hkv, t, d],
        mainloop=FK.plan_call(*sets[0][:3]))

    # The backward at the train shape: q, k, v, o, dO, lse in; dq, dk, dv
    # out; five products over the causal pairs.
    lse_bytes = 4 * b * hq * t
    nbytes = 3 * q_bytes + 2 * kv_bytes + lse_bytes + q_bytes + 2 * kv_bytes
    bwd_sets, lib_sets = [], []
    for q, k, v, dy in sets:
        o, lse = flash_attention_cuda(q, k, v, return_residuals=True)
        bwd_sets.append((q, k, v, o, lse, dy))
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        lib_sets.append((out, leaves, dy))
    ms, wall = time_ms(flash_attention_bwd_cuda, bwd_sets)
    plain, _ = time_ms(flash_attention_bwd_ref, bwd_sets)
    lib, _ = time_ms(lambda out, leaves, dy: torch.autograd.grad(
        out, leaves, dy, retain_graph=True), lib_sets)
    q, k, v, o, _, dy = bwd_sets[0]
    row("flash_attention_bwd", "train", ms, wall, 10 * b * hq * pairs * d,
        nbytes, plain, lib, {"train": cfg.n_layers * TRAIN_STEPS},
        q=[b, hq, t, d], kv=[b, hkv, t, d],
        mainloop=FB.plan_call(q, k, v, o, dy))
    # No single PyTorch call takes bf16 y, dy to an fp32 rowsum.
    ysets = [(o, dy) for _, _, _, o, _, dy in bwd_sets]
    ms, wall = time_ms(delta_rowsum_cuda, ysets)
    plain, _ = time_ms(delta_rowsum_ref, ysets)
    # Off every path (the fused delta's oracle): one call's times.
    row("delta_rowsum", "train", ms, wall, 2 * b * hq * t * d,
        2 * q_bytes + lse_bytes, plain, None, {"one_call": 1},
        y=[b, hq, t, d])
    return rows


def row_recorder(rows, card, dtype=torch.bfloat16):
    def row(kernel, shape, ms, wall, flops, nbytes, plain, lib, calls, **kw):
        """One per-shape time; ``calls``: the shape's launches in each
        path's main run."""
        bms, by = bound(flops, nbytes, card, dtype)
        rows.append({"phase": "times", "kernel": kernel, "shape": shape,
                     "ms": ms, "wall_ms": wall, "bound_ms": bms,
                     "bound_by": by, "plain_ms": plain, "library_ms": lib,
                     "calls": calls, **kw})
        emit(rows[-1])
    return row


def channels_last(x, w):
    """NHWC x and RSCK w as F.conv2d's NCHW / KCRS views, both in the
    channels-last memory format cuDNN takes without a copy."""
    return (x.permute(0, 3, 1, 2),
            w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2))


def phase_times_paper(card):
    """ResNet-50's convolutions (forward, dgrad dual, wgrad GEMM) and head,
    and the brgemm path's stacked and batched GEMMs, in bf16."""
    import torch.nn.functional as F
    from repro_torch.kernels.brgemm import (batched_matmul_cuda,
                                            batched_matmul_ref, brgemm_ref,
                                            brgemm_stacked_cuda, matmul_cuda,
                                            matmul_ref)
    from repro_torch.kernels.brgemm.kernel import (plan_batched_call,
                                                   plan_stacked_call)
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
    from repro_torch.kernels.conv2d.ops import patches
    from repro_torch.models.resnet import ResNetCfg
    cfg = ResNetCfg()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    dtype, rows, iters = torch.bfloat16, [], 10
    row = row_recorder(rows, card)
    for cv in unique_convs(resnet_convs(cfg)):
        n, hw, p = RESNET_BATCH, cv.h, cv.p
        kw = dict(stride=cv.stride, padding=cv.padding)
        x_bytes, g_bytes = 2 * n * hw * hw * cv.c, 2 * n * p * p * cv.k
        w_bytes = 2 * cv.r * cv.r * cv.c * cv.k
        shape = dict(batch=n, c=cv.c, k=cv.k, h=hw, r=cv.r,
                     stride=cv.stride, padding=cv.padding, layers=cv.count)
        sets = [(*conv_inputs(cv, dtype, gen),)
                for _ in range(n_sets(x_bytes + g_bytes))]
        sets = [(x, w, *channels_last(x, w)) for x, w in sets]
        ms, wall = time_ms(lambda x, w, *_: conv2d_cuda(x, w, **kw), sets,
                           iters)
        plain, _ = time_ms(lambda x, w, *_: conv2d_ref(x, w, **kw), sets,
                           iters)
        lib, _ = time_ms(lambda _x, _w, xc, wc: F.conv2d(xc, wc, **kw), sets,
                         iters)
        # forward of the measured forward and of the gradient step's
        row("conv2d", f"resnet.fwd.{cv.name}", ms, wall, cv.flops,
            x_bytes + w_bytes + g_bytes, plain, lib,
            {"resnet": 2 * cv.count}, **shape)
        if cv.name != "stem":           # the image takes no gradient
            dsets = []
            for x, w, *_ in sets:
                gd, wd, pd = dgrad_inputs(cv, w, dtype, gen)
                dsets.append((gd, wd, *channels_last(gd, wd)))
            ms, wall = time_ms(lambda g, w, *_: conv2d_cuda(
                g, w, padding=pd, out_dtype=torch.float32), dsets, iters)
            plain, _ = time_ms(lambda g, w, *_: conv2d_ref(
                g, w, padding=pd, out_dtype=torch.float32), dsets, iters)
            lib, _ = time_ms(lambda _g, _w, gc, wc: F.conv2d(
                gc, wc, padding=pd), dsets, iters)
            # bound: dx = the transposed convolution's own work and bytes
            row("conv2d", f"resnet.dgrad.{cv.name}", ms, wall, cv.flops,
                g_bytes + w_bytes + 2 * x_bytes, plain, lib,
                {"resnet": cv.count}, dual_input=list(dsets[0][0].shape),
                **shape)
            del dsets
        wsets = [(patches(x, cv.r, cv.r, cv.stride, cv.padding).T,
                  torch.randn(n * p * p, cv.k, device="cuda",
                              generator=gen).to(dtype))
                 for x, *_ in sets]
        del sets
        ms, wall = time_ms(lambda a, g: matmul_cuda(
            a, g, out_dtype=torch.float32), wsets, iters)
        plain, _ = time_ms(lambda a, g: matmul_ref(
            a, g, out_dtype=torch.float32), wsets, iters)
        lib, _ = time_ms(torch.matmul, wsets, iters)
        row("matmul", f"resnet.wgrad.{cv.name}", ms, wall, cv.flops,
            x_bytes + g_bytes + 2 * w_bytes, plain, lib,
            {"resnet": cv.count}, gemm=list(wsets[0][0].shape) + [cv.k],
            layout="dw", **plan_fields(*wsets[0]), **shape)
        del wsets
    # The head: forward (with bias), dX = g W^T, dW = X^T g.
    b_, c_, k_ = RESNET_BATCH, 4 * 8 * cfg.width, cfg.n_classes
    for name, m, k, n, calls, make in (
            ("fwd", b_, c_, k_, 2, lambda x, w, g: (x, w)),
            ("dx", b_, k_, c_, 1, lambda x, w, g: (g, w.T)),
            ("dw", c_, b_, k_, 1, lambda x, w, g: (x.T, g))):
        hsets = []
        for _ in range(8):
            x = torch.randn(b_, c_, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(c_, k_, device="cuda", generator=gen)
                 * c_ ** -0.5).to(dtype)
            g = torch.randn(b_, k_, device="cuda", generator=gen).to(dtype)
            hsets.append(make(x, w, g))
        ms, wall = time_ms(matmul_cuda, hsets)
        plain, _ = time_ms(matmul_ref, hsets)
        lib, _ = time_ms(torch.matmul, hsets)
        row("matmul", f"resnet.head.{name}", ms, wall, 2 * m * k * n,
            2 * (m * k + k * n + m * n), plain, lib, {"resnet": calls},
            m=m, k=k, n=n, layout=name, **plan_fields(*hsets[0]))

    for nb, m, k, n in BRGEMM_CASES:
        def gemm_bytes(*mats):
            return 2 * sum(math.prod(t) for t in mats)

        case = f"B{nb} m{m} k{k} n{n}"
        flops = 2 * nb * m * k * n
        nbytes = gemm_bytes((nb, m, k), (nb, k, n), (m, n))
        bsets = []
        for _ in range(n_sets(nbytes)):
            a = torch.randn(nb, m, k, device="cuda", generator=gen).to(dtype)
            b = (torch.randn(nb, k, n, device="cuda", generator=gen)
                 * (nb * k) ** -0.5).to(dtype)
            g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
            bsets.append((a, b, g))
        ms, wall = time_ms(lambda a, b, g: brgemm_stacked_cuda(a, b), bsets)
        plain, _ = time_ms(lambda a, b, g: brgemm_ref(a, b), bsets)
        lib, _ = time_ms(lambda a, b, g: torch.einsum("imk,ikn->mn", a, b),
                         bsets)
        p = plan_stacked_call(*bsets[0][:2])
        row("brgemm_stacked", case, ms, wall, flops, nbytes, plain, lib,
            {"brgemm": 1}, batch=nb, m=m, k=k, n=n, mainloop=p.mainloop,
            bm=p.bm, splits=p.splits)
        # batched_matmul's own call, then brgemm's backward: g broadcast,
        # B^T and A^T read in place.
        for name, make, mats in (
                ("A_i @ B_i", lambda a, b, g: (a, b),
                 ((nb, m, k), (nb, k, n), (nb, m, n))),
                ("dA = g @ B_i^T", lambda a, b, g: (g, b.transpose(1, 2)),
                 ((m, n), (nb, k, n), (nb, m, k))),
                ("dB = A_i^T @ g", lambda a, b, g: (a.transpose(1, 2), g),
                 ((nb, m, k), (m, n), (nb, k, n)))):
            sets = [make(*t) for t in bsets]
            ms, wall = time_ms(batched_matmul_cuda, sets)
            plain, _ = time_ms(batched_matmul_ref, sets)
            lib, _ = time_ms(torch.matmul, sets)
            p = plan_batched_call(*sets[0])
            row("batched_matmul", f"{name} {case}", ms, wall, flops,
                gemm_bytes(*mats), plain, lib, {"brgemm": 1}, batch=nb,
                m=m, k=k, n=n, mainloop=p.mainloop, bm=p.bm)
        del bsets
    return rows


def library_runs(fn, *args):
    """Time of one PyTorch call, or None where it refuses the shape (say,
    torch._int_mm wants more than 16 rows); the refusal is printed."""
    try:
        fn(*args)
    except RuntimeError as exc:
        emit({"library_refused": str(exc).splitlines()[0][:160]})
        return False
    return True


def phase_times_quant(cfg, card):
    """The quantized GEMMs at the quantized serving path's shapes (int8 and
    e4m3, bf16 out, fp32 for the head) and the quantized brgemm /
    batched_matmul at the paper's cases (int8), with bounds at the 8-bit
    peak: operand bytes at 1 an element, the fp32 scales, the output.  The
    library column: fp8, torch._scaled_mm with row-wise fp32 scales (the
    whole function, bf16 out); int8, torch._int_mm, the int32 product only
    (no scales, no epilogue), so it undercounts the function's work."""
    from repro_torch.kernels.brgemm import (
        batched_matmul_q_cuda, batched_matmul_q_ref, brgemm_q_cuda,
        brgemm_q_ref, matmul_q_cuda, matmul_q_ref)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = []
    for fmt in (torch.int8, torch.float8_e4m3fn):
        row = row_recorder(rows, card, fmt)
        name = str(fmt).replace("torch.", "")
        for g in main_path_gemms(cfg):
            if g.name == "lm_head" and fmt != torch.int8:
                continue          # only decode_int8 quantizes the head
            out_dtype = g.out_dtype or torch.bfloat16
            out_bytes = 4 if g.out_dtype else 2
            nbytes = (g.m * g.k + g.k * g.n + 4 * (g.m + g.n)
                      + g.m * g.n * out_bytes)
            sets = []
            for _ in range(n_sets(nbytes)):
                x, w = gemm_inputs(g, torch.bfloat16, gen)
                xq, sx, wq, sw = quantized(x, w, fmt)
                # _scaled_mm wants B column-major: a copy made here, untimed
                sets.append((xq, sx, wq, sw, wq.t().contiguous().t()))
            kw = dict(activation=g.activation, out_dtype=out_dtype)
            ms, wall = time_ms(lambda xq, sx, wq, sw, _: matmul_q_cuda(
                xq, wq, sx, sw, **kw), sets)
            plain, _ = time_ms(lambda xq, sx, wq, sw, _: matmul_q_ref(
                xq, wq, sx, sw, **kw), sets)
            if fmt == torch.int8:
                lib_name = "torch._int_mm (int32 product only)"

                def lib_fn(xq, sx, wq, sw, _):
                    return torch._int_mm(xq, wq)
            else:
                lib_name = "torch._scaled_mm (row-wise scales, bf16 out)"

                def lib_fn(xq, sx, wq, sw, wcol):
                    return torch._scaled_mm(xq, wcol, scale_a=sx[:, None],
                                            scale_b=sw[None, :],
                                            out_dtype=torch.bfloat16)
            lib = (time_ms(lib_fn, sets)[0] if library_runs(lib_fn, *sets[0])
                   else None)
            # Launches in the quant phase's bf16 runs: decode_int8 and the
            # calibrated int8 tier run the int8 rows (the head's only in
            # decode_int8's decode), the fp8 tier the e4m3 rows.
            decode = NEW_TOKENS - 1
            if g.name == "lm_head":
                calls = decode
            elif g.name.startswith("decode"):
                calls = g.per_forward * decode * (2 if fmt == torch.int8
                                                  else 1)
            else:
                calls = g.per_forward
            row("matmul_q", f"{name} {g.name}", ms, wall,
                2 * g.m * g.n * g.k, nbytes, plain, lib, {"quant": calls},
                m=g.m, k=g.k, n=g.n, activation=g.activation, layout=g.kind,
                library=lib_name)
            del sets
    row = row_recorder(rows, card, torch.int8)
    for nb, m, k, n in BRGEMM_CASES:
        case = f"int8 B{nb} m{m} k{k} n{n}"
        flops = 2 * nb * m * k * n
        sets = []
        per_set = nb * m * k + nb * k * n
        for _ in range(n_sets(per_set)):
            a = torch.randn(nb, m, k, device="cuda", generator=gen)
            b = torch.randn(nb, k, n, device="cuda", generator=gen)
            aq, sa, bq, sb = quantized(a, b, torch.int8)
            sets.append((aq, bq, sa, sb))
        # brgemm_q: batch-shared scales (m,), (n,); batched_matmul_q:
        # per-entry scales; bf16 out, as quant_entry_points runs them.  No
        # one PyTorch call computes either.
        shared = [(aq, bq, sa[0], sb[0]) for aq, bq, sa, sb in sets]
        bf16 = dict(out_dtype=torch.bfloat16)
        ms, wall = time_ms(lambda *t: brgemm_q_cuda(*t, **bf16), shared)
        plain, _ = time_ms(lambda *t: brgemm_q_ref(*t, **bf16), shared)
        row("brgemm_q", case, ms, wall, flops,
            per_set + 4 * (m + n) + 2 * m * n, plain, None, {"quant": 1},
            batch=nb, m=m, k=k, n=n)
        ms, wall = time_ms(lambda *t: batched_matmul_q_cuda(*t, **bf16), sets)
        plain, _ = time_ms(lambda *t: batched_matmul_q_ref(*t, **bf16), sets)
        row("batched_matmul_q", case, ms, wall, flops,
            per_set + 4 * nb * (m + n) + 2 * nb * m * n, plain, None,
            {"quant": 1}, batch=nb, m=m, k=k, n=n)
        del sets, shared
    return rows


SOURCES = {   # kernel -> (source, the TPU kernel it replaces)
    "matmul": ("src/repro_torch/kernels/brgemm/csrc/matmul.cu",
               "src/repro/kernels/brgemm/kernel.py:118"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:37"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/flash_attention_bwd/csrc/flash_bwd.cu",
        "src/repro/kernels/flash_attention/bwd.py:115"),
    "delta_rowsum": (
        "src/repro_torch/kernels/flash_attention_bwd/csrc/flash_bwd.cu",
        "src/repro/kernels/flash_attention/bwd.py:79"),
    "conv2d": ("src/repro_torch/kernels/conv2d/csrc/conv2d.cu",
               "src/repro/kernels/conv2d/kernel.py:42"),
    "brgemm_stacked": (
        "src/repro_torch/kernels/brgemm_batched/csrc/batched.cu",
        "src/repro/kernels/brgemm/kernel.py:192"),
    "batched_matmul": (
        "src/repro_torch/kernels/brgemm_batched/csrc/batched.cu",
        "src/repro/kernels/brgemm/kernel.py:263"),
    "matmul_q": ("src/repro_torch/kernels/brgemm_quant/csrc/quant.cu",
                 "src/repro/kernels/brgemm/quant_kernel.py:75"),
    "brgemm_q": ("src/repro_torch/kernels/brgemm_quant/csrc/quant.cu",
                 "src/repro/kernels/brgemm/quant_kernel.py:159"),
    "batched_matmul_q": (
        "src/repro_torch/kernels/brgemm_quant/csrc/quant.cu",
        "src/repro/kernels/brgemm/quant_kernel.py:243"),
}


def kernels_line(rows, launches_by_path, worst):
    """Per kernel, each time summed over the launches of the runs that
    drove the paths, from the per-shape times of phase 8 (each row's
    ``calls`` by path); the sums are also given by path.  The paths' runs:
    serving, one bf16 ``Engine.generate``; training, TRAIN_STEPS bf16
    steps; resnet, one bf16 forward and one gradient step; brgemm, the
    bf16 forward and backward of each of BRGEMM_CASES and one
    ``batched_matmul`` each.  ``delta_rowsum`` runs on none of them (it is
    the oracle of the fused delta): its times are one call's."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    out = []
    for name, (source, replaces) in SOURCES.items():
        paths = {}
        by_ops = total_bound = 0.0
        for r in rows:
            if r["kernel"] != name:
                continue
            for path, n in r["calls"].items():
                if n == 0:
                    continue
                acc = paths.setdefault(path, dict.fromkeys(keys, 0.0))
                for key in keys:
                    acc[key] = (None if r[key] is None or acc[key] is None
                                else acc[key] + r[key] * n)
                total_bound += r["bound_ms"] * n
                if r["bound_by"] == "operations":
                    by_ops += r["bound_ms"] * n
        launches = {path: counts.get(name, 0)
                    for path, counts in launches_by_path.items()}
        total = {k: (None if any(p[k] is None for p in paths.values())
                     else sum(p[k] for p in paths.values())) for k in keys}
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": sum(launches.values()),
                    "max_abs_err": worst[name], **total,
                    "bound_by": ("operations" if by_ops > total_bound / 2
                                 else "bytes"),
                    "launches_by_path": launches, "by_path": paths})
    return {"kernels": out}


def main():
    card = phase_device()
    from repro_torch.configs import get
    from repro_torch.models.resnet import ResNetCfg
    cfg = get("smollm-135m")
    phase_build()
    worst = phase_parity(cfg)
    worst.update(phase_parity_paper(ResNetCfg()))
    worst.update(phase_parity_quant(cfg))
    launches = {"serve": phase_serve(cfg), "train": phase_train(cfg),
                "resnet": phase_resnet(), "brgemm": phase_brgemm(),
                "quant": phase_quant(cfg)}
    rows = (phase_times(cfg, card) + phase_times_paper(card)
            + phase_times_quant(cfg, card))
    emit(kernels_line(rows, launches, worst))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

"""Drive the PyTorch port's serving path on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):
  1. device  — a CUDA card of compute capability 9.0; its name and power
               limit as nvidia-smi gives them.
  2. build   — both kernels (brgemm, flash_attention) built from
               ``src/repro_torch/kernels/*/csrc`` by nvcc for sm_90a, in
               parallel; build seconds and the -Xptxas -v summary.
  3. parity  — each kernel against its plain PyTorch version on the card, at
               the main-path shapes of smollm-135m (B = 8 prompts of 512
               tokens), in fp32 and bf16, within stated tolerances.
  4. serve   — full-width smollm-135m (random weights from a seed)
               ``Engine.generate``: 8 prompts x 512 tokens, 64 greedy
               tokens, bf16.  Once on the kernels (counting launches) and
               once with ``use(backend="torch")``; prefill logits compared;
               then the same in fp32, where the greedy tokens must match.
               Prefill and decode-step times of the kernel path, the
               device's busy and idle share of decode steps under
               torch.profiler, and the host's time by function under
               cProfile.
  5. times   — each kernel's device time (profiler) and back-to-back wall
               time (CUDA events) at each main-path shape, beside its
               bound, its plain version and one library call.
Then the kernels line, the card line, and ``{"ok": true, ...}`` last.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

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

# Tolerances, |kernel - plain| <= atol + rtol * |plain|, and why:
#   fp32 GEMM / attention: both accumulate fp32 in different orders, with no
#     TF32 on either side; the observed spread is ~1e-6 of values ~5.
#   bf16-out GEMM: both round the same fp32 sum to bf16, so they differ by at
#     most one bf16 ulp where the sums fall on either side of a rounding
#     boundary (2^-7 relative at |x| in [1, 2), 1.6e-2 at |x| in [2, 4)).
#   bf16 attention: the kernel rounds p = exp(s - m_running) to bf16, the
#     plain version p / l after a full softmax; a few bf16 ulps.
#   lse: fp32 on both sides.
TOL = {
    ("matmul", torch.float32): (1e-4, 1e-4),
    ("matmul", torch.bfloat16): (1e-2, 1e-2),
    ("flash_attention", torch.float32): (1e-4, 1e-4),
    ("flash_attention", torch.bfloat16): (2e-2, 2e-2),
    ("lse", None): (1e-4, 1e-5),
}
# Full-width serving, kernels vs plain on one card, prefill logits (fp32
# values ~N(0, 1) over 49152 entries): bf16 runs round every activation to
# bf16 in 30 layers on both paths, and a one-ulp flip early spreads, so the
# bf16 band is wide; fp32 runs agree to fp32 sum order.
LOGITS_BAND = {torch.bfloat16: 0.25, torch.float32: 1e-3}

# Published dense peaks (NVIDIA data sheets), by the card nvidia-smi names.
PEAKS = {  # bf16 tensor FLOP/s, HBM bytes/s
    "sxm": (989e12, 3.35e12),
    "pcie": (756e12, 2.0e12),
    "nvl": (835e12, 3.9e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name: str):
    low = name.lower()
    return PEAKS["pcie" if "pcie" in low else "nvl" if "nvl" in low
                 else "sxm"]


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
    with ThreadPoolExecutor(2) as ex:   # one nvcc per kernel, together
        built = list(ex.map(_build.build, ["brgemm", "flash_attention"]))
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
    head: bool = False        # w is the tied table read as table.T, fp32 out
    per_forward: int = 0      # launches in one forward of the main path


def main_path_gemms(cfg):
    d, dq, dkv, f = cfg.d_model, cfg.n_heads * cfg.dh, \
        cfg.n_kv_heads * cfg.dh, cfg.d_ff
    L, out = cfg.n_layers, []
    for phase, m in (("prefill", BATCH * PROMPT), ("decode", BATCH)):
        out += [Gemm(f"{phase}.q", m, d, dq, per_forward=L),
                Gemm(f"{phase}.kv", m, d, dkv, per_forward=2 * L),
                Gemm(f"{phase}.o", m, dq, d, per_forward=L),
                Gemm(f"{phase}.gate_silu", m, d, f, "silu", per_forward=L),
                Gemm(f"{phase}.up", m, d, f, per_forward=L),
                Gemm(f"{phase}.down", m, f, d, per_forward=L)]
    # The head sees the last position only, in prefill and in decode.
    out.append(Gemm("lm_head", BATCH, d, cfg.vocab, head=True,
                    per_forward=1))
    return out


def gemm_inputs(g: Gemm, dtype, gen):
    x = torch.randn(g.m, g.k, device="cuda", generator=gen).to(dtype)
    if g.head:
        table = (torch.randn(g.n, g.k, device="cuda", generator=gen)
                 * g.k ** -0.5).to(dtype)
        w = table.T                       # column-major view, read in place
    else:
        w = (torch.randn(g.k, g.n, device="cuda", generator=gen)
             * g.k ** -0.5).to(dtype)
    return x, w


def close(got, ref, atol, rtol):
    diff = (got.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return ok, diff.max().item(), (diff / ref.float().abs().clamp_min(1e-3)
                                   ).max().item()


def phase_parity(cfg):
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"matmul": 0.0, "flash_attention": 0.0}
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
        for g in main_path_gemms(cfg):
            if g.name.endswith(".up") or g.name.endswith(".o"):
                continue          # same (m, k, n) as q / gate
            x, w = gemm_inputs(g, dtype, gen)
            out_dtype = torch.float32 if g.head else None
            got = matmul_cuda(x, w, activation=g.activation,
                              out_dtype=out_dtype)
            ref = matmul_ref(x, w, activation=g.activation,
                             out_dtype=out_dtype)
            record("matmul", f"{g.name} m{g.m} k{g.k} n{g.n} "
                   f"{g.activation}", dtype, got, ref,
                   TOL[("matmul", torch.float32)] if g.head else tol)
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

        ftol = TOL[("flash_attention", dtype)]
        for case, (b, hq, hkv, t, d) in (
                ("prefill", (BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT,
                             cfg.dh)),
                ("ragged T500", (BATCH, cfg.n_heads, cfg.n_kv_heads, 500,
                                 cfg.dh)),
                ("d32", (2, 4, 2, 256, 32))):
            # (B, T, H, d) activations viewed as (B, H, T, d), as the
            # attention layer's head split hands them over.
            q, k, v = (torch.randn(b, t, h, d, device="cuda",
                                   generator=gen).to(dtype).transpose(1, 2)
                       for h in (hq, hkv, hkv))
            o, lse = flash_attention_cuda(q, k, v, causal=True,
                                          return_residuals=True)
            ro, rl = mha_ref(q, k, v, causal=True, return_lse=True)
            shape = f"q{tuple(q.shape)} kv{tuple(k.shape)} causal"
            record("flash_attention", f"{case} {shape}", dtype, o, ro, ftol)
            record("flash_attention", f"{case} lse", dtype, lse, rl,
                   TOL[("lse", None)])
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
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


def phase_serve(base_cfg):
    from repro_torch.core import dispatch
    from repro_torch.kernels.brgemm import matmul_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    main_launches = None
    for dtype in (torch.bfloat16, torch.float32):
        cfg, params, engine = make_engine(base_cfg, dtype)
        tokens = prompts(cfg)
        engine.generate({"tokens": tokens[:, :16]}, n_tokens=2,
                        stop_tokens=())           # warm-up, not counted
        torch.cuda.synchronize()
        # The main path: counts zeroed just before, read just after.
        matmul_cuda.launches = flash_attention_cuda.launches = 0
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
               "generate_s": seconds,
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


def step_times(cfg, params, tokens):
    """Host-clock prefill and decode-step times of the kernel path."""
    from repro_torch.models import api
    with torch.inference_mode():
        cache = api.init_cache(cfg, BATCH, MAX_LEN, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, {"tokens": tokens}, cfg, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        n = 16
        t0 = time.perf_counter()
        for i in range(n):
            logits, cache = api.decode_step(params, tok, cfg, cache,
                                            PROMPT + i)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_s = (time.perf_counter() - t0) / n
        # Device busy time of a few decode steps: the kernels' own
        # durations under the profiler, against the unprofiled step time.
        prof_steps = 4

        def steps():
            nonlocal logits, cache, tok
            for i in range(prof_steps):
                logits, cache = api.decode_step(params, tok, cfg, cache,
                                                PROMPT + n + i)
                tok = logits.argmax(-1).to(torch.int32)[:, None]

        by_name = device_ms_by_kernel(steps, prof_steps)
        # Where the host's time goes in the same steps.  cProfile slows
        # every Python call, so its milliseconds are read as shares.
        host = cProfile.Profile()
        host.runcall(steps)
        torch.cuda.synchronize()
        prefill_busy_ms = sum(device_ms_by_kernel(
            lambda: api.prefill(params, {"tokens": tokens}, cfg, cache),
            1).values())
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    stats = pstats.Stats(host).stats   # (file, line, fn) -> (.., tt, ct, ..)
    own = sorted(((f"{Path(f).parent.name}/{Path(f).name}:{fn}", ct)
                  for (f, _, fn), (_, _, _, ct, _) in stats.items()
                  if "repro_torch" in f), key=lambda kv: -kv[1])[:16]
    emit({"phase": "serve_steps", "prefill_ms": prefill_s * 1e3,
          "prefill_device_busy_ms": prefill_busy_ms,
          "prefill_device_idle_share": 1 - prefill_busy_ms / (prefill_s
                                                               * 1e3),
          "decode_step_ms": decode_s * 1e3,
          "decode_tokens_per_s": BATCH / decode_s,
          "decode_device_busy_ms": busy_ms,
          "decode_device_idle_share": 1 - busy_ms / (decode_s * 1e3),
          "decode_device_ms_by_kernel": {k[:80]: v for k, v in top},
          "decode_host_cprofile_step_ms": sum(
              tt for _, _, tt, _, _ in stats.values()) * 1e3 / prof_steps,
          "decode_host_cprofile_cumulative_ms": {
              k: ct * 1e3 / prof_steps for k, ct in own}})


# --------------------------------------------------------------------------
# 5. kernel times
# --------------------------------------------------------------------------

def device_ms_by_kernel(run, calls):
    """Device ms per call of each kernel that ``run()`` launches, summed
    from the profiler's device events (the kernels' own durations, so host
    gaps between launches do not count)."""
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
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    return by_name


def time_ms(fn, sets, iters=40):
    """(device ms, wall ms) per call, cycling through input ``sets`` that
    together exceed the 50 MB L2, so that each call finds its operands in
    device memory as the serving path does.  Device ms is the sum of the
    call's kernel durations; wall ms comes from CUDA events around
    back-to-back calls and so also holds any host gap between launches."""
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

    def run():
        for i in range(iters):
            fn(*sets[i % len(sets)])

    return sum(device_ms_by_kernel(run, iters).values()), wall


def n_sets(nbytes):
    return max(2, min(256, math.ceil(120e6 / nbytes)))


def phase_times(cfg, card):
    import torch.nn.functional as F
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    bf16_peak, bw = peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dtype, rows = torch.bfloat16, []
    for g in main_path_gemms(cfg):
        out_bytes = 4 if g.head else 2
        nbytes = (g.m * g.k + g.k * g.n) * 2 + g.m * g.n * out_bytes
        flops = 2 * g.m * g.n * g.k
        sets = [gemm_inputs(g, dtype, gen) for _ in range(n_sets(nbytes))]
        out_dtype = torch.float32 if g.head else None
        ms, wall = time_ms(lambda x, w: matmul_cuda(
            x, w, activation=g.activation, out_dtype=out_dtype), sets)
        plain, _ = time_ms(lambda x, w: matmul_ref(
            x, w, activation=g.activation, out_dtype=out_dtype), sets)
        lib, _ = time_ms(torch.matmul, sets)
        bound = max(flops / bf16_peak, nbytes / bw) * 1e3
        rows.append({"phase": "times", "kernel": "matmul", "shape": g.name,
                     "m": g.m, "k": g.k, "n": g.n,
                     "activation": g.activation, "ms": ms,
                     "wall_ms": wall, "bound_ms": bound,
                     "bound_by": ("operations" if flops / bf16_peak
                                  > nbytes / bw else "bytes"),
                     "plain_ms": plain, "library_ms": lib,
                     "per_forward": g.per_forward})
        emit(rows[-1])
        del sets
    b, hq, hkv, t, d = BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT, cfg.dh
    pairs = t * (t + 1) // 2                      # causal (q, k) pairs
    flops = 4 * b * hq * pairs * d
    nbytes = 2 * (2 * b * hq * t * d + 2 * b * hkv * t * d)
    sets = [tuple(torch.randn(b, t, h, d, device="cuda", generator=gen)
                  .to(dtype).transpose(1, 2) for h in (hq, hkv, hkv))
            for _ in range(n_sets(nbytes))]
    ms, wall = time_ms(lambda q, k, v: flash_attention_cuda(q, k, v), sets)
    plain, _ = time_ms(lambda q, k, v: mha_ref(q, k, v), sets)
    lib, _ = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), sets)
    rows.append({"phase": "times", "kernel": "flash_attention",
                 "shape": "prefill", "q": [b, hq, t, d], "kv": [b, hkv, t, d],
                 "ms": ms, "wall_ms": wall,
                 "bound_ms": max(flops / bf16_peak, nbytes / bw) * 1e3,
                 "bound_by": ("operations" if flops / bf16_peak > nbytes / bw
                              else "bytes"),
                 "plain_ms": plain, "library_ms": lib,
                 "per_forward": cfg.n_layers})
    emit(rows[-1])
    return rows


def kernels_line(rows, launches, worst):
    """Per kernel, each time summed over the launches of the serving run
    (one prefill and NEW_TOKENS - 1 decode forwards; flash runs at prefill
    only), from the per-shape times of phase 5."""
    srcs = {
        "matmul": ("src/repro_torch/kernels/brgemm/csrc/matmul.cu",
                   "src/repro/kernels/brgemm/kernel.py:118"),
        "flash_attention": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
            "src/repro/kernels/flash_attention/kernel.py:37"),
    }
    out = []
    for name, (source, replaces) in srcs.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0}
        by_ops = 0.0
        for r in rows:
            if r["kernel"] != name:
                continue
            if r["shape"].startswith("decode"):
                calls = r["per_forward"] * (NEW_TOKENS - 1)
            elif r["shape"] == "lm_head":
                calls = r["per_forward"] * NEW_TOKENS
            else:
                calls = r["per_forward"]
            for key in tot:
                tot[key] += r[key] * calls
            if r["bound_by"] == "operations":
                by_ops += r["bound_ms"] * calls
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": worst[name], "ms": tot["ms"],
                    "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                    "bound_by": ("operations" if by_ops > tot["bound_ms"] / 2
                                 else "bytes"),
                    "library_ms": tot["library_ms"]})
    return {"kernels": out}


def main():
    card = phase_device()
    from repro_torch.configs import get
    cfg = get("smollm-135m")
    phase_build()
    worst = phase_parity(cfg)
    launches = phase_serve(cfg)
    rows = phase_times(cfg, card)
    emit(kernels_line(rows, launches, worst))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

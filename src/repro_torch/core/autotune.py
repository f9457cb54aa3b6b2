"""Measured block policy: search the plans around the one kernel.

The port of ``repro/core/autotune.py``.  The paper reduces DL library
development to "mere (potentially automatic) tuning of loops around this
sole optimized kernel"; ``repro_torch.use(blocks_policy="autotune")`` makes
every kernel wrapper resolve its plan by

  1. enumerating the op's candidate grid (``core/blocking.py``: for the
     GEMM family the mainloops, tile rows and split counts the kernels
     take at run time; deterministic order, the heuristic's plan first and
     always measured, so a search never loses to it on the measured
     problem),
  2. timing each candidate with CUDA events around a CUDA graph of its
     launches on a proxy problem of the call's canonical (m, n, k) and
     geometry (ones, laid out as the call's operands), after one warm-up
     launch,
  3. memoizing the winner in the dispatch tuning cache, which persists to
     JSON through ``REPRO_TORCH_TUNING_CACHE``, so that a search is paid
     once a machine.

Off the ``cuda`` backend the policy returns the heuristic's plan and
measures nothing (the reference's off-Pallas rule), and so it does for a
grid of one plan (the flash kernels').  ``REPRO_AUTOTUNE_CANDIDATES`` and
``REPRO_AUTOTUNE_REPEATS`` cap the work, as in the reference.

    python -m repro_torch.core.autotune --op matmul --shape M N K \
        --dtype bfloat16

runs one search on the card and reports how many candidates it measured:
zero on a warm persisted cache.  ``--backend torch`` runs it without a
card, measuring nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import os
from typing import Callable, Sequence

import torch

from repro_torch import obs
from repro_torch.core import blocking, dispatch
from repro_torch.obs.telemetry import TELEMETRY

ENV_MAX_CANDIDATES = "REPRO_AUTOTUNE_CANDIDATES"
ENV_REPEATS = "REPRO_AUTOTUNE_REPEATS"
DEFAULT_MAX_CANDIDATES = 8
DEFAULT_REPEATS = 3
# A measurement's CUDA graph: launches for about GRAPH_MS of device work
# (by the warm-up launch's time), at most GRAPH_LAUNCHES.
GRAPH_MS, GRAPH_LAUNCHES = 1.0, 32
GEMM_OPS = ("matmul", "brgemm", "batched_matmul")


def _stat(name: str) -> property:
    return property(
        lambda self: TELEMETRY.autotune[name],
        lambda self, value: TELEMETRY.set_autotune(name, value))


class SearchStats:
    """Process-wide counters, a view of ``obs.TELEMETRY.autotune``: the
    CLI's report, these attributes and the ``repro_autotune_*_total``
    families read one store."""
    searches = _stat("searches")
    measured = _stat("measured")
    failed = _stat("failed")
    seeded = _stat("seeded")   # grids seeded from a tuned neighbour

    def snapshot(self) -> dict:
        return dict(TELEMETRY.autotune)


STATS = SearchStats()


# --------------------------------------------------------------------------
# proxy problems
# --------------------------------------------------------------------------

def _ones(rows, cols, col_major, dtype, batch=None, align=8):
    """A (rows, cols) matrix of ones, or ``batch`` of them, row- or
    column-major, its leading dimension padded to ``align`` elements so
    that TMA can read it (an aligned call's proxy)."""
    inner, outer = (rows, cols) if col_major else (cols, rows)
    ld = -(-inner // align) * align
    shape = (outer, ld) if batch is None else (batch, outer, ld)
    t = _filled(shape, dtype)[..., :inner]
    return t.transpose(-1, -2) if col_major else t


def _filled(shape, dtype):
    """Ones of ``dtype`` on the card (fp8 through bf16, which holds them
    exactly)."""
    fill = (torch.bfloat16 if dtype.is_floating_point and dtype.itemsize == 1
            else dtype)
    return torch.ones(shape, dtype=fill, device="cuda").to(dtype)


def proxy_runner(op: str, m: int, n: int, k: int, dtype, plan, *,
                 geometry=None, quant=None) -> Callable[[], object]:
    """A zero-argument callable that runs ``op``'s kernel once under
    ``plan`` on a proxy of the canonical (m, n, k) and ``geometry``.

    GEMMs read ones laid out as the geometry says (each operand row- or
    column-major, ``nb`` entries); with ``quant`` the quantized kernels
    run on unit-scale 8-bit operands, K-major.  The convolution runs the
    geometry's true window, stride and padding.  ``flash_attention_bwd``
    runs the forward once outside the callable (the residuals are inputs,
    not work).  Operands are built outside ``torch.inference_mode`` so that
    a search inside an engine's serving loop makes ordinary tensors.
    """
    geometry = geometry or blocking.default_geometry(op, m, n, k, dtype,
                                                     quant=quant)
    dtype = blocking.as_dtype(dtype)
    g = geometry
    with torch.inference_mode(False):
        if op in GEMM_OPS and quant is not None:
            from repro_torch.core.quantize import as_quant_config
            from repro_torch.kernels.brgemm import quant_kernel as QK
            qcfg = as_quant_config(quant)
            adt = blocking.as_dtype(qcfg.a_dtype)
            wdt = blocking.as_dtype(qcfg.w_dtype)
            batch = None if op == "matmul" else g.nb
            aq = _ones(m, k, False, adt, batch, 16)
            bq = _ones(k, n, True, wdt, batch, 16)
            scale = functools.partial(torch.ones, dtype=torch.float32,
                                      device="cuda")
            fn, sa, sb = {
                "matmul": (QK.matmul_q_cuda, scale(m), scale(n)),
                "brgemm": (QK.brgemm_q_cuda, scale(m), scale(n)),
                "batched_matmul": (QK.batched_matmul_q_cuda,
                                   scale(g.nb, m), scale(g.nb, n))}[op]
            return lambda: fn(aq, bq, sa, sb, plan=plan, quant=qcfg)
        if op in GEMM_OPS:
            from repro_torch.kernels.brgemm import kernel as K
            batch = None if op == "matmul" else g.nb
            align = 8 if g.tma else 1
            a = _ones(m, k, g.a_t, dtype, batch, align)
            b = _ones(k, n, g.b_t, dtype, batch, align)
            fn = {"matmul": K.matmul_cuda, "brgemm": K.brgemm_stacked_cuda,
                  "batched_matmul": K.batched_matmul_cuda}[op]
            return lambda: fn(a, b, plan=plan)
        if op == "conv2d":
            from repro_torch.kernels.conv2d.kernel import conv2d_cuda
            x = _filled((g.n, g.h, g.w, n), dtype)
            w = _filled((g.r, g.s, n, k), dtype)
            return lambda: conv2d_cuda(x, w, stride=g.stride,
                                       padding=g.padding, plan=plan)
        if op in ("flash_attention", "flash_attention_bwd"):
            from repro_torch.kernels.flash_attention import kernel as FK
            q = _filled((1, 1, m, k), dtype)
            kv = _filled((1, 1, n, k), dtype)
            if op == "flash_attention":
                return lambda: FK.flash_attention_cuda(q, kv, kv,
                                                       causal=False,
                                                       plan=plan)
            from repro_torch.kernels.flash_attention.bwd import (
                flash_attention_bwd_cuda,
            )
            y, lse = FK.flash_attention_cuda(
                q, kv, kv, causal=False, return_residuals=True,
                plan=blocking.default_plan("flash_attention", m, n, k,
                                           dtype, geometry=g))
            dy = torch.ones_like(y)
            return lambda: flash_attention_bwd_cuda(q, kv, kv, y, lse, dy,
                                                    causal=False, plan=plan)
    raise ValueError(f"no autotune runner for op {op!r}")


def measure_candidate(op: str, m: int, n: int, k: int, dtype, backend: str,
                      plan, repeats: int | None = None, geometry=None,
                      quant=None) -> float:
    """Best-of-``repeats`` device time (seconds) a launch of one candidate:
    after one warm-up launch, CUDA events around the replay of a CUDA
    graph of launches (enough for ~GRAPH_MS of work, at most
    GRAPH_LAUNCHES).  A kernel of a few microseconds takes less device
    time than the host's launch of it, so events around one launch would
    time the host; a graph's launches run back to back."""
    del backend   # the runner is the kernel; other backends never measure
    repeats = repeats if repeats is not None else int(
        os.environ.get(ENV_REPEATS, DEFAULT_REPEATS))
    fn = proxy_runner(op, m, n, k, dtype, plan, geometry=geometry,
                      quant=quant)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()                                  # warm-up, and the graph's size
    end.record()
    end.synchronize()
    launches = max(1, min(GRAPH_LAUNCHES, math.ceil(
        GRAPH_MS / max(start.elapsed_time(end), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    best = float("inf")
    for _ in range(max(1, repeats)):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / launches)
    return best


def _same_choice(a, b) -> bool:
    """Whether two plans make the same choice: a flash mainloop, or a
    ``Plan``'s mainloop, tile rows and split count (its chunk and tiles
    follow from the shape)."""
    if isinstance(a, blocking.Plan) and isinstance(b, blocking.Plan):
        return (a.mainloop, a.bm, a.splits) == (b.mainloop, b.bm, b.splits)
    return a == b


def nearest_tuned_neighbor(op: str, m: int, n: int, k: int, dtype,
                           backend: str):
    """The winning plan of the closest problem already tuned by the named
    ``autotune`` policy, of the same (op, backend, dtype): distance is the
    L1 log2 gap over the canonical triple.  None where there is none."""
    dname = blocking.dtype_name(dtype)
    best, best_d = None, float("inf")
    for key, plan in dispatch.tuning_cache_info().items():
        kop, kbackend, km, kn, kk, kdtype, kpolicy = key[:7]
        if (kop, kbackend, kdtype) != (op, backend, dname):
            continue
        if kpolicy != "autotune":
            continue
        d = sum(abs(math.log2(max(a, 1)) - math.log2(max(b, 1)))
                for a, b in ((m, km), (n, kn), (k, kk)))
        if d < best_d:
            best, best_d = plan, d
    return best


def _prune(candidates: Sequence, heuristic, max_candidates: int) -> list:
    """Deterministic subset: the heuristic pick first, then an evenly
    spaced sample of the remaining grid."""
    rest = [c for c in candidates if c != heuristic]
    keep = max(0, max_candidates - 1)
    if len(rest) > keep:
        if keep == 0:
            rest = []
        else:
            step = len(rest) / keep
            rest = [rest[int(i * step)] for i in range(keep)]
    return [heuristic] + rest


def autotune_blocks(op: str, m: int, n: int, k: int, dtype, backend: str, *,
                    geometry=None, quant=None,
                    max_candidates: int | None = None,
                    repeats: int | None = None,
                    timer: Callable | None = None):
    """Measured search over the candidate grid; returns the fastest plan.

    ``timer(op, m, n, k, dtype, backend, plan) -> seconds`` is injectable
    for tests; the default is :func:`measure_candidate` on the proxy.
    Candidate order is deterministic, ties keep the earlier candidate, and
    a candidate whose launch raises is skipped and counted in
    ``STATS.failed``; if every one fails, the heuristic's plan is
    returned.  The grid is seeded from the nearest tuned neighbour: where
    this grid holds a plan making its winner's choice (``_same_choice``),
    that plan is measured first, ahead of the heuristic.
    """
    heuristic = blocking.default_plan(op, m, n, k, dtype, geometry=geometry,
                                      quant=quant)
    if backend != "cuda":
        # the plain version has no plan: nothing to measure
        return heuristic
    grid = blocking.candidate_grid(op, m, n, k, dtype, geometry=geometry,
                                   quant=quant)
    if len(grid) == 1:
        return heuristic
    max_candidates = max_candidates if max_candidates is not None else int(
        os.environ.get(ENV_MAX_CANDIDATES, DEFAULT_MAX_CANDIDATES))
    if timer is None:
        timer = functools.partial(measure_candidate, repeats=repeats,
                                  geometry=geometry, quant=quant)
    candidates = _prune(grid, heuristic, max_candidates)
    neighbour = nearest_tuned_neighbor(op, m, n, k, dtype, backend)
    seed = next((c for c in grid if neighbour is not None
                 and _same_choice(c, neighbour)), None)
    if seed is not None:
        # prepended, then trimmed: the seed displaces the tail candidate,
        # so the budget is never exceeded
        candidates = [seed] + [c for c in candidates if c != seed]
        candidates = candidates[:max(1, max_candidates)]
        STATS.seeded += 1
    STATS.searches += 1
    tr = obs.current_tracer()
    cost = obs.op_cost(op, m, n, k, dtype, geometry=geometry,
                       quant=quant) if tr is not None else None
    search_span = tr.span(
        "autotune.search", op=op, m=int(m), n=int(n), k=int(k),
        dtype=blocking.dtype_name(dtype), candidates=len(candidates),
        seeded=seed is not None) if tr is not None else obs.NULL_SPAN
    best, best_t = heuristic, float("inf")
    with search_span:
        for cand in candidates:
            try:
                if tr is not None:
                    with tr.span("autotune.measure", op=op,
                                 blocks=str(cand)) as sp:
                        t = timer(op, m, n, k, dtype, backend, cand)
                        sp.set(seconds=t, flops=cost.flops,
                               gflops_per_s=round(cost.flops / t / 1e9, 3)
                               if t > 0 else None)
                else:
                    t = timer(op, m, n, k, dtype, backend, cand)
                STATS.measured += 1
            except Exception:  # noqa: BLE001 - a plan that cannot launch
                STATS.failed += 1
                continue
            if t < best_t:
                best, best_t = cand, t
        search_span.set(best=str(best), best_seconds=best_t
                        if best_t < float("inf") else None)
    return best


dispatch.register_block_policy("autotune", autotune_blocks)


# --------------------------------------------------------------------------
# CLI: one search, reporting the cache's warmth
# --------------------------------------------------------------------------

def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="one autotune search; measured=0 means the persisted "
                    "tuning cache (REPRO_TORCH_TUNING_CACHE) answered")
    ap.add_argument("--op", default="matmul",
                    choices=("matmul", "brgemm", "batched_matmul", "conv2d",
                             "flash_attention", "flash_attention_bwd"))
    ap.add_argument("--shape", nargs=3, type=int, default=(32, 32, 32),
                    metavar=("M", "N", "K"),
                    help="the op's canonical triple")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--nb", type=int, default=1,
                    help="entries of a brgemm or batched_matmul call")
    ap.add_argument("--quant", default=None,
                    help="quant spec ('int8', 'fp8', or a QuantConfig "
                         "tag): tunes the quantized kernel")
    ap.add_argument("--candidates", type=int, default=None,
                    help="cap the measured candidates")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--backend", default="cuda", choices=dispatch.BACKENDS,
                    help="'torch' measures nothing and needs no card")
    args = ap.parse_args(argv)

    if args.backend == "cuda":
        dispatch.check_device("cuda")
        if not dispatch._is_hopper(torch.cuda.current_device()):
            raise RuntimeError(f"the kernels need a card of compute "
                               f"capability {dispatch.HOPPER}")
    m, n, k = args.shape
    qcfg = None
    dtype = blocking.as_dtype(args.dtype)
    if args.quant is not None:
        from repro_torch.core.quantize import as_quant_config
        qcfg = as_quant_config(args.quant)
        # a quantized call keys (and tunes) by its weights' storage dtype
        dtype = blocking.as_dtype(qcfg.w_dtype)
    geometry = blocking.default_geometry(args.op, m, n, k, dtype, quant=qcfg)
    if args.op in ("brgemm", "batched_matmul"):
        geometry = dataclasses.replace(geometry, nb=args.nb)
    # The caps go through the environment, not a callable policy, so that
    # the search stays under the named policy, whose entries persist.
    if args.candidates is not None:
        os.environ[ENV_MAX_CANDIDATES] = str(args.candidates)
    if args.repeats is not None:
        os.environ[ENV_REPEATS] = str(args.repeats)
    before = STATS.snapshot()
    with dispatch.use(blocks_policy="autotune"):
        plan = dispatch.resolve_blocks(args.op, m, n, k, dtype,
                                       backend=args.backend,
                                       geometry=geometry, quant=qcfg)
    measured = STATS.measured - before["measured"]
    failed = STATS.failed - before["failed"]
    # hit or miss by whether a search ran: measured == 0 alone would also
    # hold for a cold search whose every candidate failed
    hit = STATS.searches == before["searches"]
    qfield = f" quant={qcfg.tag()}" if qcfg is not None else ""
    print(f"autotune op={args.op} shape={m}x{n}x{k} "
          f"dtype={blocking.dtype_name(dtype)}{qfield} selected={plan} "
          f"failed={failed} measured={measured} "
          f"cache={'hit' if hit else 'miss'} "
          f"cache_errors={dispatch.cache_load_errors()}", flush=True)


if __name__ == "__main__":
    main()

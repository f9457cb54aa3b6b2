"""Serving smokes.

The port of ``repro/serve/smoke.py``: the reduced config of ``--arch``,
random weights from seed 0, on the card unless ``--device cpu`` is given
(the plain versions then run every op).

``python -m repro_torch.serve.smoke`` serves a handful of mixed-length
requests through ``ContinuousEngine`` under ``blocks_policy="autotune"``,
asserts every request completes, and reports how many plan candidates
were actually measured — zero on a warm persisted
``REPRO_TORCH_TUNING_CACHE`` (``measured=0 cache=hit``) and on the CPU,
where no kernel has a plan.

``python -m repro_torch.serve.smoke --frontend`` exercises the async
serving front-end instead: two engine replicas on different tiers (fp32
accumulation, and ``accum_dtype="bfloat16"``, the reference's two) behind
an ``EngineRouter``, one
replica hit by an injected ``step()`` fault
mid-service.  The smoke asserts the replica is quarantined, its in-flight
requests requeue onto the survivor, and *every* submitted request still
resolves ``completed`` through its awaitable handle — then prints the
Prometheus exposition line count as a sanity check on metrics export.

``python -m repro_torch.serve.smoke --chaos`` drives the full self-healing
loop under a seeded ``FaultInjector``: three replicas, transient faults
(survived by in-place retry), one permanent fault and one hang (each
quarantining its replica, which is then health-probed, warm-restarted,
and re-admitted), all on an injectable clock.  The smoke asserts every
request reaches a terminal status, at least one retry / two quarantines
/ two re-admissions happened, and the greedy token streams are
token-for-token identical to a fault-free reference run.

``python -m repro_torch.serve.smoke --trace`` serves under an installed
``repro_torch.obs.Tracer``: asserts prefill/decode/request spans were
recorded, that every request's TTFT breakdown (queue/prefill/first
decode) sums exactly to its wall-clock TTFT, and that the exported
Chrome trace JSON round-trips ``obs.chrome.validate``.

``python -m repro_torch.serve.smoke --paged`` serves a mixed-length workload
through the paged KV pool (2x-overcommitted page budget + chunked
prefill) and through the slotted pool, asserting token-for-token greedy
parity, full completion, and a drained page allocator (no leaks).

``python -m repro_torch.serve.smoke --chaos-soak`` is the long-haul variant of
``--chaos``: a seeded random transient-fault *rate* on every injector
site of two of three replicas, a 3x-length mixed workload on paged
pools, and SLO asserts — every request terminal, availability >= 95%,
and every completed stream token-identical to a fault-free reference.
"""
from __future__ import annotations

import argparse
import os
from typing import Sequence


def _params(cfg, args):
    """Random weights of ``cfg`` from seed 0 on ``args.device``."""
    import torch

    from repro_torch.models import api
    gen = torch.Generator(device=args.device).manual_seed(0)
    return api.init_params(cfg, gen, device=args.device)


def _continuous_smoke(args) -> None:
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import autotune
    from repro_torch.serve import ContinuousEngine, PoolConfig, Request

    cfg = configs.get(args.arch).reduced()
    params = _params(cfg, args)
    before = autotune.STATS.snapshot()
    # --quant: int8 decode tier next to the full-precision prefill tier —
    # the per-phase context mix production decode runs (decode streams
    # weights, so int8 halves its bytes; prefill stays compute-bound).
    decode_quant = "int8" if args.quant else None
    engine = ContinuousEngine(
        cfg, params, PoolConfig(n_slots=args.n_slots, max_len=args.max_len),
        blocks_policy="autotune", decode_quant=decode_quant,
        device=args.device)

    rng = np.random.default_rng(0)
    requests = [
        Request(prompt=rng.integers(0, cfg.vocab, 3 + i % 7).tolist(),
                max_tokens=2 + i % 3, stop_tokens=())
        for i in range(args.requests)
    ]
    out = engine.serve(requests)
    completed = sum(1 for toks in out.values() if toks)
    measured = autotune.STATS.measured - before["measured"]
    hit = autotune.STATS.searches == before["searches"]
    qfield = " quant=int8-decode" if args.quant else ""
    print(f"serve-smoke arch={args.arch}{qfield} device={args.device} "
          f"completed={completed}/{len(requests)} "
          f"tokens={engine.metrics.tokens_generated} "
          f"occupancy={engine.metrics.occupancy():.2f} "
          f"measured={measured} cache={'hit' if hit else 'miss'}")
    if completed != len(requests):
        raise SystemExit(f"only {completed}/{len(requests)} completed")


def _frontend_smoke(args) -> None:
    import asyncio

    import numpy as np

    from repro_torch import configs
    from repro_torch.serve import (AsyncFrontend, ContinuousEngine,
                                   EngineReplica, EngineRouter, PoolConfig,
                                   Request)

    cfg = configs.get(args.arch).reduced()
    params = _params(cfg, args)
    pool = lambda: PoolConfig(n_slots=args.n_slots,  # noqa: E731
                              max_len=args.max_len)
    # two tiers: default accumulation next to an explicit bf16-accum tier
    flaky = ContinuousEngine(cfg, params, pool(), accum_dtype="bfloat16",
                             device=args.device)
    calls = [0]
    orig_step = flaky.step

    def injected_fault():
        calls[0] += 1
        if calls[0] == args.fail_at_step:
            raise RuntimeError("injected replica fault")
        return orig_step()
    flaky.step = injected_fault

    router = EngineRouter(
        [EngineReplica("stable", ContinuousEngine(cfg, params, pool(),
                                                  device=args.device),
                       tier="fp32"),
         EngineReplica("flaky", flaky, tier="bf16")],
        max_waiting=4 * args.requests)

    rng = np.random.default_rng(0)
    requests = [
        Request(prompt=rng.integers(0, cfg.vocab, 3 + i % 7).tolist(),
                max_tokens=3 + i % 3, stop_tokens=())
        for i in range(args.requests)
    ]

    async def main():
        async with AsyncFrontend(router) as frontend:
            handles = [await frontend.submit(r) for r in requests]
            return [await h for h in handles]

    results = asyncio.run(main())
    completed = sum(1 for r in results if r.status == "completed")
    tokens = sum(len(r.tokens) for r in results)
    prom_lines = len(router.metrics().to_prometheus().splitlines())
    print(f"frontend-smoke arch={args.arch} replicas=2 "
          f"completed={completed}/{len(requests)} tokens={tokens} "
          f"quarantined={router.counters['replicas_quarantined']} "
          f"requeued={router.counters['requests_requeued']} "
          f"prometheus_lines={prom_lines}")
    if completed != len(requests):
        bad = [(r.status, r.finish_reason) for r in results
               if r.status != "completed"]
        raise SystemExit(f"only {completed}/{len(requests)} completed: {bad}")
    if router.counters["replicas_quarantined"] != 1:
        raise SystemExit("the injected fault did not quarantine a replica")
    if router.counters["requests_requeued"] < 1:
        raise SystemExit("no requests were requeued off the failed replica")


def _chaos_smoke(args) -> None:
    import numpy as np

    from repro_torch import configs
    from repro_torch.serve import (ContinuousEngine, EngineReplica,
                                   EngineRouter, FaultClock, FaultInjector,
                                   FaultSpec, HealthConfig, PoolConfig,
                                   Request, RetryPolicy)

    cfg = configs.get(args.arch).reduced()
    params = _params(cfg, args)
    pool = lambda: PoolConfig(n_slots=args.n_slots,  # noqa: E731
                              max_len=args.max_len)
    make_engine = lambda: ContinuousEngine(  # noqa: E731
        cfg, params, pool(), device=args.device)

    rng = np.random.default_rng(0)
    requests = [
        Request(prompt=rng.integers(0, cfg.vocab, 3 + i % 7).tolist(),
                max_tokens=3 + i % 3, stop_tokens=())
        for i in range(args.requests)
    ]
    # greedy fault-free reference: with temperature=0 every token is a
    # pure function of the prompt, so chaos-run streams must match it
    reference = make_engine().serve(requests)
    ref_tokens = [reference[i] for i in sorted(reference)]

    clk = FaultClock()
    injector = FaultInjector([
        # transient blips on "flaky": survived by in-place retry
        FaultSpec(site="step", target="flaky", at=2, kind="transient"),
        FaultSpec(site="step", target="flaky", at=3, kind="transient"),
        # permanent fault on "doomed": quarantine -> probe -> re-admit
        FaultSpec(site="step", target="doomed", at=2, kind="fatal"),
        # one hang on "flaky" right after the retries, past the
        # watchdog deadline: quarantined too
        FaultSpec(site="step", target="flaky", at=4, kind="hang",
                  hang_s=10.0),
    ], clock=clk)
    replicas = [
        EngineReplica("stable", make_engine(), factory=make_engine),
        EngineReplica("flaky", injector.instrument(make_engine(), "flaky"),
                      factory=make_engine),
        EngineReplica("doomed", injector.instrument(make_engine(), "doomed"),
                      factory=make_engine),
    ]
    router = EngineRouter(
        replicas, clock=clk, sleep=clk.advance,
        retry=RetryPolicy(max_retries=3, backoff_s=0.01, seed=0),
        health=HealthConfig(probe_interval_s=1.0, probes_to_readmit=2,
                            max_probes=8, watchdog_s=5.0))

    out = router.serve(requests)
    statuses = [router.tickets[tid].status for tid in sorted(out)]
    # drive the probe loop until both quarantined replicas rejoin
    for _ in range(64):
        if all(r.healthy for r in replicas):
            break
        clk.advance(1.0)
        router.step()
    readmitted = router.counters["replicas_readmitted"]
    # second wave lands on the healed cluster (including the rejoins)
    out2 = router.serve(requests[:3])
    statuses += [router.tickets[tid].status for tid in sorted(out2)]

    chaos_tokens = [out[tid] for tid in sorted(out)]
    parity = sum(1 for got, ref in zip(chaos_tokens, ref_tokens)
                 if got == ref)
    terminal = sum(1 for s in statuses if s is not None)
    c = router.counters
    print(f"chaos-smoke arch={args.arch} replicas=3 "
          f"terminal={terminal}/{len(statuses)} "
          f"parity={parity}/{len(requests)} "
          f"retries={c['retries']} quarantined={c['replicas_quarantined']} "
          f"readmitted={readmitted} probes={c['probes']} "
          f"requeued={c['requests_requeued']} "
          f"faults={len(injector.fired)}")
    if terminal != len(statuses):
        raise SystemExit("a request never reached a terminal status")
    if parity != len(requests):
        bad = [i for i, (g, r) in enumerate(zip(chaos_tokens, ref_tokens))
               if g != r]
        raise SystemExit(f"chaos streams diverged from the fault-free "
                         f"reference at requests {bad}")
    if c["retries"] < 1:
        raise SystemExit("no transient fault was retried")
    if c["replicas_quarantined"] < 2:
        raise SystemExit("expected the fatal fault and the hang to "
                         "quarantine a replica each")
    if readmitted < 2:
        raise SystemExit("quarantined replicas were not re-admitted")
    if not all(r.healthy for r in replicas):
        raise SystemExit("a replica is still unhealthy after the probe "
                         "loop")


def _paged_smoke(args) -> None:
    import numpy as np

    from repro_torch import configs
    from repro_torch.serve import ContinuousEngine, PoolConfig, Request

    cfg = configs.get(args.arch).reduced()
    params = _params(cfg, args)
    rng = np.random.default_rng(0)
    # mixed prompt lengths, several past the chunk size so chunked
    # prefill runs, plus a 2x-overcommitted page budget so the allocator
    # churns (and may preempt) while parity must still hold
    lens = [3 + (7 * i) % (args.max_len - 12) for i in range(args.requests)]
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    reqs = lambda: [Request(prompt=p, max_tokens=2 + i % 4,  # noqa: E731
                            stop_tokens=())
                    for i, p in enumerate(prompts)]

    slotted = ContinuousEngine(
        cfg, params, PoolConfig(n_slots=args.n_slots, max_len=args.max_len),
        device=args.device)
    reference = slotted.serve(reqs())

    page_size = 8
    pages_per_slot = -(-args.max_len // page_size)
    n_pages = max(pages_per_slot, args.n_slots * pages_per_slot // 2)
    engine = ContinuousEngine(
        cfg, params, PoolConfig(n_slots=args.n_slots, max_len=args.max_len,
                                page_size=page_size, n_pages=n_pages,
                                prefill_chunk=2 * page_size),
        device=args.device)
    if not engine.paged:
        raise SystemExit(f"arch {args.arch} did not take the paged pool")
    out = engine.serve(reqs())

    completed = sum(1 for toks in out.values() if toks)
    parity = sum(1 for a, b in zip(sorted(out), sorted(reference))
                 if out[a] == reference[b])
    pool = engine.pool
    leak_ok = (pool.page_alloc_count == pool.page_free_count
               and pool.n_free_pages == pool.n_pages
               and pool.n_free == pool.n_slots)
    print(f"paged-smoke arch={args.arch} "
          f"completed={completed}/{len(prompts)} "
          f"parity={parity}/{len(prompts)} "
          f"page_size={page_size} pages={n_pages} "
          f"chunks={engine.metrics.prefill_chunks} "
          f"preemptions={engine.metrics.preemptions} "
          f"page_occupancy={pool.page_occupancy:.2f} "
          f"fragmentation={pool.fragmentation:.2f} "
          f"leak={'ok' if leak_ok else 'LEAK'}")
    if completed != len(prompts):
        raise SystemExit(f"only {completed}/{len(prompts)} completed")
    if parity != len(prompts):
        bad = [int(a) for a, b in zip(sorted(out), sorted(reference))
               if out[a] != reference[b]]
        raise SystemExit(f"paged tokens diverged from slotted at {bad}")
    if not leak_ok:
        raise SystemExit(
            f"page leak after drain: alloc={pool.page_alloc_count} "
            f"free={pool.page_free_count} "
            f"free_pages={pool.n_free_pages}/{pool.n_pages}")


def _chaos_soak_smoke(args) -> None:
    import numpy as np

    from repro_torch import configs
    from repro_torch.serve import (ContinuousEngine, EngineReplica,
                                   EngineRouter, FaultClock, FaultInjector,
                                   HealthConfig, PoolConfig, Request,
                                   RetryPolicy)

    cfg = configs.get(args.arch).reduced()
    params = _params(cfg, args)
    page_size = 8
    pool = lambda: PoolConfig(n_slots=args.n_slots,  # noqa: E731
                              max_len=args.max_len, page_size=page_size,
                              prefill_chunk=2 * page_size)
    make_engine = lambda: ContinuousEngine(  # noqa: E731
        cfg, params, pool(), device=args.device)

    rng = np.random.default_rng(0)
    n = 3 * args.requests   # a longer mixed soak, not a quick smoke
    lens = [3 + (7 * i) % (args.max_len - 12) for i in range(n)]
    requests = [
        Request(prompt=rng.integers(0, cfg.vocab, lens[i]).tolist(),
                max_tokens=2 + i % 4, stop_tokens=())
        for i in range(n)
    ]
    # greedy fault-free reference: the soaked cluster must stream the
    # exact same tokens for every request that completes
    reference = make_engine().serve(requests)
    ref_tokens = [reference[i] for i in sorted(reference)]

    clk = FaultClock()
    # no scripted faults: a seeded random transient *rate* per site, the
    # sustained low-grade failure weather a soak is about
    injector = FaultInjector([], clock=clk, seed=0,
                             rates={"step": 0.06, "prefill": 0.06,
                                    "decode": 0.06})
    replicas = [
        EngineReplica("stable", make_engine(), factory=make_engine),
        EngineReplica("soak-a", injector.instrument(make_engine(), "soak-a"),
                      factory=make_engine),
        EngineReplica("soak-b", injector.instrument(make_engine(), "soak-b"),
                      factory=make_engine),
    ]
    router = EngineRouter(
        replicas, clock=clk, sleep=clk.advance,
        retry=RetryPolicy(max_retries=4, backoff_s=0.01, seed=0),
        health=HealthConfig(probe_interval_s=1.0, probes_to_readmit=2,
                            max_probes=32, watchdog_s=600.0))

    out = router.serve(requests)
    statuses = [router.tickets[tid].status for tid in sorted(out)]
    terminal = sum(1 for s in statuses if s is not None)
    completed = sum(1 for s in statuses if s == "completed")
    chaos_tokens = [out[tid] for tid in sorted(out)]
    parity = sum(1 for got, ref in zip(chaos_tokens, ref_tokens)
                 if got == ref)
    availability = completed / n
    c = router.counters
    print(f"chaos-soak arch={args.arch} replicas=3 requests={n} "
          f"terminal={terminal}/{n} completed={completed}/{n} "
          f"parity={parity}/{completed} "
          f"availability={availability:.2f} "
          f"faults={len(injector.fired)} retries={c['retries']} "
          f"quarantined={c['replicas_quarantined']} "
          f"readmitted={c['replicas_readmitted']} "
          f"requeued={c['requests_requeued']}")
    # SLOs: every request reaches a terminal status; availability (the
    # completed fraction) holds 95% under the sustained fault rate; every
    # completed stream is token-for-token the fault-free reference
    if terminal != n:
        raise SystemExit("SLO violation: a request never reached a "
                         "terminal status")
    if availability < 0.95:
        raise SystemExit(f"SLO violation: availability "
                         f"{availability:.2f} < 0.95")
    if parity != completed:
        bad = [i for i, (g, r) in enumerate(zip(chaos_tokens, ref_tokens))
               if g != r and statuses[i] == "completed"]
        raise SystemExit(f"soak streams diverged from the fault-free "
                         f"reference at requests {bad}")
    if len(injector.fired) < 3:
        raise SystemExit(f"the soak barely soaked: only "
                         f"{len(injector.fired)} faults fired")


def _trace_smoke(args) -> None:
    import numpy as np

    from repro_torch import configs, obs
    from repro_torch.serve import ContinuousEngine, PoolConfig, Request

    cfg = configs.get(args.arch).reduced()
    params = _params(cfg, args)
    engine = ContinuousEngine(
        cfg, params, PoolConfig(n_slots=args.n_slots, max_len=args.max_len),
        device=args.device)

    rng = np.random.default_rng(0)
    requests = [
        Request(prompt=rng.integers(0, cfg.vocab, 3 + i % 7).tolist(),
                max_tokens=2 + i % 3, stop_tokens=())
        for i in range(args.requests)
    ]
    tracer = obs.Tracer()
    prev = obs.install(tracer)
    try:
        out = engine.serve(requests)
    finally:
        obs.install(prev)

    completed = sum(1 for toks in out.values() if toks)
    names = {r.name for r in tracer.spans()}
    for needed in ("prefill", "decode", "request", "request.queue",
                   "request.prefill", "request.first_decode"):
        if needed not in names:
            raise SystemExit(f"no {needed!r} span was recorded "
                             f"(got {sorted(names)})")
    # the TTFT breakdown must telescope: its segments are cut from
    # contiguous stamps on one clock, so they sum to ttft_s exactly
    checked = 0
    for state in engine.scheduler.finished.values():
        bd = state.ttft_breakdown
        if bd is None or state.ttft_s is None:
            raise SystemExit(
                f"request {state.request_id} has no TTFT breakdown")
        if abs(sum(bd.values()) - state.ttft_s) > 1e-6:
            raise SystemExit(
                f"request {state.request_id} breakdown {bd} does not sum "
                f"to ttft_s={state.ttft_s}")
        checked += 1

    n_events = obs.export_chrome(tracer, args.trace_out)
    trace = obs.chrome.load(args.trace_out)
    obs.chrome.validate(trace)
    chrome_names = {ev["name"] for ev in trace["traceEvents"]}
    if "request" not in chrome_names or "decode" not in chrome_names:
        raise SystemExit(f"chrome export lost spans: {sorted(chrome_names)}")

    print(f"trace-smoke arch={args.arch} "
          f"completed={completed}/{len(requests)} "
          f"spans={len(tracer.spans())} chrome_events={n_events} "
          f"breakdown=ok({checked}) trace={args.trace_out}")
    if completed != len(requests):
        raise SystemExit(f"only {completed}/{len(requests)} completed")


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="where the weights, pools and ops live (cuda or "
                         "cpu)")
    ap.add_argument("--quant", action="store_true",
                    help="serve with an int8 decode tier "
                         "(decode_quant='int8') next to full-precision "
                         "prefill")
    ap.add_argument("--frontend", action="store_true",
                    help="async front-end smoke: two replicas behind the "
                         "router, one injected fault, all must complete")
    ap.add_argument("--chaos", action="store_true",
                    help="self-healing smoke: seeded fault injector "
                         "(transient, fatal, hang) against three replicas "
                         "with retry + health probes; asserts retries, "
                         "quarantine, re-admission, and token parity with "
                         "a fault-free run")
    ap.add_argument("--paged", action="store_true",
                    help="paged-pool smoke: mixed-length workload on an "
                         "overcommitted page budget with chunked prefill, "
                         "token parity vs the slotted pool, allocator "
                         "leak check")
    ap.add_argument("--chaos-soak", action="store_true",
                    help="long mixed workload under a sustained seeded "
                         "transient-fault rate; asserts terminal-status "
                         "and availability SLOs plus greedy parity")
    ap.add_argument("--trace", action="store_true",
                    help="tracing smoke: serve under an installed tracer, "
                         "assert prefill/decode/request spans and an "
                         "exactly-telescoping TTFT breakdown, export + "
                         "validate a Chrome trace JSON")
    ap.add_argument("--trace-out", default="trace_smoke.json",
                    help="with --trace: Chrome trace output path")
    ap.add_argument("--fail-at-step", type=int, default=2,
                    help="with --frontend: replica step() call that raises")
    ap.add_argument("--candidates", type=int, default=None,
                    help="cap the measured candidate count per search")
    ap.add_argument("--repeats", type=int, default=None)
    args = ap.parse_args(argv)

    from repro_torch.core import autotune

    if args.candidates is not None:
        os.environ[autotune.ENV_MAX_CANDIDATES] = str(args.candidates)
    if args.repeats is not None:
        os.environ[autotune.ENV_REPEATS] = str(args.repeats)

    if args.chaos_soak:
        _chaos_soak_smoke(args)
    elif args.chaos:
        _chaos_smoke(args)
    elif args.frontend:
        _frontend_smoke(args)
    elif args.trace:
        _trace_smoke(args)
    elif args.paged:
        _paged_smoke(args)
    else:
        _continuous_smoke(args)


if __name__ == "__main__":
    main()

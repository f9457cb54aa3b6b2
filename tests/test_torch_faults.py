"""The port's self-healing serving layer, against the JAX package's.

Every case of ``tests/test_serve_faults.py`` runs on the port: fault
classification, retry/backoff, quarantine -> health probe ->
re-admission, the hang watchdog, graceful degradation (off-tier routing,
parked requests on a hard-down cluster), the corrupt-tuning-cache
fallback and the frontend stop/submit race.  Everything is seeded and runs
on an injectable clock.

The seeded draws (``RetryPolicy``'s jitter, ``FaultInjector``'s rates) and
one self-healing scenario (three replicas: transient faults at prefill and
at decode, a fatal fault, a hang past the watchdog, probes and
re-admission, then a second wave) are held against ``repro.serve`` on the
same inputs (reduced smollm-135m in fp32, the reference's weights carried
over by ``interop``) exactly: each request's tokens, status and replica,
``injector.fired``, the router's counters and the exposition (samples
whose values are wall-clock times aside).  ``FaultInjector.instrument``
leaves no reference cycle: an instrumented engine dies with its last
reference.
"""
import asyncio
import gc
import json
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import api as japi
from repro_torch import configs, interop
from repro_torch import serve as tserve
from repro_torch.core import dispatch
from repro_torch.serve import (
    AsyncFrontend,
    ContinuousEngine,
    EngineReplica,
    EngineRouter,
    FatalError,
    FaultClock,
    FaultInjector,
    FaultSpec,
    HealthConfig,
    PoolConfig,
    Request,
    RetryPolicy,
    TransientError,
    classify_failure,
)
from repro_torch.serve import cluster as cl
from repro_torch.serve.health import ReplicaHungError

MAX_LEN = 32


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get("smollm-135m").reduced()
    cfg = configs.get("smollm-135m").reduced()
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def dense(pair):
    return pair[2], pair[3]


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).tolist() for n in lens]


def _engine(dense, n_slots=2):
    cfg, params = dense
    return ContinuousEngine(cfg, params,
                            PoolConfig(n_slots=n_slots, max_len=MAX_LEN),
                            device="cpu")


def _requests(cfg, lens, seed=0, max_tokens=3):
    return [Request(prompt=p, max_tokens=max_tokens, stop_tokens=())
            for p in _prompts(cfg, lens, seed=seed)]


def _reference(dense, requests):
    """Greedy fault-free token streams, in submission order."""
    out = _engine(dense, n_slots=4).serve(requests)
    return [out[i] for i in sorted(out)]


# ==========================================================================
# taxonomy / policy units (no engine)
# ==========================================================================

def test_classify_failure():
    assert classify_failure(TransientError("x")) == "transient"
    assert classify_failure(FatalError("x")) == "fatal"
    assert classify_failure(RuntimeError("plain")) == "fatal"
    # the transient tag propagates through the __cause__ chain
    try:
        try:
            raise TransientError("inner")
        except TransientError as inner:
            raise RuntimeError("wrapped") from inner
    except RuntimeError as outer:
        assert classify_failure(outer) == "transient"
    # any exception type can self-tag without importing the serve layer
    exc = ValueError("tagged")
    exc.transient = True
    assert classify_failure(exc) == "transient"


def test_retry_policy_backoff():
    pol = RetryPolicy(max_retries=3, backoff_s=0.1, backoff_mult=2.0,
                      max_backoff_s=0.3, jitter=0.1, seed=7)
    delays = [pol.backoff(a) for a in (1, 2, 3, 4)]
    # exponential then capped, each within +-10% jitter
    for d, base in zip(delays, (0.1, 0.2, 0.3, 0.3)):
        assert base * 0.9 <= d <= base * 1.1
    # seeded: a fresh policy with the same seed replays the schedule
    again = RetryPolicy(max_retries=3, backoff_s=0.1, backoff_mult=2.0,
                        max_backoff_s=0.3, jitter=0.1, seed=7)
    assert [again.backoff(a) for a in (1, 2, 3, 4)] == delays
    assert RetryPolicy(jitter=0.0).backoff(1) == 0.05
    # the reference's draws, bit for bit
    ref = jserve.RetryPolicy(max_retries=3, backoff_s=0.1, backoff_mult=2.0,
                             max_backoff_s=0.3, jitter=0.1, seed=7)
    assert [ref.backoff(a) for a in (1, 2, 3, 4)] == delays


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec(site="step", kind="explode")
    with pytest.raises(ValueError, match="hang_s"):
        FaultSpec(site="step", kind="hang")


def test_injector_schedule_and_counters():
    clk = FaultClock()
    inj = FaultInjector([
        FaultSpec(site="step", target="a", at=2, kind="transient"),
        FaultSpec(site="step", target="b", at=1, kind="fatal"),
        FaultSpec(site="io", at=1, kind="hang", hang_s=3.0,
                  repeat=True, until=2),
    ], clock=clk)
    inj.fire("step", "a")                       # call 1: clean
    with pytest.raises(TransientError):
        inj.fire("step", "a")                   # call 2: fires
    inj.fire("step", "a")                       # one-shot: clear again
    with pytest.raises(FatalError):
        inj.fire("step", "b")
    inj.fire("io")                              # hang: advances the clock
    inj.fire("io")
    inj.fire("io")                              # past until: clean
    assert clk.now() == 6.0
    assert inj.calls[("step", "a")] == 3
    assert [f[3] for f in inj.fired] == ["transient", "fatal",
                                         "hang", "hang"]


def test_injector_rates_match_reference():
    """A seeded random rate fires at the same calls in both packages."""
    fired = []
    for S, errors in ((tserve, (TransientError,)),
                      (jserve, (jserve.TransientError,))):
        inj = S.FaultInjector([], seed=3, rates={"step": 0.3,
                                                 "decode": 0.1})
        for i in range(40):
            for site in ("step", "decode"):
                try:
                    inj.fire(site, f"r{i % 3}")
                except errors:
                    pass
        fired.append(inj.fired)
    assert fired[0] == fired[1] and len(fired[0]) > 3


def test_hang_requires_clock():
    inj = FaultInjector([FaultSpec(site="s", kind="hang", hang_s=1.0)])
    with pytest.raises(ValueError, match="clock"):
        inj.fire("s")


def test_instrument_leaves_no_reference_cycle(dense):
    """An instrumented engine (instrumented twice, as a factory that wraps
    an already wrapped engine would) is freed by ``del`` alone: no cycle
    holds its pool and weights until the collector runs."""
    inj = FaultInjector([FaultSpec(site="decode", at=1)])
    eng = inj.instrument(inj.instrument(_engine(dense), "a"), "a")
    pool = weakref.ref(next(iter(eng.pool.leaves.values())))
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None and pool() is None
    finally:
        gc.enable()


# ==========================================================================
# retry: transient faults survived in place
# ==========================================================================

@pytest.mark.parametrize("site", ["step", "prefill", "decode"])
def test_transient_retry_token_parity(dense, site):
    """A transient fault at any injection site is retried in place and
    the greedy streams match a fault-free run token for token."""
    cfg, _ = dense
    requests = _requests(cfg, [4, 6, 5], seed=3)
    ref = _reference(dense, requests)

    clk = FaultClock()
    inj = FaultInjector([FaultSpec(site=site, target="a", at=2,
                                   kind="transient")], clock=clk)
    router = EngineRouter(
        [EngineReplica("a", inj.instrument(_engine(dense, 4), "a"))],
        clock=clk, sleep=clk.advance,
        retry=RetryPolicy(max_retries=2, backoff_s=0.01, seed=0))
    out = router.serve(requests)
    assert [out[t] for t in sorted(out)] == ref
    assert router.counters["retries"] == 1
    assert router.counters["replicas_quarantined"] == 0
    assert all(router.tickets[t].status == cl.COMPLETED for t in out)


def test_retry_exhaustion_quarantines(dense):
    """A fault that keeps firing past max_retries condemns the replica;
    requests requeue onto the survivor and still complete."""
    cfg, _ = dense
    requests = _requests(cfg, [4, 5], seed=4)
    ref = _reference(dense, requests)
    clk = FaultClock()
    inj = FaultInjector([FaultSpec(site="step", target="sick", at=2,
                                   kind="transient", repeat=True)],
                        clock=clk)
    router = EngineRouter(
        [EngineReplica("sick", inj.instrument(_engine(dense), "sick")),
         EngineReplica("ok", _engine(dense))],
        clock=clk, sleep=clk.advance,
        retry=RetryPolicy(max_retries=2, backoff_s=0.01, seed=0))
    out = router.serve(requests)
    assert [out[t] for t in sorted(out)] == ref
    assert router.counters["retries"] == 2
    assert router.counters["replicas_quarantined"] == 1
    sick = router._by_name["sick"]
    assert not sick.healthy
    assert classify_failure(sick.fault) == "transient"   # what killed it


# ==========================================================================
# quarantine -> probe -> re-admission
# ==========================================================================

def _healing_router(dense, *, specs, clk, n_slots=2, health=None,
                    names=("bad", "ok")):
    inj = FaultInjector(specs, clock=clk)
    make = lambda: _engine(dense, n_slots)  # noqa: E731
    replicas = [
        EngineReplica(names[0], inj.instrument(make(), names[0]),
                      factory=make),
        EngineReplica(names[1], make(), factory=make),
    ]
    router = EngineRouter(
        replicas, clock=clk, sleep=clk.advance,
        retry=RetryPolicy(max_retries=1, backoff_s=0.01, seed=0),
        health=health or HealthConfig(probe_interval_s=1.0,
                                      probes_to_readmit=2, max_probes=4,
                                      watchdog_s=5.0))
    return router, inj


def test_quarantine_probe_readmit_roundtrip(dense):
    """A fatally-faulted replica is quarantined, health-probed on the
    clock, re-admitted with a warm-restarted engine, and serves new
    traffic again."""
    cfg, _ = dense
    requests = _requests(cfg, [4, 5, 6], seed=5)
    ref = _reference(dense, requests)
    clk = FaultClock()
    router, _ = _healing_router(dense, clk=clk, specs=[
        FaultSpec(site="step", target="bad", at=2, kind="fatal")])
    out = router.serve(requests)
    assert [out[t] for t in sorted(out)] == ref
    bad = router._by_name["bad"]
    assert not bad.healthy
    assert router.metrics().gauges["bad"]["probing"] == 1.0

    faulted_engine = bad.engine
    for _ in range(8):
        if bad.healthy:
            break
        clk.advance(1.0)
        router.step()
    assert bad.healthy and bad.restarts == 1
    assert bad.engine is not faulted_engine          # the warm restart
    assert router.counters["replicas_readmitted"] == 1
    assert router.counters["probes"] == 2            # 2 passes to readmit
    assert router.metrics().gauges["bad"]["probing"] == 0.0

    # the re-admitted replica takes traffic again (fresh engine: clean)
    wave2 = _requests(cfg, [4, 4, 4, 4], seed=6)
    out2 = router.serve(wave2)
    assert all(router.tickets[t].status == cl.COMPLETED for t in out2)
    assert bad.engine.metrics.tokens_generated > 0


def test_watchdog_hang_quarantines(dense):
    """A step consuming more than watchdog_s of router-clock time is
    declared hung; the replica is quarantined, not stepped forever."""
    cfg, _ = dense
    requests = _requests(cfg, [4, 5], seed=7)
    ref = _reference(dense, requests)
    clk = FaultClock()
    router, _ = _healing_router(dense, clk=clk, specs=[
        FaultSpec(site="step", target="bad", at=2, kind="hang",
                  hang_s=9.0)])
    out = router.serve(requests)
    assert [out[t] for t in sorted(out)] == ref
    bad = router._by_name["bad"]
    assert not bad.healthy
    assert isinstance(bad.fault, ReplicaHungError)
    assert router.counters["replicas_quarantined"] == 1


def test_hang_under_watchdog_is_tolerated(dense):
    """A slow-but-under-deadline step is not a hang."""
    cfg, _ = dense
    clk = FaultClock()
    router, _ = _healing_router(dense, clk=clk, specs=[
        FaultSpec(site="step", target="bad", at=2, kind="hang",
                  hang_s=2.0)])
    out = router.serve(_requests(cfg, [4, 5], seed=8))
    assert all(router.tickets[t].status == cl.COMPLETED for t in out)
    assert router.counters["replicas_quarantined"] == 0


def test_hard_down_cluster_parks_then_recovers(dense):
    """Losing the last replica with health enabled parks the in-flight
    requests; the probe loop re-admits and they complete — serve() runs
    the whole outage end-to-end on the injected clock."""
    cfg, _ = dense
    requests = _requests(cfg, [4, 6], seed=9)
    ref = _reference(dense, requests)
    clk = FaultClock()
    inj = FaultInjector([FaultSpec(site="step", target="only", at=2,
                                   kind="fatal")], clock=clk)
    make = lambda: _engine(dense)  # noqa: E731
    router = EngineRouter(
        [EngineReplica("only", inj.instrument(make(), "only"),
                       factory=make)],
        clock=clk, sleep=clk.advance,
        health=HealthConfig(probe_interval_s=1.0, probes_to_readmit=1,
                            max_probes=4))
    out = router.serve(requests)
    assert [out[t] for t in sorted(out)] == ref
    assert all(router.tickets[t].status == cl.COMPLETED for t in out)
    assert router.counters["replicas_readmitted"] == 1
    assert router.counters["requests_requeued"] == 2


def test_probe_exhaustion_retires_and_fails_parked(dense):
    """When every probe fails, the replica retires permanently and
    parked requests resolve ``failed`` — the driver loop terminates."""
    cfg, _ = dense
    clk = FaultClock()
    inj = FaultInjector([FaultSpec(site="step", target="only", at=2,
                                   kind="fatal")], clock=clk)

    def broken_factory():
        raise RuntimeError("restart failed")

    router = EngineRouter(
        [EngineReplica("only", inj.instrument(_engine(dense), "only"),
                       factory=broken_factory)],
        clock=clk, sleep=clk.advance,
        health=HealthConfig(probe_interval_s=1.0, probes_to_readmit=1,
                            max_probes=2))
    out = router.serve(_requests(cfg, [4, 6], seed=10))
    assert all(router.tickets[t].status == cl.FAILED for t in out)
    only = router._by_name["only"]
    assert only.retired and not only.healthy
    assert router.counters["probe_failures"] == 2
    assert not router.has_work()


def test_no_health_preserves_legacy_last_replica_raise(dense):
    """Without health=, the last replica's death still fails tickets and
    propagates."""
    cfg, _ = dense
    eng = _engine(dense)
    orig = eng.step
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("boom")
        return orig()
    eng.step = flaky
    router = EngineRouter([EngineReplica("a", eng)])
    tid = router.submit(Request(prompt=_prompts(cfg, [4])[0],
                                max_tokens=4, stop_tokens=()))
    with pytest.raises(RuntimeError, match="no survivors"):
        while router.has_work():
            router.step()
    assert router.tickets[tid].status == cl.FAILED


# ==========================================================================
# graceful degradation + metrics
# ==========================================================================

def test_degraded_tier_routing_counted(dense):
    """Tier-affinity requests cross tiers when the tier has no healthy
    replica — flagged on the ticket and counted, not silent."""
    cfg, _ = dense
    clk = FaultClock()
    inj = FaultInjector([FaultSpec(site="step", target="gold", at=1,
                                   kind="fatal")], clock=clk)
    router = EngineRouter(
        [EngineReplica("gold", inj.instrument(_engine(dense), "gold"),
                       tier="fp32"),
         EngineReplica("base", _engine(dense), tier="bf16")],
        clock=clk, sleep=clk.advance)
    reqs = _requests(cfg, [4, 5], seed=11)
    t0 = router.submit(reqs[0], tier="fp32")     # lands on gold, requeues
    while router.has_work():
        router.step()
    t1 = router.submit(reqs[1], tier="fp32")     # gold is gone: degrades
    while router.has_work():
        router.step()
    assert router.tickets[t0].status == cl.COMPLETED
    assert router.tickets[t1].status == cl.COMPLETED
    assert router.tickets[t1].replica.name == "base"
    assert router.tickets[t1].degraded
    assert router.counters["requests_degraded"] >= 1


def test_self_healing_metrics_exposition(dense):
    """The new counters and per-replica gauges render as Prometheus
    families with their own HELP text."""
    cfg, _ = dense
    clk = FaultClock()
    router, _ = _healing_router(dense, clk=clk, specs=[
        FaultSpec(site="step", target="bad", at=2, kind="fatal")])
    router.serve(_requests(cfg, [4, 5], seed=12))
    text = router.metrics().to_prometheus()
    for family in ("repro_serve_retries_total",
                   "repro_serve_replicas_readmitted_total",
                   "repro_serve_probe_failures_total",
                   "repro_serve_requests_degraded_total"):
        assert f"# TYPE {family} counter" in text
    assert 'repro_serve_healthy{replica="bad"} 0' in text
    assert 'repro_serve_probing{replica="bad"} 1' in text
    assert "under health probes" in text       # family-specific HELP


# ==========================================================================
# held against the reference: a self-healing scenario
# ==========================================================================

def _untimed(text):
    """The serving families of an exposition (the process-wide dispatch
    telemetry, whose backends differ between the packages, apart), less
    the samples whose values are wall-clock times."""
    out = []
    for line in text.splitlines():
        name = (line.split()[2] if line.startswith("#")
                else line.split("{")[0].split()[0])
        if name.startswith("repro_serve_") and (
                line.startswith("#") or "second" not in name):
            out.append(line)
    return out


def healing_scenario(S, make, cfg):
    """Three replicas with factories under health checks on one clock: a
    transient fault at r0's first prefill and at r1's second decode
    (retried in place), a fatal fault at r2's second step and a hang past
    the watchdog at r1's fourth (each quarantines its replica, which is
    probed, warm-restarted and re-admitted), then a second wave on the
    healed cluster."""
    clk = S.FaultClock()
    inj = S.FaultInjector([
        S.FaultSpec(site="prefill", target="r0", at=1, kind="transient"),
        S.FaultSpec(site="decode", target="r1", at=2, kind="transient"),
        S.FaultSpec(site="step", target="r2", at=2, kind="fatal"),
        S.FaultSpec(site="step", target="r1", at=4, kind="hang",
                    hang_s=10.0),
    ], clock=clk)
    router = S.EngineRouter(
        [S.EngineReplica(name, inj.instrument(make(), name), factory=make)
         for name in ("r0", "r1", "r2")],
        clock=clk, sleep=clk.advance,
        retry=S.RetryPolicy(max_retries=2, backoff_s=0.01, seed=0),
        health=S.HealthConfig(probe_interval_s=1.0, probes_to_readmit=2,
                              max_probes=8, watchdog_s=5.0))
    prompts = _prompts(cfg, [4, 6, 3, 7, 5, 4, 6], seed=30)
    router.serve([S.Request(prompt=p, max_tokens=3 + i % 3, stop_tokens=())
                  for i, p in enumerate(prompts)])
    for _ in range(16):
        if all(r.healthy for r in router.replicas):
            break
        clk.advance(1.0)
        router.step()
    router.serve([S.Request(prompt=p, max_tokens=3, stop_tokens=())
                  for p in prompts[:4]])
    return {
        "tickets": [(t.ticket_id, t.status, t.finish_reason, list(t.tokens),
                     t.replica.name, t.attempts, t.degraded)
                    for t in sorted(router.tickets.values(),
                                    key=lambda t: t.ticket_id)],
        "fired": list(inj.fired),
        "counters": dict(router.counters),
        "exposition": _untimed(router.metrics().to_prometheus()),
        "restarts": [r.restarts for r in router.replicas],
    }


@pytest.fixture(scope="module")
def healing(pair):
    jcfg, jparams, cfg, params = pair

    def jengine():
        return jserve.ContinuousEngine(
            jcfg, jparams, jserve.PoolConfig(n_slots=2, max_len=MAX_LEN))

    def tengine():
        return tserve.ContinuousEngine(
            cfg, params, tserve.PoolConfig(n_slots=2, max_len=MAX_LEN),
            device="cpu")
    return {"reference": healing_scenario(jserve, jengine, cfg),
            "port": healing_scenario(tserve, tengine, cfg)}


@pytest.mark.parametrize("aspect", ["tickets", "fired", "counters",
                                    "exposition", "restarts"])
def test_healing_scenario_matches_reference(healing, aspect):
    assert healing["port"][aspect] == healing["reference"][aspect]


def test_healing_scenario_exercises_every_path(healing, dense):
    got = healing["port"]
    assert got["fired"] == [("prefill", "r0", 1, "transient"),
                            ("decode", "r1", 2, "transient"),
                            ("step", "r2", 2, "fatal"),
                            ("step", "r1", 4, "hang")]
    c = got["counters"]
    assert c["retries"] == 2
    assert c["replicas_quarantined"] == 2 and c["replicas_readmitted"] == 2
    assert c["requests_requeued"] >= 1
    assert got["restarts"] == [0, 1, 1]
    assert all(t[1] == cl.COMPLETED for t in got["tickets"])
    # greedy streams equal a fault-free run's
    cfg, _ = dense
    prompts = _prompts(cfg, [4, 6, 3, 7, 5, 4, 6], seed=30)
    ref = _reference(dense, [Request(prompt=p, max_tokens=3 + i % 3,
                                     stop_tokens=())
                             for i, p in enumerate(prompts)])
    assert [t[3] for t in got["tickets"][:len(prompts)]] == ref


# ==========================================================================
# tuning-cache hardening
# ==========================================================================

@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    path = tmp_path / "tuning.json"
    monkeypatch.setenv(dispatch.TUNING_CACHE_ENV, str(path))
    dispatch.clear_tuning_cache()
    yield str(path)
    dispatch.clear_tuning_cache()


def _resolve(dtype=torch.float32):
    return dispatch.resolve_blocks("matmul", 64, 64, 64, dtype,
                                   backend="cuda")


@pytest.mark.parametrize("mode", ["garbage", "truncate", "unknown"])
def test_corrupt_cache_falls_back_to_heuristics(cache_env, mode):
    """A corrupt REPRO_TORCH_TUNING_CACHE warns and degrades to heuristic
    plans instead of failing the first resolve."""
    _resolve()                                   # seeds a valid file
    assert json.load(open(cache_env))["entries"]
    dispatch.clear_tuning_cache()
    FaultInjector.corrupt_cache(cache_env, mode)
    with pytest.warns(UserWarning, match="corrupt tuning cache"):
        plan = _resolve()
    assert plan is not None
    assert dispatch.cache_load_errors() == 1
    # and the next write-through atomically replaces the corrupt file
    dispatch.save_cache(cache_env)
    assert isinstance(json.load(open(cache_env))["entries"], list)


def test_strict_load_cache_still_raises(cache_env):
    FaultInjector.corrupt_cache(cache_env, "garbage")
    with pytest.raises(ValueError):
        dispatch.load_cache(cache_env)           # explicit call: strict
    assert dispatch.load_cache(cache_env, strict=False) == 0
    assert dispatch.cache_load_errors() == 2
    # junk entries inside a valid wrapper are skipped, not fatal
    with open(cache_env, "w") as f:
        json.dump({"version": 1, "entries": ["junk", 7]}, f)
    assert dispatch.load_cache(cache_env) == 0


def test_save_cache_survives_junk_prior_entries(cache_env):
    """save_cache merges over a file with unrecognizable entries by
    dropping them instead of raising mid-write."""
    _resolve()
    with open(cache_env, "w") as f:
        json.dump({"version": 1, "entries": [{"nonsense": True}, "x"]}, f)
    assert dispatch.save_cache(cache_env) >= 1
    data = json.load(open(cache_env))
    assert all(isinstance(e, dict) and "op" in e for e in data["entries"])


# ==========================================================================
# frontend stop/submit race
# ==========================================================================

def test_frontend_abort_resolves_inflight_submit(dense):
    """A submit racing stop(drain=False) resolves terminally — the
    awaiter never hangs on a command in a dead inbox."""
    cfg, _ = dense
    router = EngineRouter([EngineReplica("a", _engine(dense))])
    req = Request(prompt=_prompts(cfg, [4])[0], max_tokens=16,
                  stop_tokens=())

    async def main():
        frontend = AsyncFrontend(router)
        await frontend.start()
        # submit lands in the inbox; stop(drain=False) lands right after,
        # before the loop has stepped either
        handle = await frontend.submit(req)
        stop = asyncio.create_task(frontend.stop(drain=False))
        result = await asyncio.wait_for(handle, timeout=10)
        await asyncio.wait_for(stop, timeout=10)
        assert result.status in (cl.CANCELLED, cl.COMPLETED)

        # and a submit issued *while* aborting resolves immediately
        await frontend.start()
        stop = asyncio.create_task(frontend.stop(drain=False))
        await asyncio.sleep(0)                   # let stop set the flag
        late = await frontend.submit(req)
        late_result = await asyncio.wait_for(late, timeout=10)
        await asyncio.wait_for(stop, timeout=10)
        assert late_result.status == cl.CANCELLED
        assert late_result.tokens == []
    asyncio.run(main())


# ==========================================================================
# runtime alias
# ==========================================================================

def test_runtime_package_exports():
    from repro_torch import runtime
    from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
    assert runtime.HeartbeatMonitor is HeartbeatMonitor
    assert hasattr(runtime, "StragglerDetector")
    assert hasattr(runtime, "run_with_restarts")

"""The port's multi-replica router and asyncio front end, against the JAX
package's.

Every case of ``tests/test_serve_cluster.py`` runs on the port: router
balancing and tier affinity, admission control (bounded backlog -> reject
/ shed), per-request deadlines freeing slots mid-flight, replica-failure
requeue, the Prometheus export, and the asyncio front end (streaming
parity with the sync engine, cancellation, timeout, rejection).  Two
scenarios also run through ``repro.serve`` on the same inputs (reduced
smollm-135m in fp32, the reference's weights from ``PRNGKey(0)`` carried
over by ``interop``, the same requests, fault schedule and clock) and are
held to it exactly: each request's tokens, status and replica, the fired
faults, the router's counters and the exposition text (samples whose
values are wall-clock times aside).
"""
import asyncio

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import api as japi
from repro_torch import configs, interop
from repro_torch import serve as tserve
from repro_torch.serve import (
    AsyncFrontend,
    ClusterMetrics,
    ContinuousEngine,
    EngineReplica,
    EngineRouter,
    PoolConfig,
    Request,
)
from repro_torch.serve import cluster as cl

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


def _fail_after(engine, n_calls):
    """Make engine.step() raise on its ``n_calls``-th invocation."""
    orig, calls = engine.step, [0]

    def flaky():
        calls[0] += 1
        if calls[0] == n_calls:
            raise RuntimeError("injected replica fault")
        return orig()
    engine.step = flaky


# ==========================================================================
# routing
# ==========================================================================

def test_router_validation(dense):
    with pytest.raises(ValueError, match="at least one"):
        EngineRouter([])
    eng = _engine(dense, n_slots=1)
    with pytest.raises(ValueError, match="duplicate"):
        EngineRouter([EngineReplica("a", eng), EngineReplica("a", eng)])
    with pytest.raises(ValueError, match="admission"):
        EngineRouter([EngineReplica("a", eng)], admission="drop")


def test_least_depth_balancing(dense):
    """Submissions alternate across equally-loaded replicas, and the
    whole workload completes through both."""
    cfg, _ = dense
    router = EngineRouter([EngineReplica("a", _engine(dense)),
                           EngineReplica("b", _engine(dense))])
    prompts = _prompts(cfg, [4, 5, 6, 7], seed=1)
    ids = [router.submit(Request(prompt=p, max_tokens=3, stop_tokens=()))
           for p in prompts]
    placed = [router.tickets[t].replica.name for t in ids]
    assert placed == ["a", "b", "a", "b"]
    while router.has_work():
        router.step()
    assert all(router.tickets[t].status == cl.COMPLETED for t in ids)
    assert all(len(router.tickets[t].tokens) == 3 for t in ids)
    m = router.metrics()
    assert m.replicas["a"].tokens_generated > 0
    assert m.replicas["b"].tokens_generated > 0
    assert (ClusterMetrics.merge(m.replicas.values()).tokens_generated
            == 12)


def test_tier_affinity_prefers_matching_replica(dense):
    cfg, _ = dense
    router = EngineRouter([
        EngineReplica("fast", _engine(dense), tier="bf16"),
        EngineReplica("exact", _engine(dense), tier="fp32"),
    ])
    p = _prompts(cfg, [4], seed=2)[0]
    req = lambda: Request(prompt=p, max_tokens=2, stop_tokens=())  # noqa: E731
    # affinity wins even when the tier's replica is deeper
    for _ in range(3):
        tid = router.submit(req(), tier="fp32")
        assert router.tickets[tid].replica.name == "exact"
    # unknown tier falls back to least depth over all healthy replicas
    tid = router.submit(req(), tier="int4")
    assert router.tickets[tid].replica.name == "fast"


# ==========================================================================
# admission control
# ==========================================================================

def test_backpressure_reject(dense):
    """At the backlog bound the router rejects with a terminal status
    instead of queuing without bound."""
    cfg, _ = dense
    router = EngineRouter([EngineReplica("a", _engine(dense, n_slots=1))],
                          max_waiting=1)
    p = _prompts(cfg, [4], seed=3)[0]
    finishes = []
    ids = [router.submit(Request(prompt=p, max_tokens=2, stop_tokens=()),
                         on_finish=lambda t: finishes.append(
                             (t.ticket_id, t.status)))
           for _ in range(4)]
    # slot capacity 1 + backlog bound 1 => two admitted, two rejected
    statuses = [router.tickets[t].status for t in ids]
    assert statuses == [None, None, cl.REJECTED, cl.REJECTED]
    assert finishes == [(ids[2], cl.REJECTED), (ids[3], cl.REJECTED)]
    assert router.counters["requests_rejected"] == 2
    while router.has_work():
        router.step()
    assert [router.tickets[t].status for t in ids[:2]] == [cl.COMPLETED] * 2
    assert router.tickets[ids[2]].tokens == []


def test_backpressure_shed_lowest_priority(dense):
    """admission="shed": a saturated router evicts the lowest-priority
    waiting request for a higher-priority newcomer, and sheds the
    newcomer itself when nothing waiting is lower."""
    cfg, _ = dense
    router = EngineRouter([EngineReplica("a", _engine(dense, n_slots=1))],
                          max_waiting=1, admission="shed")
    p = _prompts(cfg, [4], seed=4)[0]

    def req(prio):
        return Request(prompt=p, max_tokens=2, stop_tokens=(),
                       priority=prio)

    a = router.submit(req(1.0))
    b = router.submit(req(1.0))
    # equal priority: the newcomer is shed, queued work survives
    c = router.submit(req(1.0))
    assert router.tickets[c].status == cl.SHED
    # higher priority: the lowest-priority (and newest among ties)
    # waiting request is shed to make room
    d = router.submit(req(5.0))
    assert router.tickets[b].status == cl.SHED
    assert router.tickets[d].status is None
    assert router.counters["requests_shed"] == 2
    while router.has_work():
        router.step()
    assert router.tickets[a].status == cl.COMPLETED
    assert router.tickets[d].status == cl.COMPLETED


# ==========================================================================
# deadlines
# ==========================================================================

def test_deadline_expiry_frees_slot(dense):
    """A request past its deadline is cancelled mid-flight: its KV slot
    frees the same step and the next request runs on it."""
    cfg, _ = dense
    eng = _engine(dense, n_slots=1)
    clk = {"t": 0.0}
    router = EngineRouter([EngineReplica("a", eng)],
                          clock=lambda: clk["t"])
    p = _prompts(cfg, [4], seed=5)[0]
    tid = router.submit(Request(prompt=p, max_tokens=20, stop_tokens=()),
                        deadline_s=5.0)
    router.step()
    assert eng.scheduler.n_running == 1
    ticket = router.tickets[tid]
    assert ticket.status is None and len(ticket.tokens) >= 1

    clk["t"] = 10.0
    router.step()
    assert ticket.status == cl.TIMEOUT
    assert eng.pool.n_free == 1                     # slot freed mid-flight
    assert not router.has_work()
    assert router.counters["requests_timeout"] == 1
    assert eng.metrics.requests_cancelled == 1

    tid2 = router.submit(Request(prompt=p, max_tokens=2, stop_tokens=()))
    while router.has_work():
        router.step()
    assert router.tickets[tid2].status == cl.COMPLETED
    assert len(router.tickets[tid2].tokens) == 2


# ==========================================================================
# replica faults
# ==========================================================================

def test_replica_failure_requeues_and_completes(dense):
    """A replica whose step() raises is quarantined; its in-flight
    requests (waiting and mid-generation) requeue onto the survivor and
    every request completes with the single-engine greedy output —
    streamed without duplicating the prefix emitted before the fault."""
    cfg, _ = dense
    prompts = _prompts(cfg, [4, 6, 3, 7, 5, 4], seed=6)
    reqs = [Request(prompt=p, max_tokens=4, stop_tokens=())
            for p in prompts]
    reference = _engine(dense).serve(
        [Request(prompt=p, max_tokens=4, stop_tokens=())
         for p in prompts])

    flaky = _engine(dense)
    _fail_after(flaky, 2)
    router = EngineRouter([EngineReplica("a", _engine(dense)),
                           EngineReplica("b", flaky)])
    streams: dict[int, list] = {}
    ids = [router.submit(r, on_token=lambda tid, tok, fin:
                         streams.setdefault(tid, []).append(tok))
           for r in reqs]
    while router.has_work():
        router.step()

    assert router.counters["replicas_quarantined"] == 1
    assert router.counters["requests_requeued"] >= 1
    assert [r.name for r in router.healthy_replicas()] == ["a"]
    assert not router.replicas[1].healthy
    assert isinstance(router.replicas[1].fault, RuntimeError)
    for i, tid in enumerate(ids):
        t = router.tickets[tid]
        assert t.status == cl.COMPLETED
        assert t.finish_reason == "length"
        assert t.tokens == streams[tid] == reference[i], \
            f"request {i} diverged after requeue"


def test_last_replica_failure_fails_tickets_and_raises(dense):
    cfg, _ = dense
    eng = _engine(dense, n_slots=1)
    _fail_after(eng, 1)
    router = EngineRouter([EngineReplica("a", eng)])
    p = _prompts(cfg, [4], seed=7)[0]
    tid = router.submit(Request(prompt=p, max_tokens=2, stop_tokens=()))
    with pytest.raises(RuntimeError, match="no survivors"):
        router.step()
    assert router.tickets[tid].status == cl.FAILED
    assert not router.has_work()


# ==========================================================================
# metrics export
# ==========================================================================

def test_prometheus_export_and_merge(dense):
    cfg, _ = dense
    router = EngineRouter([EngineReplica("r0", _engine(dense)),
                           EngineReplica("r1", _engine(dense))])
    prompts = _prompts(cfg, [4, 5, 6], seed=8)
    out = router.serve([Request(prompt=p, max_tokens=3, stop_tokens=())
                        for p in prompts])
    assert all(len(v) == 3 for v in out.values())
    for t in router.tickets.values():
        assert t.ttft_s is not None and t.ttft_s >= 0

    cm = router.metrics()
    text = cm.to_prometheus()
    for family in ("occupancy", "queue_depth", "tokens_per_second",
                   "ttft_seconds_mean"):
        for name in ("r0", "r1"):
            assert f'repro_serve_{family}{{replica="{name}"}}' in text, \
                (family, name, text)
    assert '# TYPE repro_serve_tokens_generated_total counter' in text
    assert text.count("# TYPE repro_serve_occupancy gauge") == 1
    assert "repro_serve_requests_rejected_total 0" in text
    assert 'repro_serve_healthy{replica="r0"} 1' in text

    merged = cm.aggregate()
    assert merged.tokens_generated == 9
    assert merged.requests_completed == 3
    assert merged.max_queue_depth == max(
        m.max_queue_depth for m in cm.replicas.values())
    assert merged.ttft_s_sum == pytest.approx(
        sum(m.ttft_s_sum for m in cm.replicas.values()))


# ==========================================================================
# asyncio front-end
# ==========================================================================

def test_async_streaming_matches_sync_token_for_token(dense):
    """Tokens streamed through AsyncFrontend equal the sync engine's
    serve() outputs exactly, per request and in order."""
    cfg, _ = dense
    prompts = _prompts(cfg, [4, 7, 3, 6], seed=9)
    mts = [5, 3, 4, 2]
    reference = _engine(dense).serve(
        [Request(prompt=p, max_tokens=mt, stop_tokens=())
         for p, mt in zip(prompts, mts)])
    router = EngineRouter([EngineReplica("a", _engine(dense))])

    async def main():
        async with AsyncFrontend(router) as fe:
            handles = [await fe.submit(
                Request(prompt=p, max_tokens=mt, stop_tokens=()))
                for p, mt in zip(prompts, mts)]

            async def collect(h):
                return [tok async for tok in h]

            streams = await asyncio.gather(*map(collect, handles))
            results = [await h for h in handles]
        return handles, streams, results

    handles, streams, results = asyncio.run(main())
    for i, (h, s, r) in enumerate(zip(handles, streams, results)):
        assert r.status == cl.COMPLETED
        assert r.finish_reason == "length"
        assert s == r.tokens == reference[i], f"request {i} diverged"
        assert h.done()


def test_async_two_replica_cluster_streams_concurrently(dense):
    """The front-end drives two replicas on different tiers; every
    request completes and lands on its preferred tier."""
    cfg, _ = dense
    router = EngineRouter([
        EngineReplica("bf16", _engine(dense), tier="bf16"),
        EngineReplica("fp32", _engine(dense), tier="fp32"),
    ])
    prompts = _prompts(cfg, [4, 5, 6, 7], seed=10)
    tiers = ["bf16", "fp32", "bf16", "fp32"]

    async def main():
        async with AsyncFrontend(router) as fe:
            handles = [await fe.submit(
                Request(prompt=p, max_tokens=3, stop_tokens=()), tier=t)
                for p, t in zip(prompts, tiers)]
            return [await h for h in handles]

    results = asyncio.run(main())
    assert all(r.status == cl.COMPLETED for r in results)
    assert all(len(r.tokens) == 3 for r in results)
    placed = [router.tickets[i].replica.name for i in range(len(tiers))]
    assert placed == tiers
    m = router.metrics()
    assert m.replicas["bf16"].tokens_generated == 6
    assert m.replicas["fp32"].tokens_generated == 6


def test_async_cancel_timeout_and_reject(dense):
    """Terminal statuses through the front-end: handle.cancel() resolves
    "cancelled" and frees the slot, deadline_s resolves "timeout", and
    admission control resolves "rejected" without raising."""
    cfg, _ = dense
    eng = _engine(dense, n_slots=1)
    router = EngineRouter([EngineReplica("a", eng)], max_waiting=1)
    p = _prompts(cfg, [4], seed=11)[0]

    async def main():
        async with AsyncFrontend(router) as fe:
            long1 = await fe.submit(Request(prompt=p, max_tokens=20,
                                            stop_tokens=()))
            # wait for its first token so long1 is pinned as running
            async for _ in long1:
                break
            # saturate the backlog (bound 1), then one too many
            long2 = await fe.submit(Request(prompt=p, max_tokens=20,
                                            stop_tokens=()))
            rejected = await fe.submit(Request(prompt=p, max_tokens=2,
                                               stop_tokens=()))
            r_rej = await rejected
            # free the backlog, then arm a deadline already in the past:
            # it expires on the next sweep without generating a token
            await long2.cancel()
            r2 = await long2
            timed = await fe.submit(Request(prompt=p, max_tokens=20,
                                            stop_tokens=()),
                                    deadline_s=0.0)
            r_timed = await timed
            await long1.cancel()
            r1 = await long1
        return r_rej, r_timed, r1, r2

    r_rej, r_timed, r1, r2 = asyncio.run(main())
    assert r_rej.status == cl.REJECTED and r_rej.tokens == []
    assert r_timed.status == cl.TIMEOUT
    assert r1.status == cl.CANCELLED
    assert r2.status == cl.CANCELLED
    assert eng.pool.n_free == 1          # cancelled slots were freed
    assert not router.has_work()
    assert router.counters["requests_timeout"] == 1
    assert router.counters["requests_rejected"] == 1


def test_async_frontend_survives_replica_fault(dense):
    """An injected fault mid-service quarantines the replica; awaiting
    clients still get completed results for every request."""
    cfg, _ = dense
    flaky = _engine(dense)
    _fail_after(flaky, 2)
    router = EngineRouter([EngineReplica("a", _engine(dense)),
                           EngineReplica("b", flaky)])
    prompts = _prompts(cfg, [4, 6, 5, 3, 7, 4], seed=12)

    async def main():
        async with AsyncFrontend(router) as fe:
            handles = [await fe.submit(
                Request(prompt=p, max_tokens=4, stop_tokens=()))
                for p in prompts]
            return [await h for h in handles]

    results = asyncio.run(main())
    assert all(r.status == cl.COMPLETED for r in results)
    assert all(len(r.tokens) == 4 for r in results)
    assert router.counters["replicas_quarantined"] == 1
    assert router.counters["requests_requeued"] >= 1


def test_async_total_failure_resolves_failed(dense):
    """Losing the last replica resolves pending handles with "failed"
    (no hung awaits) and surfaces the fault on frontend.error."""
    cfg, _ = dense
    eng = _engine(dense, n_slots=1)
    _fail_after(eng, 1)
    router = EngineRouter([EngineReplica("a", eng)])
    p = _prompts(cfg, [4], seed=13)[0]

    async def main():
        fe = AsyncFrontend(router)
        await fe.start()
        handle = await fe.submit(Request(prompt=p, max_tokens=2,
                                         stop_tokens=()))
        result = await handle
        tokens = [t async for t in handle]
        await fe.stop()
        return fe, result, tokens

    fe, result, tokens = asyncio.run(main())
    assert result.status == cl.FAILED
    assert tokens == []
    assert isinstance(fe.error, RuntimeError)


# ==========================================================================
# held against the reference's router
# ==========================================================================

def _untimed(text):
    """The serving families of an exposition (the process-wide dispatch
    telemetry, whose backends differ between the packages, apart), less
    the samples whose values are wall-clock times."""
    out = []
    for line in text.splitlines():
        name = (line.split()[2] if line.startswith("#")
                else line.split("{")[0].split()[0])
        if not name.startswith("repro_serve_"):
            continue
        if not line.startswith("#") and "second" in name:
            continue
        out.append(line)
    return out


def outcome(router, injector=None):
    """What the comparison holds: every ticket's fate, the fired faults,
    the counters and the exposition."""
    return {
        "tickets": [(t.ticket_id, t.status, t.finish_reason, list(t.tokens),
                     t.replica.name if t.replica is not None else None,
                     t.attempts, t.degraded)
                    for t in sorted(router.tickets.values(),
                                    key=lambda t: t.ticket_id)],
        "fired": list(injector.fired) if injector is not None else [],
        "counters": dict(router.counters),
        "exposition": _untimed(router.metrics().to_prometheus()),
    }


def _sides(pair):
    """(serve package, engine factory) of the reference and of the port,
    on the same weights."""
    jcfg, jparams, cfg, params = pair

    def jengine(n_slots=2):
        return jserve.ContinuousEngine(
            jcfg, jparams, jserve.PoolConfig(n_slots=n_slots,
                                             max_len=MAX_LEN))

    def tengine(n_slots=2):
        return tserve.ContinuousEngine(
            cfg, params, tserve.PoolConfig(n_slots=n_slots, max_len=MAX_LEN),
            device="cpu")
    return {"reference": (jserve, jengine), "port": (tserve, tengine)}


def tier_scenario(S, make, cfg):
    """Least-depth routing with tier affinity: tiered requests prefer
    their tier's replica, an unknown tier and no tier spread by depth."""
    router = S.EngineRouter([S.EngineReplica("fast", make(), tier="bf16"),
                             S.EngineReplica("exact", make(), tier="fp32")])
    prompts = _prompts(cfg, [4, 5, 6, 7, 3, 5, 8], seed=20)
    tiers = ["fp32", None, "fp32", "int4", "bf16", None, "fp32"]
    router.serve([S.Request(prompt=p, max_tokens=2 + i % 3, stop_tokens=())
                  for i, p in enumerate(prompts)], tiers=tiers)
    return outcome(router)


def requeue_scenario(S, make, cfg):
    """A fatal fault on one replica's second step: it is quarantined and
    its waiting and running requests requeue onto the survivor."""
    clk = S.FaultClock()
    inj = S.FaultInjector([S.FaultSpec(site="step", target="b", at=2,
                                       kind="fatal")], clock=clk)
    router = S.EngineRouter([S.EngineReplica("a", make()),
                             S.EngineReplica("b", inj.instrument(make(),
                                                                 "b"))],
                            clock=clk, sleep=clk.advance)
    prompts = _prompts(cfg, [4, 6, 3, 7, 5, 4], seed=21)
    router.serve([S.Request(prompt=p, max_tokens=4, stop_tokens=())
                  for p in prompts])
    return outcome(router, inj)


SCENARIOS = {"tiers": tier_scenario, "requeue": requeue_scenario}


@pytest.fixture(scope="module")
def scenarios(pair):
    return {name: {side: run(S, make, pair[2])
                   for side, (S, make) in _sides(pair).items()}
            for name, run in SCENARIOS.items()}


@pytest.mark.parametrize("aspect", ["tickets", "fired", "counters",
                                    "exposition"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_matches_reference(scenarios, scenario, aspect):
    got = scenarios[scenario]
    assert got["port"][aspect] == got["reference"][aspect]


def test_scenarios_exercise_their_paths(scenarios):
    tiers = scenarios["tiers"]["port"]
    # by depth at submission: an untiered or unknown-tier request goes to
    # the shallower replica, a tiered one to its tier however deep
    assert [t[4] for t in tiers["tickets"]] == [
        "exact", "fast", "exact", "fast", "fast", "exact", "exact"]
    assert all(t[1] == cl.COMPLETED for t in tiers["tickets"])
    requeue = scenarios["requeue"]["port"]
    assert requeue["fired"] == [("step", "b", 2, "fatal")]
    assert requeue["counters"]["requests_requeued"] >= 2
    assert {t[4] for t in requeue["tickets"]} == {"a"}
    assert 'repro_serve_healthy{replica="b"} 0' in requeue["exposition"]

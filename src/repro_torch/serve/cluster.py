"""Multi-replica serving: request router, admission control, deadlines,
and replica fault handling.

The port of ``repro/serve/cluster.py``, the same policies and decisions.
``EngineRouter`` spreads traffic across N ``ContinuousEngine`` replicas,
each its own serving tier (own ``PoolConfig``, backend, block policy,
quant tiers: e.g. a bf16 replica next to a ``decode_quant="int8"`` one;
a replica's tier is its engine's own arguments, which
``ContinuousEngine.step`` enters itself, so no context the caller holds
is needed where the router steps).  The router stays pure host-side
orchestration: it never touches device state, it only drives each
replica's ``submit()/step()/cancel()``.

Routing.  ``policy(replicas, request) -> replica`` picks among the
healthy candidates; the default is least queue depth (queued + running,
stable over replica order for ties).  A request may name a ``tier``:
replicas with that tier label are preferred, and the policy falls back to
all healthy replicas when none match (tier affinity is a preference, not
a partition).

Admission control.  ``max_waiting`` bounds the cluster-wide *backlog* —
requests queued beyond the slots currently free.  At the bound, the
router either rejects the newcomer (``admission="reject"``, terminal
status ``"rejected"``) or sheds the lowest-priority waiting request to
make room (``admission="shed"``; the newcomer itself is shed when nothing
waiting has lower priority).  Either way the queue never grows without
bound.

Deadlines.  ``submit(deadline_s=...)`` arms a per-request wall-clock
deadline (router clock, injectable for tests).  ``step()`` sweeps expired
requests first: a timed-out request is cancelled *mid-flight* — its KV
slot frees the same step (``ContinuousEngine.cancel``) — and resolves
with status ``"timeout"``.

Fault handling.  A replica step failure is first *classified*
(``serve.health.classify_failure``): transient failures are retried in
place — bounded attempts with exponential backoff + jitter
(``retry=RetryPolicy(...)``) — before the replica is condemned; a fatal
failure (or exhausted retries) quarantines the replica
(``healthy=False``, not stepped again) and every request it held —
waiting or mid-generation — is requeued onto the survivors.  Tokens the
request already streamed are not re-emitted: the requeued run skips that
prefix (greedy decoding regenerates it identically; sampled requests may
legitimately diverge from the dropped prefix).

Self-healing.  With ``health=HealthConfig(...)`` quarantine is no longer
forever: a per-step watchdog (``watchdog_s``, heartbeat check-ins on the
router clock) turns hangs into quarantines instead of a stuck cluster;
quarantined replicas with a ``factory`` get periodic health probes — a
canary generate through a warm-restarted engine — and are re-admitted
with that fresh engine after ``probes_to_readmit`` consecutive passes
(traffic drains back via the ordinary least-depth policy); ``max_probes``
consecutive failures retire a replica permanently.  When a tier loses
all matching replicas, tier-affinity requests *degrade* to any healthy
replica (counted in ``requests_degraded``, flagged on the ticket) rather
than silently; when the whole cluster is down, requests park awaiting a
re-admission if one is still possible, else resolve with status
``"failed"``.  Without ``health``, the last replica's death keeps the
legacy contract: stranded requests resolve ``"failed"`` and the fault
propagates.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

from repro_torch import obs
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.health import (
    ClusterHealth,
    HealthConfig,
    ReplicaHungError,
    ReplicaStragglerError,
    RetryPolicy,
    TRANSIENT,
    classify_failure,
)
from repro_torch.serve.metrics import ClusterMetrics
from repro_torch.serve.scheduler import Request

# terminal statuses a routed request can resolve with
COMPLETED = "completed"
CANCELLED = "cancelled"
TIMEOUT = "timeout"
REJECTED = "rejected"
SHED = "shed"
FAILED = "failed"


@dataclasses.dataclass
class EngineReplica:
    """One engine behind the router: a name, a tier label, health state.

    ``factory`` is the warm-restart hook — a zero-arg callable building a
    fresh engine of this replica's tier.  With router ``health`` enabled
    it is what makes re-admission possible: probes canary a fresh
    ``factory()`` engine, and on re-admission it replaces ``engine``.
    Replicas without a factory stay quarantined for good (and are retired
    immediately so drivers don't probe them forever).  ``restarts``
    counts successful re-admissions; ``retired`` marks a replica that
    exhausted its probe budget and will never rejoin.
    """
    name: str
    engine: ContinuousEngine
    tier: Optional[str] = None
    healthy: bool = True
    fault: Optional[BaseException] = None
    factory: Optional[Callable[[], ContinuousEngine]] = None
    restarts: int = 0
    retired: bool = False

    @property
    def load(self) -> int:
        """Queued + running requests (the routing signal)."""
        s = self.engine.scheduler
        return s.queue_depth + s.n_running

    @property
    def backlog(self) -> int:
        """Waiting requests beyond the slots currently free."""
        return max(0, self.engine.scheduler.queue_depth
                   - self.engine.pool.n_free)


def least_depth(replicas: Sequence[EngineReplica],
                request: Request) -> EngineReplica:
    """Default routing policy: the replica with the fewest queued+running
    requests; replica order breaks ties (min() is stable)."""
    return min(replicas, key=lambda r: r.load)


@dataclasses.dataclass
class ClusterRequest:
    """Router-side lifecycle of one request (its "ticket")."""
    ticket_id: int
    request: Request
    tier: Optional[str]
    deadline: Optional[float]            # absolute, router clock
    on_token: Optional[Callable]
    on_finish: Optional[Callable]
    replica: Optional[EngineReplica] = None
    local_id: Optional[int] = None       # request id inside the replica
    tokens: list = dataclasses.field(default_factory=list)
    status: Optional[str] = None         # terminal status, None while live
    finish_reason: Optional[str] = None  # "stop"/"length" or the status
    attempts: int = 0
    degraded: bool = False               # served off-tier (tier had no
                                         # healthy replica at dispatch)
    submit_time: float = 0.0
    first_token_time: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.status is not None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


class EngineRouter:
    """Route requests across engine replicas; see the module docstring.

    Drive it like one engine: ``submit()`` then ``step()`` until
    ``has_work()`` is False, or ``serve()`` for a whole batch.  ``step()``
    returns merged ``(ticket_id, token, finished)`` events across every
    replica stepped.
    """

    def __init__(self, replicas: Sequence[EngineReplica], *,
                 policy: Callable[..., EngineReplica] | None = None,
                 max_waiting: int | None = None,
                 admission: str = "reject",
                 priority_fn: Callable[[Request], float] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 retry: RetryPolicy | None = None,
                 health: HealthConfig | None = None,
                 trace_sample_rate: int | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        replicas = list(replicas)
        if not replicas:
            raise ValueError("EngineRouter needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        if admission not in ("reject", "shed"):
            raise ValueError(f"admission must be 'reject' or 'shed', "
                             f"got {admission!r}")
        self.replicas = replicas
        self.policy = policy or least_depth
        self.max_waiting = max_waiting
        self.admission = admission
        self.priority_fn = priority_fn or (lambda r: r.priority)
        self.clock = clock
        self.retry = retry
        self.health_cfg = health
        self.health = ClusterHealth(names, health) if health else None
        # sampled tracing: every Nth ticket gets the full span tree on its
        # replica (None => all); counters/events stay always-on.  Keyed on
        # the ticket id, so a requeued ticket keeps its sampling decision.
        self.trace_sample_rate = trace_sample_rate
        self.sleep = sleep
        self._by_name = {r.name: r for r in replicas}
        self.tickets: dict[int, ClusterRequest] = {}
        self._next_ticket = 0
        self._events: list = []
        self._pending: list[ClusterRequest] = []   # parked: cluster down,
                                                   # a re-admission pending
        self.counters = {"requests_rejected": 0, "requests_shed": 0,
                         "requests_timeout": 0, "requests_requeued": 0,
                         "requests_degraded": 0, "retries": 0,
                         "replicas_quarantined": 0,
                         "replicas_readmitted": 0,
                         "probes": 0, "probe_failures": 0}

    # ---------------- routing ----------------

    def healthy_replicas(self, tier: str | None = None
                         ) -> list[EngineReplica]:
        live = [r for r in self.replicas if r.healthy]
        if tier is not None:
            tiered = [r for r in live if r.tier == tier]
            if tiered:
                return tiered
        return live

    @property
    def total_backlog(self) -> int:
        return sum(r.backlog for r in self.replicas if r.healthy)

    # ---------------- submission / admission ----------------

    def submit(self, request: Request, *, tier: str | None = None,
               deadline_s: float | None = None,
               on_token: Callable | None = None,
               on_finish: Callable | None = None) -> int:
        """Route a request; returns its cluster-wide ticket id.

        ``on_token(ticket_id, token, finished)`` streams tokens exactly as
        ``ContinuousEngine.submit(on_token=)`` does, but survives a
        replica requeue (the re-run's duplicate prefix is suppressed).
        ``on_finish(ticket)`` fires once, on any terminal status —
        including a synchronous rejection inside this call.  Check
        ``router.tickets[tid].status`` after submitting: a rejected
        request is already terminal.
        """
        now = self.clock()
        ticket = ClusterRequest(
            ticket_id=self._next_ticket, request=request, tier=tier,
            deadline=None if deadline_s is None else now + deadline_s,
            on_token=on_token, on_finish=on_finish, submit_time=now)
        self._next_ticket += 1
        self.tickets[ticket.ticket_id] = ticket
        obs.event("router.submit", trace=f"t{ticket.ticket_id}",
                  tier=tier, deadline_s=deadline_s)
        if (self.max_waiting is not None
                and self.total_backlog >= self.max_waiting
                and not self._make_room(ticket)):
            return ticket.ticket_id
        self._dispatch(ticket)
        return ticket.ticket_id

    def _make_room(self, ticket: ClusterRequest) -> bool:
        """Admission control at a full backlog: reject the newcomer, or
        shed the lowest-priority waiting request to admit it."""
        if self.admission == "reject":
            self.counters["requests_rejected"] += 1
            self._finalize(ticket, REJECTED)
            return False
        waiting = [t for t in self.tickets.values()
                   if not t.done and t.replica is not None
                   and self._is_waiting(t)]
        # lowest priority loses; among equals, the newest submission
        # (shedding old FCFS work for an equal newcomer would churn)
        victim = min(waiting,
                     key=lambda t: (self.priority_fn(t.request),
                                    -t.ticket_id),
                     default=None)
        self.counters["requests_shed"] += 1
        if (victim is None
                or self.priority_fn(victim.request)
                >= self.priority_fn(ticket.request)):
            self._finalize(ticket, SHED)
            return False
        self._cancel_ticket(victim, SHED)
        return True

    def _is_waiting(self, ticket: ClusterRequest) -> bool:
        return any(s.request_id == ticket.local_id
                   for s in ticket.replica.engine.scheduler.waiting)

    def _may_recover(self) -> bool:
        """True while a quarantined replica could still be re-admitted."""
        return (self.health is not None
                and any(not r.healthy and not r.retired
                        and r.factory is not None for r in self.replicas))

    def _dispatch(self, ticket: ClusterRequest) -> None:
        live = [r for r in self.replicas if r.healthy]
        if not live:
            if self._may_recover():
                # cluster momentarily down: park until a probe re-admits
                # a replica (deadline sweeps still cover parked tickets)
                obs.event("router.park", trace=f"t{ticket.ticket_id}")
                self._pending.append(ticket)
                return
            self._finalize(ticket, FAILED)
            return
        if ticket.tier is not None:
            tiered = [r for r in live if r.tier == ticket.tier]
            if not tiered and not ticket.degraded:
                # tier affinity is a preference: record the degradation
                # instead of failing (or silently crossing tiers)
                ticket.degraded = True
                self.counters["requests_degraded"] += 1
                obs.event("router.degrade", trace=f"t{ticket.ticket_id}",
                          tier=ticket.tier)
            live = tiered or live
        replica = self.policy(live, ticket.request)
        ticket.attempts += 1
        ticket.replica = replica
        # the ticket id is the cluster-wide trace id: the same request
        # keeps it across requeues, so one trace follows it between
        # replicas (each dispatch is a fresh local request id).  An
        # unsampled ticket passes trace="" — the engine skips its spans
        # but keeps every counter.
        ticket.local_id = replica.engine.submit(
            ticket.request, on_token=self._bridge(ticket),
            trace=self._trace_arg(ticket))
        obs.event("router.dispatch", trace=f"t{ticket.ticket_id}",
                  replica=replica.name, attempt=ticket.attempts)

    def _trace_arg(self, ticket: ClusterRequest) -> str:
        rate = self.trace_sample_rate
        if rate is None or rate <= 1 or ticket.ticket_id % rate == 0:
            return f"t{ticket.ticket_id}"
        return ""

    def _bridge(self, ticket: ClusterRequest) -> Callable:
        """Per-dispatch engine callback: forwards the replica's token
        stream onto the ticket, skipping the prefix a previous dispatch
        already emitted (requeue after a replica fault)."""
        skip = len(ticket.tokens)
        seen = 0

        def cb(local_id: int, token: int, finished: bool) -> None:
            nonlocal seen
            seen += 1
            if seen > skip:
                if ticket.first_token_time is None:
                    ticket.first_token_time = self.clock()
                ticket.tokens.append(int(token))
                self._events.append((ticket.ticket_id, int(token),
                                     finished))
                if ticket.on_token is not None:
                    ticket.on_token(ticket.ticket_id, int(token), finished)
            if finished:
                state = ticket.replica.engine.scheduler.finished.get(
                    ticket.local_id)
                if state is not None:
                    ticket.finish_reason = state.finish_reason
                self._finalize(ticket, COMPLETED)
        return cb

    # ---------------- cancellation / resolution ----------------

    def cancel(self, ticket_id: int, *, status: str = CANCELLED) -> bool:
        """Cancel a live request (frees its KV slot the same step).
        Returns False when the id is unknown or already terminal."""
        ticket = self.tickets.get(ticket_id)
        if ticket is None or ticket.done:
            return False
        self._cancel_ticket(ticket, status)
        return True

    def _cancel_ticket(self, ticket: ClusterRequest, status: str) -> None:
        if ticket.replica is not None and ticket.local_id is not None:
            ticket.replica.engine.cancel(ticket.local_id)
        self._finalize(ticket, status)

    def _finalize(self, ticket: ClusterRequest, status: str) -> None:
        if ticket.done:
            return
        ticket.status = status
        if ticket.finish_reason is None:
            ticket.finish_reason = status
        obs.event("request.finish", trace=f"t{ticket.ticket_id}",
                  status=status, reason=ticket.finish_reason,
                  tokens=len(ticket.tokens), attempts=ticket.attempts,
                  ttft_s=ticket.ttft_s)
        if ticket.on_finish is not None:
            ticket.on_finish(ticket)

    # ---------------- the serving loop ----------------

    def step(self) -> list:
        """One cluster step: expire deadlines, run due health probes
        (re-admitting or retiring quarantined replicas), dispatch parked
        requests onto whatever is healthy, step every healthy replica
        with work (transient failures retried in place with backoff;
        fatal failures, watchdog hangs, and flagged stragglers
        quarantined, their in-flight requests requeued), and return the
        merged ``(ticket_id, token, finished)`` events."""
        self._events = []
        now = self.clock()
        for ticket in list(self.tickets.values()):
            if (not ticket.done and ticket.deadline is not None
                    and now >= ticket.deadline):
                self.counters["requests_timeout"] += 1
                obs.event("router.timeout", trace=f"t{ticket.ticket_id}")
                self._cancel_ticket(ticket, TIMEOUT)
        if self.health is not None:
            self._probe_sweep(now)
        if self._pending and any(r.healthy for r in self.replicas):
            pending, self._pending = self._pending, []
            for ticket in pending:
                if not ticket.done:
                    self._dispatch(ticket)
        durations: dict[str, float] = {}
        for replica in self.replicas:
            if not replica.healthy:
                continue
            if not replica.engine.has_work():
                if self.health is not None:   # idle check-in: not hung
                    self.health.beat(replica.name, self.clock())
                continue
            self._step_replica(replica, durations)
        if self.health is not None:
            for name in self.health.observe_durations(durations):
                replica = self._by_name[name]
                if replica.healthy:
                    self._quarantine(replica, ReplicaStragglerError(
                        f"replica {name!r} flagged as a straggler "
                        f"({self.health_cfg.straggler_factor}x median for "
                        f"{self.health_cfg.straggler_patience} steps)"))
        if (self.health is not None and self.health.probes
                and not any(r.healthy for r in self.replicas)):
            # hard-down but recoverable: advance to the next probe time
            # instead of busy-spinning serve() (with an injected
            # sleep=clock.advance this is what makes the loop progress)
            wait = (min(st.next_at for st in self.health.probes.values())
                    - self.clock())
            if wait > 0:
                self.sleep(wait)
        return self._events

    def _step_replica(self, replica: EngineReplica,
                      durations: dict[str, float]) -> None:
        """Step one replica: transient failures get bounded in-place
        retries with backoff before quarantine; each attempt checks in
        with the heartbeat monitor first, and the watchdog verdict is
        taken right after the attempt returns (beat at start, dead-host
        check at end = this step's duration against ``watchdog_s``) —
        per-replica, so one replica's stall cannot stale-out the beats
        of replicas stepped earlier in the same sweep."""
        attempts = 0
        while True:
            t0 = self.clock()
            if self.health is not None:
                self.health.beat(replica.name, t0,
                                 step=replica.engine.metrics.steps)
            try:
                replica.engine.step()
            except Exception as exc:
                if (classify_failure(exc) == TRANSIENT
                        and self.retry is not None
                        and attempts < self.retry.max_retries):
                    attempts += 1
                    self.counters["retries"] += 1
                    obs.event("router.retry", replica=replica.name,
                              attempt=attempts, error=type(exc).__name__)
                    self.sleep(self.retry.backoff(attempts))
                    continue
                self._quarantine(replica, exc)
                return
            now = self.clock()
            if (self.health is not None
                    and replica.name in self.health.hung(now)):
                self._quarantine(replica, ReplicaHungError(
                    f"replica {replica.name!r} step took {now - t0:.3f}s, "
                    f"over the {self.health_cfg.watchdog_s}s watchdog "
                    f"deadline"))
                return
            if self.health is not None:
                self.health.beat(replica.name, now,
                                 step=replica.engine.metrics.steps)
            durations[replica.name] = now - t0
            return

    def _quarantine(self, replica: EngineReplica,
                    exc: BaseException) -> None:
        replica.healthy = False
        replica.fault = exc
        self.counters["replicas_quarantined"] += 1
        obs.event("replica.quarantine", replica=replica.name,
                  error=type(exc).__name__)
        if (self.health is not None and replica.factory is not None
                and not replica.retired):
            self.health.on_quarantine(replica.name, self.clock())
        elif self.health is not None:
            replica.retired = True    # nothing to restart: never probed
        stranded = [t for t in self.tickets.values()
                    if not t.done and t.replica is replica]
        survivors = any(r.healthy for r in self.replicas)
        if not survivors and not self._may_recover():
            for ticket in stranded:
                self._finalize(ticket, FAILED)
            raise RuntimeError(
                f"replica {replica.name!r} failed with no survivors"
            ) from exc
        for ticket in stranded:
            self.counters["requests_requeued"] += 1
            obs.event("router.requeue", trace=f"t{ticket.ticket_id}",
                      replica=replica.name)
            if survivors:
                self._dispatch(ticket)
            else:
                ticket.replica = None
                ticket.local_id = None
                self._pending.append(ticket)

    # ---------------- health probes / re-admission ----------------

    def _probe_sweep(self, now: float) -> None:
        """Run due health probes: canary a warm-restarted engine; N
        consecutive passes re-admit the replica with it, ``max_probes``
        consecutive failures retire the replica.  When retirement kills
        the last possible recovery, parked requests resolve ``failed``."""
        for name in self.health.due_probes(now):
            replica = self._by_name[name]
            if replica.healthy or replica.retired:
                self.health.probes.pop(name, None)
                continue
            state = self.health.probes[name]
            self.counters["probes"] += 1
            if state.candidate is None:
                try:
                    state.candidate = replica.factory()
                except Exception:
                    state.candidate = None
            ok = (state.candidate is not None
                  and self._run_canary(state.candidate))
            candidate = state.candidate
            obs.event("router.probe", replica=name, ok=ok)
            if not ok:
                self.counters["probe_failures"] += 1
            verdict = self.health.record_probe(name, ok, self.clock())
            if verdict == "readmit":
                self._readmit(replica, candidate)
            elif verdict == "retired":
                replica.retired = True
        if (self._pending and not self._may_recover()
                and not any(r.healthy for r in self.replicas)):
            pending, self._pending = self._pending, []
            for ticket in pending:
                self._finalize(ticket, FAILED)

    def _run_canary(self, engine: ContinuousEngine) -> bool:
        """One greedy canary generate on the candidate engine (a single
        request, occupying one slot of its pool)."""
        cfg = self.health_cfg
        try:
            out = engine.serve([Request(prompt=list(cfg.canary_prompt),
                                        max_tokens=cfg.canary_tokens,
                                        stop_tokens=())])
        except Exception:
            return False
        return all(len(toks) >= 1 for toks in out.values())

    def _readmit(self, replica: EngineReplica,
                 engine: ContinuousEngine) -> None:
        replica.engine = engine        # the warm restart becomes live
        replica.healthy = True
        replica.fault = None
        replica.restarts += 1
        self.counters["replicas_readmitted"] += 1
        obs.event("replica.readmit", replica=replica.name,
                  restarts=replica.restarts)
        self.health.on_readmit(replica.name, self.clock())

    def has_work(self) -> bool:
        return (any(r.healthy and r.engine.has_work()
                    for r in self.replicas)
                or any(not t.done for t in self._pending))

    def serve(self, requests: Sequence[Request], *,
              tiers: Sequence[str | None] | None = None,
              deadline_s: float | None = None) -> dict[int, list[int]]:
        """Route ``requests`` and run the cluster to completion; returns
        ``{ticket_id: tokens}`` (empty list for rejected/shed/expired
        requests — check ``tickets[tid].status``)."""
        tiers = tiers if tiers is not None else [None] * len(requests)
        ids = [self.submit(r, tier=t, deadline_s=deadline_s)
               for r, t in zip(requests, tiers)]
        while self.has_work():
            self.step()
        return {tid: list(self.tickets[tid].tokens) for tid in ids}

    # ---------------- metrics ----------------

    def metrics(self) -> ClusterMetrics:
        """Live cluster metrics: per-replica ``ServeMetrics`` (aggregate
        with ``ClusterMetrics.merge``), instantaneous gauges, and the
        router's admission/fault counters."""
        return ClusterMetrics(
            replicas={r.name: r.engine.metrics for r in self.replicas},
            gauges={r.name: {
                "queue_depth": float(r.engine.scheduler.queue_depth),
                "running": float(r.engine.scheduler.n_running),
                "slots_free": float(r.engine.pool.n_free),
                "healthy": 1.0 if r.healthy else 0.0,
                "probing": 1.0 if (self.health is not None
                                   and self.health.is_probing(r.name))
                else 0.0,
                # pool gauges: slot occupancy always; page occupancy /
                # fragmentation / free pages when the replica is paged
                **r.engine.gauges(),
            } for r in self.replicas},
            counters=dict(self.counters))

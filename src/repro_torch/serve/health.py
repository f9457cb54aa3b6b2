"""Failure taxonomy, retry/backoff policy, and replica health tracking.

The port of ``repro/serve/health.py``, unchanged: host-side
bookkeeping (numpy for the seeded jitter, so a seed gives the reference's
backoff schedule).  This is the policy half of the self-healing serving
layer (the mechanism lives in ``serve.cluster.EngineRouter``).  Three
failure classes:

  * **transient** — a step failed but the replica is presumed fine
    (spurious dispatch error, recoverable backend hiccup).  Classified by
    :func:`classify_failure`; retried in place with exponential backoff +
    jitter (:class:`RetryPolicy`) before escalating to quarantine.
  * **fatal** — the replica itself is suspect (anything not transient).
    Quarantined immediately; in-flight requests requeue onto survivors.
  * **hang** — a step that never (or too slowly) returns.  Detected by a
    per-step watchdog deadline built on ``HeartbeatMonitor`` from
    ``repro_torch.runtime.fault_tolerance``: a replica checks in immediately
    before each step attempt, and the dead-host verdict is taken right
    after the attempt returns — so a step that consumed more than
    ``watchdog_s`` of router-clock time is declared hung and quarantined
    (:class:`ReplicaHungError`), per replica, without one stall staling
    out the beats of replicas stepped earlier in the same sweep.  With
    an injectable clock this is deterministic on CPU.

Quarantined replicas are not dead forever: :class:`ClusterHealth`
schedules periodic health probes (a canary generate through a fresh
engine from the replica's ``factory`` — a warm restart).  ``N``
consecutive probe passes re-admit the replica with that fresh engine;
``max_probes`` consecutive failures retire it permanently so drivers
terminate instead of probing a corpse forever.

``StragglerDetector`` (same module) optionally quarantines replicas that
are consistently ``straggler_factor``x slower than the per-step median —
at scale a straggling replica drags p99 TTFT for every request routed to
it, so it takes the same quarantine -> probe -> re-admit path as a fault.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 StragglerDetector)

TRANSIENT, FATAL = "transient", "fatal"


class TransientError(RuntimeError):
    """A step failure presumed not to implicate the replica itself.

    Any exception type carrying a truthy ``transient`` attribute is
    classified the same way, so backends can tag their own recoverable
    errors without importing the serving layer.
    """
    transient = True


class FatalError(RuntimeError):
    """A step failure that condemns the replica (quarantine, no retry)."""
    transient = False


class ReplicaHungError(FatalError):
    """A replica step exceeded the watchdog deadline."""


class ReplicaStragglerError(FatalError):
    """A replica was consistently slower than factor x the step median."""


def classify_failure(exc: BaseException) -> str:
    """``"transient"`` or ``"fatal"`` for a replica step failure.

    Transient iff the exception (or any in its ``__cause__`` chain)
    carries a truthy ``transient`` attribute; everything else — including
    garden-variety ``RuntimeError`` from a genuinely broken replica — is
    fatal.  Unknown failures defaulting to fatal is deliberate: wrongly
    retrying a corrupt replica duplicates work, wrongly quarantining a
    healthy one only costs a probe round-trip.
    """
    seen = 0
    while exc is not None and seen < 8:
        if getattr(exc, "transient", False):
            return TRANSIENT
        exc = exc.__cause__
        seen += 1
    return FATAL


@dataclasses.dataclass
class RetryPolicy:
    """Bounded in-place retry with exponential backoff + seeded jitter.

    ``backoff(attempt)`` (attempt is 1-based) returns
    ``min(backoff_s * mult**(attempt-1), max_backoff_s)`` scaled by a
    uniform jitter in ``[1-jitter, 1+jitter]`` — jitter decorrelates
    replica retries so a cluster-wide transient doesn't produce a
    synchronized retry stampede.  The jitter stream is seeded, so a fixed
    seed gives a reproducible backoff schedule in tests.
    """
    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.1
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def backoff(self, attempt: int) -> float:
        base = min(self.backoff_s * self.backoff_mult ** max(0, attempt - 1),
                   self.max_backoff_s)
        if not self.jitter:
            return base
        return base * (1.0 + self.jitter * float(self._rng.uniform(-1, 1)))


@dataclasses.dataclass
class HealthConfig:
    """Knobs for the quarantine -> probe -> re-admission lifecycle.

    ``watchdog_s`` arms the per-step hang watchdog (None disables).
    ``probe_interval_s`` spaces health probes on the router clock;
    ``probes_to_readmit`` consecutive canary passes re-admit a replica
    with the freshly-restarted engine; ``max_probes`` consecutive
    failures retire it permanently (None probes forever — only safe with
    real traffic deadlines).  The canary is a single greedy generate
    (``canary_prompt`` -> ``canary_tokens`` tokens) occupying one slot of
    the restarted engine's pool.  ``straggler_factor``/``patience``
    enable the straggler detector (None disables).
    """
    probe_interval_s: float = 1.0
    probes_to_readmit: int = 2
    max_probes: Optional[int] = 8
    canary_prompt: Sequence[int] = (1, 2, 3)
    canary_tokens: int = 2
    watchdog_s: Optional[float] = None
    straggler_factor: Optional[float] = None
    straggler_patience: int = 3


@dataclasses.dataclass
class ProbeState:
    """Per-quarantine probe bookkeeping for one replica."""
    next_at: float
    passes: int = 0
    probes_run: int = 0
    candidate: Any = None     # the warm-restarted engine under evaluation


class ClusterHealth:
    """Replica health tracker for one router.

    Wraps the seed-era fault-tolerance primitives for serving: a
    ``HeartbeatMonitor`` (one host per replica; a beat = "starting a step
    attempt now", so ``hung()`` after the sweep is exactly the per-step
    watchdog) and an optional ``StragglerDetector`` over per-step
    durations.  Probe scheduling is pure bookkeeping — the router owns
    the engines and runs the canaries.
    """

    def __init__(self, names: Sequence[str], cfg: HealthConfig):
        self.cfg = cfg
        self.names = list(names)
        self.index = {n: i for i, n in enumerate(self.names)}
        timeout = cfg.watchdog_s if cfg.watchdog_s is not None \
            else float("inf")
        self.monitor = HeartbeatMonitor(len(self.names), timeout_s=timeout)
        self.straggler = (
            StragglerDetector(len(self.names), factor=cfg.straggler_factor,
                              patience=cfg.straggler_patience)
            if cfg.straggler_factor is not None else None)
        self.probes: dict[str, ProbeState] = {}

    # ---------------- heartbeats / watchdog ----------------

    def beat(self, name: str, now: float, step: int = 0) -> None:
        """Check a replica in: it is alive and starting (or idling past)
        a step at ``now``."""
        self.monitor.beat(self.index[name], step, now=now)

    def hung(self, now: float) -> list[str]:
        """Replicas whose last check-in is older than the watchdog
        deadline — i.e. whose step attempt consumed more than
        ``watchdog_s`` of router-clock time.  (Quarantined replicas stop
        beating, so they linger here until ``on_readmit`` revives them —
        callers filter on replica health.)"""
        return [self.names[i] for i in self.monitor.dead_hosts(now=now)]

    def observe_durations(self, durations: dict[str, float]) -> list[str]:
        """Feed per-replica step durations; returns replicas flagged as
        stragglers (``patience`` consecutive over-threshold steps)."""
        if self.straggler is None or not durations:
            return []
        flagged = self.straggler.observe(
            {self.index[n]: d for n, d in durations.items()})
        return [self.names[i] for i in flagged]

    # ---------------- probe lifecycle ----------------

    def on_quarantine(self, name: str, now: float) -> None:
        self.probes[name] = ProbeState(
            next_at=now + self.cfg.probe_interval_s)

    def due_probes(self, now: float) -> list[str]:
        return [n for n, st in self.probes.items() if now >= st.next_at]

    def record_probe(self, name: str, ok: bool, now: float
                     ) -> Optional[str]:
        """Account one probe result.  Returns ``"readmit"`` when the
        replica has passed ``probes_to_readmit`` consecutive canaries,
        ``"retired"`` when it exhausted ``max_probes``, else None (probe
        again at ``next_at``)."""
        st = self.probes[name]
        st.probes_run += 1
        if ok:
            st.passes += 1
            if st.passes >= self.cfg.probes_to_readmit:
                return "readmit"
        else:
            st.passes = 0
            st.candidate = None   # a failed candidate is discarded
            if (self.cfg.max_probes is not None
                    and st.probes_run >= self.cfg.max_probes):
                self.probes.pop(name, None)
                return "retired"
        st.next_at = now + self.cfg.probe_interval_s
        return None

    def on_readmit(self, name: str, now: float) -> None:
        self.probes.pop(name, None)
        self.beat(name, now)      # revives the heartbeat host

    def is_probing(self, name: str) -> bool:
        return name in self.probes

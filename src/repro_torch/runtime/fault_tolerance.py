"""Fault-tolerance runtime: restart-from-latest, heartbeats, stragglers,
elastic rescale.

The port of ``repro/runtime/fault_tolerance.py``, unchanged (numpy only).

On a real cluster the coordinator runs per-host; here the same logic is
driven by a simulated host set so the policies are testable on CPU:

  * ``HeartbeatMonitor`` — hosts report (step, timestamp); a host silent for
    ``timeout_s`` is declared dead -> triggers restore-from-latest on a
    shrunken mesh (elastic rescale, see CheckpointManager.restore).
  * ``StragglerDetector`` — per-step durations; a host slower than
    ``factor`` x median for ``patience`` consecutive steps is flagged for
    eviction (at scale: replaced by a hot spare; the checkpoint/restore path
    is identical to failure recovery).
  * ``run_with_restarts`` — the training-driver wrapper: catches worker
    failure, restores the latest checkpoint, rebuilds the data stream at
    the restored step, and continues.

The serving stack reuses the first two for self-healing
(``repro_torch.serve.health``): one heartbeat host per engine replica — a
beat immediately before each step attempt makes ``dead_hosts`` the
per-step hang watchdog — and the straggler detector quarantines replicas
that drag cluster p99.  Import them via ``repro_torch.runtime``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class HostStatus:
    step: int = -1
    last_seen: float = 0.0
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, *, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.hosts = {i: HostStatus() for i in range(n_hosts)}

    def beat(self, host: int, step: int, now: float | None = None):
        now = time.monotonic() if now is None else now
        st = self.hosts[host]
        st.step, st.last_seen, st.alive = step, now, True

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        out = []
        for h, st in self.hosts.items():
            if st.alive and now - st.last_seen > self.timeout_s:
                st.alive = False
            if not st.alive:
                out.append(h)
        return out


class StragglerDetector:
    def __init__(self, n_hosts: int, *, factor: float = 2.0,
                 patience: int = 3):
        self.factor = factor
        self.patience = patience
        self.strikes = {i: 0 for i in range(n_hosts)}

    def observe(self, durations: dict[int, float]) -> list[int]:
        """durations: host -> step wall time. Returns flagged hosts."""
        med = float(np.median(list(durations.values())))
        flagged = []
        for h, d in durations.items():
            if d > self.factor * med:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.patience:
                flagged.append(h)
        return flagged


class WorkerFailure(RuntimeError):
    pass


def run_with_restarts(
    *,
    total_steps: int,
    ckpt,
    make_state: Callable[[], dict],
    step_fn: Callable[[dict, int], dict],
    save_every: int = 50,
    max_restarts: int = 10,
):
    """Generic driver: run step_fn with checkpoint/restart on failure.

    ``step_fn(state, step)`` may raise WorkerFailure (simulated or real);
    the driver restores the latest checkpoint and resumes.  Returns
    (final_state, n_restarts, steps_executed).
    """
    restarts = 0
    executed = 0
    state = make_state()
    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state, start = ckpt.restore(state, latest)
        start += 1

    step = start
    while step < total_steps:
        try:
            state = step_fn(state, step)
            executed += 1
            if step % save_every == 0:
                ckpt.save(step, state)
            step += 1
        except WorkerFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            latest = ckpt.latest_step()
            state = make_state()
            if latest is not None:
                state, restored_step = ckpt.restore(state, latest)
                step = restored_step + 1
            else:
                step = 0
    return state, restarts, executed

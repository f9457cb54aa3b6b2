"""Deterministic fault injection for the serving stack.

The port of ``repro/serve/faults.py``: the same schedule semantics and
seeded draws, so one schedule fires the same faults in both packages.
Every recovery path in the self-healing layer (retry, quarantine, probe,
re-admission, watchdog, corrupt-cache fallback) is driven end-to-end by
this harness, so it is testable on CPU and reproducible run to run:

  * :class:`FaultSpec` — one scheduled fault: a *site* (``"step"``,
    ``"prefill"``, ``"decode"``, or any caller-chosen label), the 1-based
    call index ``at`` at which it fires for a given target, and a kind —
    ``"transient"`` / ``"fatal"`` (raise the matching
    ``serve.health`` error) or ``"hang"`` (advance the injectable clock
    by ``hang_s`` so the step appears to have stalled past the watchdog
    deadline, then let the call proceed).  ``repeat=True`` makes the
    fault permanent from ``at`` on (``until`` bounds it — a fault that
    "clears" after call ``until``).
  * :class:`FaultInjector` — matches specs against per-``(site, target)``
    call counters.  ``instrument(engine, name)`` wraps a
    ``ContinuousEngine``'s ``step`` / ``_prefill`` / ``_decode`` entry
    points so faults fire inside the real serving loop (the wraps hold
    the engine weakly: no reference cycle keeps a dropped engine's pool
    and weights on the card until the collector runs); engines built
    later (e.g. a warm restart from a replica factory) are *not*
    instrumented unless the factory instruments them — restarting really
    does clear instance-bound faults, which is exactly the semantics
    re-admission relies on.  Optional seeded ``rates`` add random
    transient chaos per site, deterministic for a fixed seed and call
    order.  Everything that fires is recorded in ``injector.fired``.
  * :meth:`FaultInjector.corrupt_cache` — deterministic tuning-cache IO
    faults: truncate, overwrite with garbage, or rewrite with an
    unknown schema, for exercising the hardened loader's
    warn-and-fall-back path.
  * :class:`FaultClock` — a controllable monotonic clock shared by the
    injector and the router, so hangs, backoff, probe intervals, and
    deadlines all advance deterministically in tests.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Optional, Sequence

import numpy as np

from repro_torch.serve.health import FatalError, TransientError


class FaultClock:
    """Injectable monotonic clock: ``now()`` / ``advance(s)``.

    Callable, so an instance drops in anywhere a ``clock=`` callable is
    expected (``EngineRouter(clock=clk)``), and its ``advance`` method
    drops in as a deterministic ``sleep=`` (backoff consumes simulated
    time instead of wall time).
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> None:
        self._t += float(seconds)

    def __call__(self) -> float:
        return self.now()


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault; see the module docstring."""
    site: str
    at: int = 1
    kind: str = "transient"          # "transient" | "fatal" | "hang"
    target: Optional[str] = None     # None matches any target at the site
    hang_s: float = 0.0
    repeat: bool = False
    until: Optional[int] = None      # with repeat: last call that faults

    def __post_init__(self):
        if self.kind not in ("transient", "fatal", "hang"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "hang" and self.hang_s <= 0:
            raise ValueError("hang faults need hang_s > 0")

    def matches(self, site: str, target: Optional[str], count: int) -> bool:
        if site != self.site:
            return False
        if self.target is not None and target != self.target:
            return False
        if self.repeat:
            return count >= self.at and (self.until is None
                                         or count <= self.until)
        return count == self.at


class FaultInjector:
    """Seedable, schedule-driven fault source; see the module docstring."""

    def __init__(self, specs: Sequence[FaultSpec] = (), *,
                 clock: FaultClock | None = None, seed: int = 0,
                 rates: dict[str, float] | None = None):
        self.specs = list(specs)
        self.clock = clock
        self.rates = dict(rates or {})
        self._rng = np.random.default_rng(seed)
        self.calls: collections.Counter = collections.Counter()
        self.fired: list[tuple] = []    # (site, target, call#, kind)

    # ---------------- the fault source ----------------

    def fire(self, site: str, target: str | None = None) -> None:
        """Account one call at ``site`` for ``target``; raise / hang when
        a spec (or the site's random rate) says so."""
        self.calls[(site, target)] += 1
        count = self.calls[(site, target)]
        for spec in self.specs:
            if spec.matches(site, target, count):
                self._trigger(spec.kind, site, target, count,
                              hang_s=spec.hang_s)
                return
        rate = self.rates.get(site, 0.0)
        if rate and float(self._rng.random()) < rate:
            self._trigger("transient", site, target, count)

    def _trigger(self, kind: str, site: str, target: str | None,
                 count: int, hang_s: float = 0.0) -> None:
        self.fired.append((site, target, count, kind))
        where = f"{site}[{target}] call {count}"
        if kind == "hang":
            if self.clock is None:
                raise ValueError(
                    "hang faults need FaultInjector(clock=FaultClock())")
            self.clock.advance(hang_s)   # the call "took" hang_s
            return
        if kind == "transient":
            raise TransientError(f"injected transient fault at {where}")
        raise FatalError(f"injected fatal fault at {where}")

    # ---------------- instrumentation ----------------

    def instrument(self, engine, name: str):
        """Wrap ``engine``'s step / prefill / decode entry points so this
        injector fires inside them (sites ``"step"`` / ``"prefill"`` /
        ``"decode"``, target ``name``).  Returns the engine.  The wrap is
        instance-bound: a fresh engine (warm restart) is clean.

        Each wrap is an instance attribute that calls the method it
        replaces.  Unlike the reference's closure over the bound method,
        it holds the engine only through a weak reference (and an earlier
        wrap, which holds it no more strongly), so an instrumented engine
        is freed as soon as its last outside reference goes.
        """
        for site, attr in (("step", "step"), ("prefill", "_prefill"),
                           ("decode", "_decode")):
            setattr(engine, attr, self._wrap(engine, attr, site, name))
        return engine

    def _wrap(self, engine, attr: str, site: str, name: str):
        inner = vars(engine).get(attr)     # an earlier instance-level wrap
        if inner is None:
            method = getattr(type(engine), attr)
            ref = weakref.ref(engine)

            def inner(*a, **kw):
                return method(ref(), *a, **kw)

        def wrapped(*a, **kw):
            self.fire(site, name)
            return inner(*a, **kw)
        return wrapped

    # ---------------- tuning-cache IO faults ----------------

    @staticmethod
    def corrupt_cache(path: str, mode: str = "garbage") -> None:
        """Deterministically corrupt a tuning-cache file.

        ``"garbage"`` overwrites with non-JSON bytes; ``"truncate"``
        keeps the first half of the existing file (a partially-written
        save), simulating a crash mid-write on a non-atomic writer;
        ``"unknown"`` writes valid JSON with an unrecognized schema.
        The hardened loader must warn and fall back to heuristic blocks
        for all three.
        """
        if mode == "garbage":
            payload = "{this is not json\x00"
        elif mode == "truncate":
            try:
                with open(path) as f:
                    text = f.read()
            except OSError:
                text = '{"version": 1, "entries": [{"op": "matmul", '
            payload = text[:max(1, len(text) // 2)]
        elif mode == "unknown":
            payload = ('{"version": 999, "schema": "from-the-future", '
                       '"entries": {"not": "a list"}}')
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")
        with open(path, "w") as f:
            f.write(payload)

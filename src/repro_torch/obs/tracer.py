"""Thread-safe ring-buffer tracer: nested spans + structured events.

The port of ``repro/obs/tracer.py``.  The tracer is the storage and
recording half of ``repro_torch.obs``; activation (global install,
``repro_torch.use(tracer=...)``) lives in the package ``__init__``.
Design constraints, in order:

  * **Near-zero disabled cost.**  Hot paths guard with
    ``tr = obs.current_tracer()`` — one module-level bool check when no
    tracer is active — and the public ``obs.span()`` helper returns a
    shared no-op singleton, so tracing off means no allocation and no
    lock traffic on the serving/dispatch fast paths.
  * **Thread safety without a hot lock.**  Completed records land in a
    ``collections.deque(maxlen=capacity)`` (appends are atomic under the
    GIL), and the *open*-span stack is ``threading.local`` — each thread
    nests independently, so two threads never contend or cross-parent.
  * **Injectable clock.**  ``Tracer(clock=...)`` defaults to
    ``time.perf_counter`` — the same clock the serve scheduler stamps
    ``submit_time``/``first_token_time`` with, so per-request span trees
    telescope exactly against the engine's own TTFT accounting; tests
    inject a fake clock for deterministic durations.

Spans record on *completion* (children before parents in the buffer);
synthetic spans for intervals that outlive any ``with`` block — e.g. a
request's life across many engine steps — are added after the fact with
:meth:`Tracer.add_span` from already-captured timestamps.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Optional

DEFAULT_CAPACITY = 65536


@dataclasses.dataclass
class SpanRecord:
    """One completed (or synthetic) span."""
    name: str
    t0: float
    t1: float
    span_id: int
    parent_id: Optional[int]
    thread: int
    attrs: dict

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class EventRecord:
    """One instant event, optionally parented to the span it fired in."""
    name: str
    t: float
    span_id: Optional[int]
    thread: int
    attrs: dict


class Span:
    """A live span; use as a context manager.  ``set(**attrs)`` attaches
    attributes (inside or after the ``with`` block — the record holds a
    reference to the same dict), ``event()`` fires an instant event
    parented here."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id",
                 "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id: Optional[int] = None
        self.parent_id: Optional[int] = None
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> None:
        self._tracer.event(name, **attrs)

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self.span_id = next(tr._ids)
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        self.t1 = tr.clock()
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:          # mis-nested exit: drop through to us
            while stack and stack[-1] is not self:
                stack.pop()
            stack.pop()
        tr._records.append(SpanRecord(
            name=self.name, t0=self.t0, t1=self.t1, span_id=self.span_id,
            parent_id=self.parent_id, thread=threading.get_ident(),
            attrs=self.attrs))


class _NullSpan:
    """Shared no-op span: the disabled fast path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set(self, **attrs) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffer span/event recorder; see the module docstring.

    ``capacity`` bounds memory: the oldest completed records fall off.
    ``clock`` is any zero-arg monotonic-seconds callable.
    """

    def __init__(self, *, capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.capacity = capacity
        self._records: collections.deque = collections.deque(
            maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # ---------------- recording ----------------

    def span(self, name: str, **attrs) -> Span:
        """A new span; enter it (``with tracer.span("prefill"): ...``)."""
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> EventRecord:
        """Record an instant event, parented to the open span (if any)."""
        stack = self._stack()
        rec = EventRecord(
            name=name, t=self.clock(),
            span_id=stack[-1].span_id if stack else None,
            thread=threading.get_ident(), attrs=attrs)
        self._records.append(rec)
        return rec

    def annotate(self, **attrs) -> None:
        """Attach attributes to the innermost open span (no-op outside)."""
        stack = self._stack()
        if stack:
            stack[-1].attrs.update(attrs)

    def add_span(self, name: str, t0: float, t1: float, *,
                 parent_id: Optional[int] = None, **attrs) -> SpanRecord:
        """Record a synthetic span from captured timestamps — for
        intervals no ``with`` block can cover (a request's life across
        many engine steps).  Timestamps must come from this tracer's
        ``clock`` domain."""
        rec = SpanRecord(
            name=name, t0=float(t0), t1=float(t1), span_id=next(self._ids),
            parent_id=parent_id, thread=threading.get_ident(), attrs=attrs)
        self._records.append(rec)
        return rec

    # ---------------- introspection ----------------

    def records(self) -> list:
        """All records (spans + events) in completion order."""
        return list(self._records)

    def spans(self, name: str | None = None) -> list:
        out = [r for r in self._records if isinstance(r, SpanRecord)]
        if name is not None:
            out = [r for r in out if r.name == name]
        return out

    def events(self, name: str | None = None) -> list:
        out = [r for r in self._records if isinstance(r, EventRecord)]
        if name is not None:
            out = [r for r in out if r.name == name]
        return out

    def clear(self) -> None:
        self._records.clear()

    def summary(self) -> dict:
        """Per-span-name aggregates: ``{name: {count, total_s, mean_s,
        max_s}}``, sorted by total time descending."""
        agg: dict[str, list] = {}
        for r in self.spans():
            agg.setdefault(r.name, []).append(r.duration_s)
        out = {}
        for name, ds in sorted(agg.items(),
                               key=lambda kv: -sum(kv[1])):
            out[name] = {"count": len(ds), "total_s": sum(ds),
                         "mean_s": sum(ds) / len(ds), "max_s": max(ds)}
        return out

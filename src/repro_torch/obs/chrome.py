"""Chrome trace-event JSON export: any tracer buffer, Perfetto-loadable.

The port of ``repro/obs/chrome.py``, unchanged.  The JSON Array/Object
format ``chrome://tracing`` and Perfetto ingest: complete events (``"ph":
"X"``) for spans, instant events (``"ph": "i"``) for events,
timestamps/durations in microseconds relative to the earliest record, one
``tid`` per recording thread.  ``validate()`` round-trips the schema;
``summarize()`` renders the per-name terminal table behind ``python -m
repro_torch.obs summarize``.
"""
from __future__ import annotations

import json

from repro_torch.obs.tracer import EventRecord, SpanRecord, Tracer


def to_chrome(records, *, pid: int = 1) -> dict:
    """Render an iterable of Span/Event records as a Chrome trace dict."""
    records = list(records)
    t_base = min((r.t0 if isinstance(r, SpanRecord) else r.t
                  for r in records), default=0.0)
    # compact per-thread tids (0, 1, ...) in order of first appearance
    tids: dict[int, int] = {}
    events = []
    for r in records:
        tid = tids.setdefault(r.thread, len(tids))
        if isinstance(r, SpanRecord):
            events.append({
                "name": r.name, "ph": "X", "pid": pid, "tid": tid,
                "ts": (r.t0 - t_base) * 1e6,
                "dur": max(0.0, (r.t1 - r.t0) * 1e6),
                "args": dict(r.attrs, span_id=r.span_id,
                             parent_id=r.parent_id),
            })
        elif isinstance(r, EventRecord):
            events.append({
                "name": r.name, "ph": "i", "s": "t", "pid": pid,
                "tid": tid, "ts": (r.t - t_base) * 1e6,
                "args": dict(r.attrs, span_id=r.span_id),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome(tracer: Tracer, path: str) -> int:
    """Write the tracer's buffer as Chrome trace JSON; returns the event
    count."""
    trace = to_chrome(tracer.records())
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
    return len(trace["traceEvents"])


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def validate(trace: dict) -> int:
    """Schema-check a Chrome trace dict; returns the event count, raises
    ``ValueError`` with the first offense otherwise."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("not a Chrome trace: missing 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' is not a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"traceEvents[{i}] missing {field!r}")
        if ev["ph"] not in ("X", "i", "B", "E", "M"):
            raise ValueError(
                f"traceEvents[{i}] has unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"traceEvents[{i}].ts is not a number")
        if ev["ph"] == "X" and not isinstance(ev.get("dur"),
                                              (int, float)):
            raise ValueError(f"traceEvents[{i}] ('X') missing numeric dur")
    return len(events)


def summarize(trace: dict) -> str:
    """Per-name aggregate table of a loaded Chrome trace (complete events
    by total time descending, then instant-event counts)."""
    validate(trace)
    spans: dict[str, list] = {}
    instants: dict[str, int] = {}
    for ev in trace["traceEvents"]:
        if ev["ph"] == "X":
            spans.setdefault(ev["name"], []).append(ev["dur"])
        elif ev["ph"] == "i":
            instants[ev["name"]] = instants.get(ev["name"], 0) + 1
    lines = [f"{'span':<28}{'count':>7}{'total_ms':>12}"
             f"{'mean_us':>12}{'max_us':>12}"]
    for name, ds in sorted(spans.items(), key=lambda kv: -sum(kv[1])):
        lines.append(f"{name:<28}{len(ds):>7}{sum(ds) / 1e3:>12.3f}"
                     f"{sum(ds) / len(ds):>12.1f}{max(ds):>12.1f}")
    if instants:
        lines.append("")
        lines.append(f"{'event':<28}{'count':>7}")
        for name, n in sorted(instants.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<28}{n:>7}")
    return "\n".join(lines)

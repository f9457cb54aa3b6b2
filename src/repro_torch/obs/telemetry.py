"""Dispatch telemetry: one process-wide counter store.

The port of ``repro/obs/telemetry.py``, counters and exposition names
unchanged.  Every ``dispatch.resolve`` increments ``op_dispatch`` here; the
serving exposition (``serve.metrics.render_prometheus``) renders the
families through :func:`prometheus_lines`:

    repro_op_dispatch_total{op,backend}    resolutions by chosen backend
    repro_backend_fallbacks_total{reason}  unavailable-backend fallbacks
    repro_tuning_cache_hits_total          resolve_blocks memo hits
    repro_tuning_cache_misses_total        resolve_blocks policy runs
    repro_blocks_source_total{source}      where each blocks pick came from
    repro_autotune_{searches,measured,failed,seeded}_total

``dispatch.resolve_blocks`` records every lookup (a hit, or the source
of a fresh pick) and ``core.autotune`` its searches; ``autotune.STATS``
is a view of the same store.  The port's dispatch has no fallback tier,
so ``repro_backend_fallbacks_total`` is emitted without samples, that a
scraper sees the reference's families.  Counters are ints behind one
lock, always on: unlike spans they cost no memory growth.
"""
from __future__ import annotations

import threading


class DispatchTelemetry:
    """Process-wide counters; see the module docstring."""

    def __init__(self):
        self._lock = threading.Lock()
        self.op_dispatch: dict[tuple, int] = {}     # (op, backend) -> n
        self.blocks_source: dict[str, int] = {}     # source -> n
        self.cache_hits = 0
        self.cache_misses = 0
        self.autotune = {"searches": 0, "measured": 0, "failed": 0,
                         "seeded": 0}

    def record_dispatch(self, op: str, backend: str) -> None:
        with self._lock:
            key = (op, backend)
            self.op_dispatch[key] = self.op_dispatch.get(key, 0) + 1

    def record_blocks(self, source: str) -> None:
        """One ``resolve_blocks`` outcome: ``"cache-hit"``, or the source
        of a fresh pick (a miss)."""
        with self._lock:
            self.blocks_source[source] = \
                self.blocks_source.get(source, 0) + 1
            if source == "cache-hit":
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def set_autotune(self, name: str, value: int) -> None:
        if name not in self.autotune:
            raise KeyError(name)
        with self._lock:
            self.autotune[name] = int(value)

    def snapshot(self) -> dict:
        """The reference's snapshot keys; ``fallbacks`` stays empty (the
        port never falls back)."""
        with self._lock:
            return {
                "op_dispatch": dict(self.op_dispatch),
                "fallbacks": {},
                "blocks_source": dict(self.blocks_source),
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "autotune": dict(self.autotune),
            }

    def reset(self) -> None:
        with self._lock:
            self.op_dispatch.clear()
            self.blocks_source.clear()
            self.cache_hits = self.cache_misses = 0
            for key in self.autotune:
                self.autotune[key] = 0


TELEMETRY = DispatchTelemetry()


def prometheus_lines(prefix: str = "repro_") -> list[str]:
    """The telemetry counters as Prometheus exposition lines.

    Family HELP/TYPE headers are always emitted (scrapers see stable
    families from the first scrape); labelled families with no samples
    yet contribute headers only.
    """
    snap = TELEMETRY.snapshot()
    lines = []

    def family(name, help_, samples):
        lines.append(f"# HELP {prefix}{name} {help_}")
        lines.append(f"# TYPE {prefix}{name} counter")
        for labels, value in samples:
            lines.append(f"{prefix}{name}{labels} {value}")

    family("op_dispatch_total",
           "Dispatch resolutions by op and chosen backend.",
           [(f'{{op="{op}",backend="{b}"}}', n)
            for (op, b), n in sorted(snap["op_dispatch"].items())])
    family("backend_fallbacks_total",
           "Backend resolutions that fell back (requested tier "
           "unavailable), by reason.",
           [(f'{{reason="{r}"}}', n)
            for r, n in sorted(snap["fallbacks"].items())])
    family("tuning_cache_hits_total",
           "resolve_blocks lookups served from the tuning cache.",
           [("", snap["cache_hits"])])
    family("tuning_cache_misses_total",
           "resolve_blocks lookups that ran a block policy.",
           [("", snap["cache_misses"])])
    family("blocks_source_total",
           "Block geometry picks by source (cache-hit / heuristic / "
           "autotune-measured / autotune-seeded / custom).",
           [(f'{{source="{s}"}}', n)
            for s, n in sorted(snap["blocks_source"].items())])
    auto_help = {
        "searches": "Autotune searches run (cache misses that measured).",
        "measured": "Autotune candidate tiles measured.",
        "failed": "Autotune candidate measurements that raised.",
        "seeded": "Autotune searches seeded from a tuned neighbor.",
    }
    for key in ("searches", "measured", "failed", "seeded"):
        family(f"autotune_{key}_total", auto_help[key],
               [("", snap["autotune"][key])])
    return lines

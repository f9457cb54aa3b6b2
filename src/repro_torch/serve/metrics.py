"""Step-level serving metrics: throughput, slot occupancy, queue depth,
time-to-first-token (both a scheduler-step proxy and wall-clock seconds),
and a Prometheus text exposition for scraping.

The port of ``repro/serve/metrics.py``.  All counters are plain host-side
ints accumulated by ``ContinuousEngine``; ``snapshot()`` renders the
derived rates.  "Steps" are engine steps (one admission sweep + one
batched decode), the natural clock of a continuous-batching loop; wall
time is tracked separately so tokens/s reflects real cost, including
prefill work.

For multi-replica serving (``serve.cluster.EngineRouter``),
``ClusterMetrics`` carries one ``ServeMetrics`` per replica plus live
router gauges (queue depth, free slots, health) and router-level counters
(rejected / shed / timeout / requeued / retries / quarantines ...);
``ClusterMetrics.merge`` folds any set of per-replica metrics into one
cluster-wide ``ServeMetrics``, and ``to_prometheus()`` renders everything
as one exposition with a ``replica`` label per sample.

Latency distributions (TTFT, per-token decode latency) accumulate in
bounded-bucket ``LatencyHistogram``s on the engine itself, so percentile
estimates (p50/p99) come from the serving loop's own observations.  The
exposition also appends the process-wide dispatch telemetry families
(``repro_op_dispatch_total`` and the rest) from
:mod:`repro_torch.obs.telemetry`.
"""
from __future__ import annotations

import bisect
import dataclasses

from repro_torch.obs import telemetry as _telemetry

# log-spaced ~0.5ms .. 60s: TTFT and per-token latencies on anything from
# a CPU test to a loaded production engine land inside
DEFAULT_LATENCY_BOUNDS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


@dataclasses.dataclass
class LatencyHistogram:
    """Bounded-bucket latency histogram with quantile estimates.

    ``counts[i]`` holds observations ``<= bounds[i]`` (exclusive of the
    previous bound); the final slot is the +Inf overflow.  ``__add__``
    merges two histograms of the same bounds.
    """
    bounds: tuple = DEFAULT_LATENCY_BOUNDS
    counts: list = None
    total_s: float = 0.0
    count: int = 0

    def __post_init__(self):
        if self.counts is None:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, value_s: float, n: int = 1) -> None:
        self.counts[bisect.bisect_left(self.bounds, value_s)] += n
        self.total_s += value_s * n
        self.count += n

    def mean(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0..1): linear interpolation inside
        the bucket holding the target rank; the overflow bucket reports
        the last bound (a floor, not an estimate)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if seen + c >= target:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i else 0.0
                frac = (target - seen) / c
                return lo + (self.bounds[i] - lo) * min(1.0, max(0.0, frac))
            seen += c
        return self.bounds[-1]

    def __add__(self, other: "LatencyHistogram") -> "LatencyHistogram":
        if self.bounds != other.bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket bounds")
        return LatencyHistogram(
            bounds=self.bounds,
            counts=[a + b for a, b in zip(self.counts, other.counts)],
            total_s=self.total_s + other.total_s,
            count=self.count + other.count)

    def prometheus_lines(self, name: str, labels: str) -> list[str]:
        """The cumulative ``_bucket``/``_sum``/``_count`` samples of one
        histogram (headers are the caller's job)."""
        lines, cum = [], 0
        for bound, c in zip(self.bounds, self.counts):
            cum += c
            sep = "," if labels else ""
            inner = labels[1:-1] if labels else ""
            lines.append(f'{name}_bucket{{{inner}{sep}le="{bound}"}} {cum}')
        inner = labels[1:-1] if labels else ""
        sep = "," if labels else ""
        lines.append(f'{name}_bucket{{{inner}{sep}le="+Inf"}} {self.count}')
        lines.append(f"{name}_sum{labels} {_prom_value(self.total_s)}")
        lines.append(f"{name}_count{labels} {self.count}")
        return lines


@dataclasses.dataclass
class ServeMetrics:
    steps: int = 0
    prefills: int = 0
    # chunked prefill: individual prompt chunks processed, and running
    # requests preempted to reclaim KV pages (paged pool under pressure)
    prefill_chunks: int = 0
    preemptions: int = 0
    decode_steps: int = 0
    requests_submitted: int = 0
    requests_completed: int = 0
    requests_cancelled: int = 0
    tokens_generated: int = 0
    # occupancy: occupied-slot decode steps / (n_slots * decode steps)
    slot_steps: int = 0
    slot_capacity_steps: int = 0
    # queue pressure, sampled at the start of each step
    queue_depth_sum: int = 0
    max_queue_depth: int = 0
    # time-to-first-token: steps from submit to first sampled token, and
    # the same interval in wall-clock seconds
    ttft_steps_sum: int = 0
    ttft_s_sum: float = 0.0
    ttft_count: int = 0
    wall_time_s: float = 0.0
    # latency distributions, engine-observed: wall-clock TTFT per request
    # and per-token decode-step latency (the batched decode's duration,
    # one observation per active slot)
    ttft_hist: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)
    token_latency_hist: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    # ---------------- derived ----------------

    def occupancy(self) -> float:
        if not self.slot_capacity_steps:
            return 0.0
        return self.slot_steps / self.slot_capacity_steps

    def tokens_per_s(self) -> float:
        if self.wall_time_s <= 0:
            return 0.0
        return self.tokens_generated / self.wall_time_s

    def mean_queue_depth(self) -> float:
        return self.queue_depth_sum / self.steps if self.steps else 0.0

    def mean_ttft_steps(self) -> float:
        return (self.ttft_steps_sum / self.ttft_count
                if self.ttft_count else 0.0)

    def mean_ttft_s(self) -> float:
        return (self.ttft_s_sum / self.ttft_count
                if self.ttft_count else 0.0)

    def snapshot(self) -> dict:
        out = dataclasses.asdict(self)
        out["occupancy"] = self.occupancy()
        out["tokens_per_s"] = self.tokens_per_s()
        out["mean_queue_depth"] = self.mean_queue_depth()
        out["mean_ttft_steps"] = self.mean_ttft_steps()
        out["mean_ttft_s"] = self.mean_ttft_s()
        out["ttft_p50_s"] = self.ttft_hist.quantile(0.5)
        out["ttft_p99_s"] = self.ttft_hist.quantile(0.99)
        out["token_latency_p50_s"] = self.token_latency_hist.quantile(0.5)
        out["token_latency_p99_s"] = self.token_latency_hist.quantile(0.99)
        return out

    def to_prometheus(self, labels: dict | None = None) -> str:
        """Prometheus text exposition of this metrics set (one sample per
        family, optionally labelled)."""
        return render_prometheus([(labels or {}, self)])


# ==========================================================================
# Prometheus text exposition
# ==========================================================================

PROM_PREFIX = "repro_serve_"

# (family suffix, prometheus type, help text, extractor)
_PROM_SPEC = (
    ("steps_total", "counter", "Engine steps run.",
     lambda m: m.steps),
    ("prefills_total", "counter", "Per-request prefills run.",
     lambda m: m.prefills),
    ("prefill_chunks_total", "counter",
     "Chunked-prefill prompt chunks processed.",
     lambda m: m.prefill_chunks),
    ("preemptions_total", "counter",
     "Running requests preempted to reclaim KV pages.",
     lambda m: m.preemptions),
    ("decode_steps_total", "counter", "Batched decode steps run.",
     lambda m: m.decode_steps),
    ("requests_submitted_total", "counter", "Requests submitted.",
     lambda m: m.requests_submitted),
    ("requests_completed_total", "counter", "Requests completed.",
     lambda m: m.requests_completed),
    ("requests_cancelled_total", "counter",
     "Requests cancelled mid-flight (slot freed early).",
     lambda m: m.requests_cancelled),
    ("tokens_generated_total", "counter", "Tokens generated.",
     lambda m: m.tokens_generated),
    ("wall_time_seconds_total", "counter",
     "Wall-clock seconds spent inside step().",
     lambda m: m.wall_time_s),
    ("occupancy", "gauge",
     "Occupied-slot fraction of decode capacity.",
     lambda m: m.occupancy()),
    ("tokens_per_second", "gauge", "Generated tokens per wall second.",
     lambda m: m.tokens_per_s()),
    ("queue_depth_mean", "gauge", "Mean waiting-queue depth per step.",
     lambda m: m.mean_queue_depth()),
    ("queue_depth_max", "gauge", "Max waiting-queue depth observed.",
     lambda m: m.max_queue_depth),
    ("ttft_steps_mean", "gauge",
     "Mean time-to-first-token in engine steps.",
     lambda m: m.mean_ttft_steps()),
    ("ttft_seconds_mean", "gauge",
     "Mean wall-clock time-to-first-token in seconds.",
     lambda m: m.mean_ttft_s()),
    ("ttft_seconds_p50", "gauge",
     "Engine-observed wall-clock TTFT p50 estimate (seconds).",
     lambda m: m.ttft_hist.quantile(0.5)),
    ("ttft_seconds_p99", "gauge",
     "Engine-observed wall-clock TTFT p99 estimate (seconds).",
     lambda m: m.ttft_hist.quantile(0.99)),
    ("token_latency_seconds_p50", "gauge",
     "Engine-observed per-token decode latency p50 estimate (seconds).",
     lambda m: m.token_latency_hist.quantile(0.5)),
    ("token_latency_seconds_p99", "gauge",
     "Engine-observed per-token decode latency p99 estimate (seconds).",
     lambda m: m.token_latency_hist.quantile(0.99)),
)

# (family suffix, help, histogram accessor): rendered as native
# Prometheus histograms (_bucket{le=}/_sum/_count) per row
_PROM_HISTOGRAMS = (
    ("ttft_seconds", "Wall-clock time-to-first-token distribution.",
     lambda m: m.ttft_hist),
    ("token_latency_seconds",
     "Per-token decode-step latency distribution.",
     lambda m: m.token_latency_hist),
)


# HELP text for the router-level families rendered via the generic
# ``gauges=`` / ``counters=`` hooks of render_prometheus (families not
# listed fall back to a generic line, so adding a counter in the router
# never breaks the exposition).
_GAUGE_HELP = {
    "queue_depth": "Requests waiting on this replica.",
    "running": "Requests currently decoding on this replica.",
    "slots_free": "Free KV-cache slots on this replica.",
    "healthy": "1 when the replica is serving traffic, 0 quarantined.",
    "probing": "1 while the quarantined replica is under health probes.",
    "kv_occupancy": "Occupied fraction of the replica's KV slots.",
    "kv_page_occupancy":
        "Allocated fraction of the replica's KV page pool.",
    "kv_page_fragmentation":
        "Allocated-but-dead KV fraction (partially filled trailing "
        "pages).",
    "kv_free_pages": "Free KV pages on this replica.",
}
_COUNTER_HELP = {
    "requests_rejected": "Requests rejected at a full backlog.",
    "requests_shed": "Requests shed by priority at a full backlog.",
    "requests_timeout": "Requests expired by their deadline.",
    "requests_requeued": "Requests requeued off a quarantined replica.",
    "requests_degraded":
        "Tier-affinity requests served off-tier (tier had no healthy "
        "replica).",
    "retries": "Transient step failures retried in place with backoff.",
    "replicas_quarantined": "Replica quarantine events.",
    "replicas_readmitted":
        "Replicas re-admitted after passing health probes.",
    "probes": "Health probes run against quarantined replicas.",
    "probe_failures": "Health probes that failed.",
}


def _prom_value(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    esc = {k: str(v).replace("\\", r"\\").replace('"', r'\"')
           .replace("\n", r"\n") for k, v in labels.items()}
    return "{" + ",".join(f'{k}="{v}"' for k, v in esc.items()) + "}"


def render_prometheus(rows, *, gauges=None, counters=None,
                      dispatch_telemetry: bool = True) -> str:
    """Render ``rows`` of ``(labels, ServeMetrics)`` as one exposition.

    Each family gets its HELP/TYPE header once, then one sample per row.
    ``gauges`` adds extra per-row gauge families as
    ``{family: [(labels, value), ...]}``; ``counters`` adds unlabelled
    top-level counters as ``{family: value}`` (router-level totals).
    ``dispatch_telemetry`` appends the process-wide dispatch/autotune
    counter families from :mod:`repro_torch.obs.telemetry` (they are
    per-process, not per-replica, so they render once, unlabelled).
    """
    lines = []
    for suffix, ptype, help_, extract in _PROM_SPEC:
        name = PROM_PREFIX + suffix
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {ptype}")
        for labels, m in rows:
            lines.append(
                f"{name}{_prom_labels(labels)} {_prom_value(extract(m))}")
    for suffix, help_, extract in _PROM_HISTOGRAMS:
        name = PROM_PREFIX + suffix
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} histogram")
        for labels, m in rows:
            lines.extend(extract(m).prometheus_lines(
                name, _prom_labels(labels)))
    for family in sorted(gauges or ()):
        name = PROM_PREFIX + family
        help_ = _GAUGE_HELP.get(family, "Live gauge exported by the router.")
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} gauge")
        for labels, value in gauges[family]:
            lines.append(f"{name}{_prom_labels(labels)} "
                         f"{_prom_value(value)}")
    for family in sorted(counters or ()):
        name = PROM_PREFIX + family + "_total"
        help_ = _COUNTER_HELP.get(family, "Router-level counter.")
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_prom_value(counters[family])}")
    if dispatch_telemetry:
        lines.extend(_telemetry.prometheus_lines())
    return "\n".join(lines) + "\n"


# ==========================================================================
# cluster aggregation
# ==========================================================================

@dataclasses.dataclass
class ClusterMetrics:
    """Per-replica metrics plus router-level state, as one exposition.

    ``replicas`` maps replica name -> its live ``ServeMetrics``;
    ``gauges`` maps replica name -> instantaneous router-side gauges
    (``queue_depth``, ``running``, ``slots_free``, ``healthy``);
    ``counters`` holds router-level admission/fault totals.
    """

    replicas: dict
    gauges: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def merge(metrics) -> ServeMetrics:
        """Fold an iterable of ``ServeMetrics`` into one cluster-wide set:
        counters sum; ``max_queue_depth`` takes the max (a max over
        replicas is still a max); derived rates then fall out of the sums
        (cluster occupancy weights each replica by its decode capacity)."""
        out = ServeMetrics()
        for m in metrics:
            for f in dataclasses.fields(ServeMetrics):
                if f.name == "max_queue_depth":
                    out.max_queue_depth = max(out.max_queue_depth,
                                              m.max_queue_depth)
                else:
                    setattr(out, f.name,
                            getattr(out, f.name) + getattr(m, f.name))
        return out

    def aggregate(self) -> ServeMetrics:
        return self.merge(self.replicas.values())

    def to_prometheus(self) -> str:
        """One exposition: every ``ServeMetrics`` family sampled per
        replica (``replica="<name>"``), the live router gauges per
        replica, and the router-level totals."""
        rows = [({"replica": name}, m)
                for name, m in sorted(self.replicas.items())]
        gauges: dict = {}
        for name in sorted(self.gauges):
            for family, value in self.gauges[name].items():
                gauges.setdefault(family, []).append(
                    ({"replica": name}, value))
        return render_prometheus(rows, gauges=gauges,
                                 counters=self.counters)

"""The port's tracer, dispatch telemetry and serving metrics, and the
engine's spans, against the JAX package's where both compute a result.

The tracer and the metrics are pure Python in both packages: the same
observations give the same quantiles and the same Prometheus text.  The
engine runs the reduced smollm-135m on the CPU with random weights; its
TTFT breakdown is held exactly under an injected clock.
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro_torch
from repro.serve import metrics as jmetrics
from repro_torch import configs, obs
from repro_torch.core import dispatch
from repro_torch.kernels.brgemm import matmul
from repro_torch.models import api
from repro_torch.obs.telemetry import TELEMETRY
from repro_torch.serve import (ContinuousEngine, LatencyHistogram,
                               PoolConfig, Request, ServeMetrics,
                               render_prometheus)

MAX_LEN = 32


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """Every test starts and ends with tracing disabled."""
    obs.install(None)
    yield
    obs.install(None)


@pytest.fixture(scope="module")
def dense():
    cfg = configs.get("smollm-135m").reduced()
    return cfg, api.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


def _requests(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab, 3 + i % 5).tolist(),
                    max_tokens=2 + i % 3, stop_tokens=())
            for i in range(n)]


def _engine(dense, **kw):
    cfg, params = dense
    return ContinuousEngine(cfg, params, PoolConfig(n_slots=2,
                                                    max_len=MAX_LEN),
                            device="cpu", **kw)


class FakeClock:
    """Deterministic strictly-increasing clock."""

    def __init__(self, dt=1.0):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


# ---------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------

def test_disabled_fast_path_allocates_nothing():
    assert obs.current_tracer() is None
    s1 = obs.span("anything", x=1)
    s2 = obs.span("else")
    assert s1 is s2 is obs.NULL_SPAN
    with s1 as inner:
        assert inner is obs.NULL_SPAN
        inner.set(a=1).event("e")
    obs.event("nothing")
    obs.annotate(a=2)


def test_span_nesting_and_parent_links():
    tr = obs.Tracer(clock=FakeClock())
    with tr.span("outer") as outer:
        with tr.span("inner") as inner:
            tr.annotate(depth=2)
    spans = tr.spans()
    assert [s.name for s in spans] == ["inner", "outer"]   # completion order
    by_name = {s.name: s for s in spans}
    assert by_name["outer"].parent_id is None
    assert by_name["inner"].parent_id == by_name["outer"].span_id
    assert by_name["inner"].attrs == {"depth": 2}
    assert inner.span_id != outer.span_id


def test_injectable_clock_durations_and_summary():
    tr = obs.Tracer(clock=FakeClock(dt=1.0))
    with tr.span("a"):
        pass                       # t0=1, t1=2
    (rec,) = tr.spans("a")
    assert (rec.t0, rec.t1, rec.duration_s) == (1.0, 2.0, 1.0)
    assert tr.summary()["a"] == {"count": 1, "total_s": 1.0, "mean_s": 1.0,
                                 "max_s": 1.0}


def test_ring_buffer_capacity_bounds_memory():
    tr = obs.Tracer(capacity=8, clock=FakeClock())
    for i in range(20):
        with tr.span(f"s{i}"):
            pass
    recs = tr.records()
    assert len(recs) == 8
    assert recs[0].name == "s12" and recs[-1].name == "s19"
    tr.clear()
    assert tr.records() == []


def test_events_parent_to_open_span_and_add_span():
    tr = obs.Tracer(clock=FakeClock())
    tr.event("free")
    with tr.span("work") as sp:
        tr.event("mark", k="v")
        sp.set(extra=1)
    free, mark = tr.events("free")[0], tr.events("mark")[0]
    assert free.span_id is None
    assert mark.span_id == sp.span_id and mark.attrs == {"k": "v"}
    assert tr.spans("work")[0].attrs["extra"] == 1
    root = tr.add_span("request", 1.0, 5.0, status="done")
    child = tr.add_span("request.queue", 1.0, 2.0, parent_id=root.span_id)
    assert child.parent_id == root.span_id and root.duration_s == 4.0


def test_install_global_and_scoped_precedence():
    g, s = obs.Tracer(), obs.Tracer()
    assert obs.install(g) is None
    try:
        assert obs.current_tracer() is g
        with obs.activate(s):
            assert obs.current_tracer() is s     # scoped wins
        assert obs.current_tracer() is g
        with obs.activate(None) as none:
            assert none is None and obs.current_tracer() is g
    finally:
        obs.install(None)
    assert obs.current_tracer() is None


def test_use_tracer_scopes_activation():
    tr = obs.Tracer()
    with repro_torch.use(tracer=tr):
        assert obs.current_tracer() is tr
        with obs.span("inside"):
            pass
        with repro_torch.use(backend="torch"):   # an inner scope keeps it
            assert obs.current_tracer() is tr
    assert obs.current_tracer() is None
    assert [s.name for s in tr.spans()] == ["inside"]


def test_tracer_thread_safety_independent_stacks():
    tr = obs.Tracer()
    obs.install(tr)
    barrier = threading.Barrier(4)

    def work(i):
        barrier.wait(timeout=30)
        for _ in range(25):
            with obs.span(f"outer{i}"):
                with obs.span(f"inner{i}"):
                    pass

    with ThreadPoolExecutor(4) as ex:
        list(ex.map(work, range(4)))
    obs.install(None)
    assert len(tr.spans()) == 4 * 25 * 2
    by_id = {s.span_id: s for s in tr.spans()}
    for s in tr.spans():
        if s.name.startswith("inner"):
            parent = by_id[s.parent_id]
            assert parent.name == "outer" + s.name[len("inner"):]
            assert parent.thread == s.thread


# ---------------------------------------------------------------------
# dispatch telemetry
# ---------------------------------------------------------------------

def test_dispatch_resolution_counts_and_events():
    TELEMETRY.reset()
    tr = obs.Tracer()
    x = torch.ones(2, 3)
    with repro_torch.use(backend="torch", tracer=tr):
        matmul(x, torch.ones(3, 4))
        assert dispatch.resolve("flash_attention", None, x) == "torch"
    snap = TELEMETRY.snapshot()
    assert snap["op_dispatch"] == {("matmul", "torch"): 1,
                                   ("flash_attention", "torch"): 1}
    assert snap["fallbacks"] == {} and snap["cache_hits"] == 0
    assert [(e.attrs["op"], e.attrs["backend"]) for e in
            tr.events("dispatch")] == [("matmul", "torch"),
                                       ("flash_attention", "torch")]
    # a refused resolution counts nothing
    with pytest.raises(ValueError):
        dispatch.resolve("matmul", "cuda", x)
    assert TELEMETRY.snapshot()["op_dispatch"][("matmul", "torch")] == 1
    TELEMETRY.reset()


def test_prometheus_telemetry_families_always_present():
    TELEMETRY.reset()
    text = render_prometheus([({"replica": "r0"}, ServeMetrics())])
    for fam in ("repro_op_dispatch_total", "repro_backend_fallbacks_total",
                "repro_tuning_cache_hits_total",
                "repro_tuning_cache_misses_total",
                "repro_blocks_source_total",
                "repro_autotune_searches_total"):
        assert f"# TYPE {fam} counter" in text
    matmul(torch.ones(2, 3), torch.ones(3, 4))
    text = render_prometheus([({"replica": "r0"}, ServeMetrics())])
    assert 'repro_op_dispatch_total{op="matmul",backend="torch"} 1' in text
    TELEMETRY.reset()


# ---------------------------------------------------------------------
# latency histograms and the exposition, against the reference's
# ---------------------------------------------------------------------

def test_histogram_observe_quantile_merge_as_reference():
    obsv = (0.005, 0.005, 0.05, 0.5, 5.0)
    h, jh = (cls(bounds=(0.01, 0.1, 1.0)) for cls in (
        LatencyHistogram, jmetrics.LatencyHistogram))
    assert h.quantile(0.5) == 0.0
    for v in obsv:
        h.observe(v)
        jh.observe(v)
    assert h.count == 5 and h.total_s == pytest.approx(5.56)
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert h.quantile(1.0) == 1.0                 # overflow -> last bound
    other = LatencyHistogram(bounds=(0.01, 0.1, 1.0))
    other.observe(0.05, n=3)
    merged = h + other
    assert merged.count == 8 and merged.counts[1] == 4
    with pytest.raises(ValueError):
        h + LatencyHistogram(bounds=(1.0, 2.0))


def test_exposition_matches_reference_text():
    m, jm = ServeMetrics(), jmetrics.ServeMetrics()
    for x in (m, jm):
        x.steps, x.prefills, x.decode_steps = 7, 3, 5
        x.tokens_generated, x.wall_time_s = 12, 0.75
        x.slot_steps, x.slot_capacity_steps = 9, 15
        x.ttft_hist.observe(0.02)
        x.ttft_hist.observe(0.2)
        x.token_latency_hist.observe(0.004, n=10)
    labels = {"replica": 'r"0'}
    assert render_prometheus([(labels, m)], dispatch_telemetry=False) == \
        jmetrics.render_prometheus([(labels, jm)], dispatch_telemetry=False)
    snap = m.snapshot()
    assert snap["ttft_p99_s"] >= snap["ttft_p50_s"] > 0
    assert snap["token_latency_p50_s"] > 0
    assert snap["occupancy"] == 9 / 15


def test_histogram_prometheus_cumulative_buckets():
    h = LatencyHistogram(bounds=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5, n=2)
    h.observe(7.0)
    text = "\n".join(h.prometheus_lines("repro_serve_ttft_seconds",
                                        '{replica="r0"}'))
    assert 'le="0.1"} 1' in text and 'le="1.0"} 3' in text
    assert 'le="+Inf"} 4' in text


# ---------------------------------------------------------------------
# engine spans, TTFT breakdown, trace sampling
# ---------------------------------------------------------------------

def test_engine_ttft_breakdown_telescopes_exactly(dense):
    eng = _engine(dense, clock=FakeClock(dt=0.25))
    out = eng.serve(_requests(dense[0], 4))
    assert all(len(v) for v in out.values())
    for state in eng.scheduler.finished.values():
        bd = state.ttft_breakdown
        assert bd["queue_s"] >= 0
        assert bd["prefill_s"] > 0 and bd["first_decode_s"] > 0
        assert sum(bd.values()) == pytest.approx(state.ttft_s, abs=1e-12)
    assert eng.metrics.ttft_hist.count == 4
    assert eng.metrics.token_latency_hist.count == eng.metrics.slot_steps


def test_engine_request_spans_under_tracer(dense):
    eng = _engine(dense)
    tr = obs.Tracer()
    obs.install(tr)
    try:
        eng.serve(_requests(dense[0], 3))
    finally:
        obs.install(None)
    names = {s.name for s in tr.spans()}
    assert {"prefill", "decode", "request", "request.queue",
            "request.prefill", "request.first_decode"} <= names
    reqs = tr.spans("request")
    assert len(reqs) == 3
    by_id = {s.span_id: s for s in tr.spans()}
    for child in tr.spans("request.queue"):
        assert by_id[child.parent_id].name == "request"
        assert child.attrs["trace"] == by_id[child.parent_id].attrs["trace"]
    for r in reqs:
        assert r.attrs["trace"] == f"req{r.attrs['request_id']}"
        assert r.attrs["finish_reason"] == "length"
        kids = [s for s in tr.spans() if s.parent_id == r.span_id]
        assert sum(k.duration_s for k in kids) == pytest.approx(
            r.attrs["ttft_s"], abs=1e-9)
    assert tr.events("engine.submit")
    # every op the engine ran resolved through dispatch, inside a span
    assert {e.attrs["op"] for e in tr.events("dispatch")} == {
        "matmul", "flash_attention"}


def test_trace_sample_rate_every_nth(dense):
    eng = _engine(dense, trace_sample_rate=3)
    tr = obs.Tracer()
    obs.install(tr)
    try:
        eng.serve(_requests(dense[0], 6))
    finally:
        obs.install(None)
    assert sorted(s.attrs["request_id"] for s in tr.spans("request")) == [
        0, 3]
    assert eng.metrics.requests_completed == 6


def test_trace_explicit_id_and_opt_out(dense):
    eng = _engine(dense, trace_sample_rate=1000)
    tr = obs.Tracer()
    obs.install(tr)
    try:
        reqs = _requests(dense[0], 3)
        eng.submit(reqs[0])                   # rate-sampled (first => yes)
        eng.submit(reqs[1], trace="forced")   # explicit id => sampled
        eng.submit(reqs[2], trace="")         # opt-out
        while eng.has_work():
            eng.step()
    finally:
        obs.install(None)
    assert {s.attrs["request_id"] for s in tr.spans("request")} == {0, 1}
    assert {s.attrs["trace"] for s in tr.spans("request")} == {"req0",
                                                               "forced"}


def test_engine_gauges(dense):
    cfg, params = dense
    eng = ContinuousEngine(cfg, params, PoolConfig(
        n_slots=2, max_len=MAX_LEN, page_size=8), device="cpu")
    eng.submit(Request(prompt=[1, 2, 3], max_tokens=5, stop_tokens=()))
    eng.step()
    g = eng.gauges()
    assert g["kv_occupancy"] == 0.5
    assert g["kv_free_pages"] == eng.pool.n_pages - 1
    assert 0.0 < g["kv_page_fragmentation"] < 1.0
    text = render_prometheus([({}, eng.metrics)], gauges={
        k: [({}, v)] for k, v in g.items()}, dispatch_telemetry=False)
    assert "# TYPE repro_serve_kv_free_pages gauge" in text

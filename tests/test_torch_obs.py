"""The port's tracer, dispatch telemetry, FLOP accounting, Chrome export
and serving metrics, the engine's spans and the router's and front ends'
tracing, against the JAX package's where both compute a result.

The tracer, the cost model, the Chrome export and the metrics are pure
Python in both packages: the same observations give the same quantiles,
the same Prometheus text, the same ``op_cost`` over every op, dtype and
quant spec, and the same ``summarize`` table.  The engine runs the
reduced smollm-135m on the CPU with random weights; its TTFT breakdown is
held exactly under an injected clock.
"""
import asyncio
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import obs as jobs
from repro.serve import metrics as jmetrics
from repro_torch import configs, obs
from repro_torch.core import autotune, dispatch
from repro_torch.core.blocking import AttnGeometry, ConvGeometry, GemmGeometry
from repro_torch.kernels.brgemm import matmul
from repro_torch.models import api
from repro_torch.obs.telemetry import TELEMETRY
from repro_torch.serve import (AsyncFrontend, ContinuousEngine,
                               EngineReplica, EngineRouter, LatencyHistogram,
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


# ---------------------------------------------------------------------
# chrome export
# ---------------------------------------------------------------------

def test_chrome_round_trip(tmp_path):
    tr = obs.Tracer(clock=FakeClock(dt=0.5))
    with tr.span("outer", op="matmul"):
        with tr.span("inner"):
            pass
        tr.event("mark", k=1)
    path = tmp_path / "trace.json"
    n = obs.export_chrome(tr, str(path))
    trace = obs.chrome.load(str(path))
    assert obs.chrome.validate(trace) == n == len(tr.records())
    events = trace["traceEvents"]
    assert trace["displayTimeUnit"] == "ms"
    complete = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(complete) == {"outer", "inner"}
    assert complete["outer"]["args"]["op"] == "matmul"
    # timestamps are microseconds relative to the earliest record
    assert complete["outer"]["dur"] == pytest.approx(2.0e6)
    assert complete["inner"]["ts"] >= 0
    instants = [e for e in events if e["ph"] == "i"]
    assert len(instants) == 1 and instants[0]["name"] == "mark"


def test_chrome_validate_rejects_malformed():
    with pytest.raises(ValueError):
        obs.chrome.validate({"nope": []})
    with pytest.raises(ValueError):
        obs.chrome.validate({"traceEvents": [{"name": "x"}]})
    with pytest.raises(ValueError, match="phase"):
        obs.chrome.validate({"traceEvents": [
            {"name": "x", "ph": "Q", "ts": 0, "pid": 1, "tid": 0}]})
    with pytest.raises(ValueError, match="dur"):
        obs.chrome.validate({"traceEvents": [
            {"name": "x", "ph": "X", "ts": 0, "pid": 1, "tid": 0}]})


def test_chrome_summarize_and_cli(tmp_path, capsys):
    tr = obs.Tracer(clock=FakeClock())
    for _ in range(3):
        with tr.span("step"):
            pass
    assert tr.summary()["step"]["count"] == 3
    path = tmp_path / "t.json"
    obs.export_chrome(tr, str(path))
    table = obs.summarize(obs.chrome.load(str(path)))
    assert "step" in table and "count" in table
    from repro_torch.obs.__main__ import main as obs_main
    obs_main(["summarize", str(path)])
    out = capsys.readouterr().out
    assert "step" in out and str(path) in out


def _synthetic(o):
    """One record list through package ``o``'s tracer: nested and
    repeated spans, a synthetic span, events in and out of spans, on two
    threads, under a fake clock."""
    tr = o.Tracer(clock=FakeClock(dt=0.125))
    for i in range(3):
        with tr.span("prefill", slot=i):
            tr.event("resolve_blocks", op="matmul", m=8 * i)
            with tr.span("matmul"):
                pass
    with tr.span("decode"):
        tr.event("dispatch", op="flash_attention")
    tr.add_span("request", 0.5, 9.75, status="completed")
    t = threading.Thread(target=lambda: tr.event("router.submit"))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    tr.event("router.submit")
    return tr.records()


def test_chrome_export_and_summary_match_reference():
    got, want = _synthetic(obs), _synthetic(jobs)
    trace, jtrace = obs.to_chrome(got), jobs.to_chrome(want)
    for ev, jev in zip(trace["traceEvents"], jtrace["traceEvents"]):
        assert {k: v for k, v in ev.items() if k != "args"} == \
            {k: v for k, v in jev.items() if k != "args"}
        # span ids count from 1 in each tracer: the same sequence
        assert ev["args"] == jev["args"]
    assert obs.chrome.validate(trace) == len(got) == 14
    assert obs.summarize(trace) == jobs.summarize(jtrace)


# ---------------------------------------------------------------------
# flops accounting
# ---------------------------------------------------------------------

def test_op_cost_matmul_and_quant_bytes():
    c = obs.op_cost("matmul", 64, 32, 16, torch.float32)
    assert c.flops == 2 * 64 * 32 * 16
    assert c.bytes == 64 * 16 * 4 + 16 * 32 * 4 + 64 * 32 * 4
    q = obs.op_cost("matmul", 64, 32, 16, torch.int8, quant="int8")
    assert q.flops == c.flops
    assert q.bytes == 64 * 16 * 1 + 16 * 32 * 1 + 64 * 32 * 4
    assert q.intensity > c.intensity
    assert obs.op_cost("matmul", 64, 32, 16, "float32") == c


def test_op_cost_batch_and_attention():
    b = obs.op_cost("brgemm", 8, 8, 8, torch.float32, batch=16)
    assert b.flops == 16 * 2 * 8 * 8 * 8
    fa = obs.op_cost("flash_attention", 128, 128, 64, torch.float32)
    assert fa.flops == 4 * 128 * 128 * 64
    bwd = obs.op_cost("flash_attention_bwd", 128, 128, 64, torch.float32)
    assert bwd.flops == 10 * 128 * 128 * 64
    with pytest.raises(ValueError):
        obs.op_cost("nonsense", 1, 1, 1, torch.float32)


COST_OPS = ("matmul", "brgemm", "batched_matmul", "conv2d",
            "flash_attention", "flash_attention_bwd")
COST_TRIPLES = ((1, 1, 1), (8, 576, 576), (77, 133, 100), (4096, 49152, 64),
                (192, 128, 7168))
def _conv_geometries():
    """(port geometry, the reference's): none, 1x1 stride 1, 3x3 stride 1
    padded, the 7x7 stride-2 stem, a 3x3 stride-2 downsample."""
    from repro.core.blocking import ConvGeometry as JConvGeometry
    out = [(None, None)]
    for h, r, st, p in ((56, 1, 1, 0), (56, 3, 1, 1), (224, 7, 2, 3),
                        (28, 3, 2, 1)):
        out.append((ConvGeometry(32, h, h, r, r, st, p),
                    JConvGeometry(stride=st, r=r, s=r)))
    return out


@pytest.mark.parametrize("op", COST_OPS)
def test_op_cost_matches_reference(op):
    """The port's cost model is the reference's, over every triple, dtype
    (bf16, fp32, and the 8-bit storage dtypes a quant spec prices), quant
    spec, batch and (for the convolution) geometry."""
    geometries = (_conv_geometries() if op == "conv2d"
                  else [(None, None), (GemmGeometry(True), None),
                        (AttnGeometry(True), None)])
    checked = 0
    for m, n, k in COST_TRIPLES:
        for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                              (torch.float32, jnp.float32),
                              (torch.int8, jnp.int8)):
            for quant in (None, "int8", "fp8"):
                for batch in (1, 3):
                    for geometry, jgeometry in geometries:
                        got = obs.op_cost(op, m, n, k, dtype,
                                          geometry=geometry, batch=batch,
                                          quant=quant)
                        want = jobs.op_cost(op, m, n, k, jdtype,
                                            geometry=jgeometry, batch=batch,
                                            quant=quant)
                        assert (got.flops, got.bytes, got.intensity) == (
                            want.flops, want.bytes, want.intensity)
                        checked += 1
    assert checked >= 5 * 3 * 3 * 2 * 3


def test_resolve_blocks_events_carry_the_cost():
    """Every ``resolve_blocks`` event is stamped with the problem's FLOPs,
    bytes and intensity from ``op_cost`` (the reference's numbers), at the
    storage dtype and quant tag the call resolved with."""
    dispatch.clear_tuning_cache()
    tr = obs.Tracer()
    conv = ConvGeometry(32, 56, 56, 3, 3, 1, 1)
    cases = [("matmul", (8, 1536, 576), torch.bfloat16, None, None),
             ("matmul", (8, 1536, 576), torch.int8, None, "int8"),
             ("flash_attention", (512, 512, 64), torch.bfloat16,
              AttnGeometry(True), None),
             ("conv2d", (56, 64, 64), torch.bfloat16, conv, None)]
    with repro_torch.use(tracer=tr):
        for op, triple, dtype, geometry, quant in cases:
            dispatch.resolve_blocks(op, *triple, dtype, backend="cuda",
                                    geometry=geometry, quant=quant)
    events = tr.events("resolve_blocks")
    assert len(events) == len(cases)
    from repro.core.blocking import ConvGeometry as JConvGeometry
    for ev, (op, (m, n, k), dtype, geometry, quant) in zip(events, cases):
        want = jobs.op_cost(op, m, n, k, getattr(jnp, str(dtype)[6:]),
                            geometry=JConvGeometry(1, 3, 3)
                            if op == "conv2d" else None, quant=quant)
        assert (ev.attrs["flops"], ev.attrs["bytes"]) == (want.flops,
                                                          want.bytes)
        assert ev.attrs["intensity"] == round(want.intensity, 3)
        if op == "matmul":
            assert ev.attrs["flops"] == 2 * m * n * k
    assert events[1].attrs["quant"] == "int8"
    # an op without a cost model gets no stamp, and no error
    dispatch._trace_blocks(tr, "custom_op", "cuda", 4, 4, 4, torch.float32,
                           None, None, "custom", "plan")
    (ev,) = tr.events("resolve_blocks")[-1:]
    assert ev.attrs["op"] == "custom_op" and "flops" not in ev.attrs
    dispatch.clear_tuning_cache()


def test_autotune_search_spans_carry_the_cost():
    tr = obs.Tracer()
    with repro_torch.use(tracer=tr):
        autotune.autotune_blocks("matmul", 8, 7168, 20480, torch.bfloat16,
                                 "cuda", max_candidates=3,
                                 timer=lambda *_: 1e-3)
    measures = tr.spans("autotune.measure")
    assert len(measures) == 3
    flops = 2.0 * 8 * 7168 * 20480
    for sp in measures:
        assert sp.attrs["flops"] == flops
        assert sp.attrs["gflops_per_s"] == round(flops / 1e-3 / 1e9, 3)
    assert tr.spans("autotune.search")[0].attrs["best_seconds"] == 1e-3


# ---------------------------------------------------------------------
# the router, the async front end and the HTTP shim under tracing
# ---------------------------------------------------------------------

def test_router_lifecycle_events_and_trace_ids(dense):
    cfg, params = dense
    pool = lambda: PoolConfig(n_slots=2, max_len=MAX_LEN)  # noqa: E731
    flaky = ContinuousEngine(cfg, params, pool(), device="cpu")
    calls = [0]
    orig = flaky.step

    def boom():
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected")
        return orig()

    flaky.step = boom
    router = EngineRouter(
        [EngineReplica("stable", ContinuousEngine(cfg, params, pool(),
                                                  device="cpu")),
         EngineReplica("flaky", flaky)])
    tr = obs.Tracer()
    obs.install(tr)
    try:
        out = router.serve(_requests(cfg, 4))
    finally:
        obs.install(None)
    assert all(len(v) for v in out.values())
    assert len(tr.events("router.submit")) == 4
    assert tr.events("replica.quarantine")[0].attrs["replica"] == "flaky"
    assert tr.events("router.requeue")
    finishes = tr.events("request.finish")
    assert {e.attrs["trace"] for e in finishes} == \
        {f"t{tid}" for tid in out}
    assert all(e.attrs["status"] == "completed" for e in finishes)
    # the engine-side request spans carry the router's ticket trace ids
    req_traces = {s.attrs["trace"] for s in tr.spans("request")}
    assert req_traces <= {f"t{tid}" for tid in out}


def test_frontend_propagates_tracer_into_executor(dense):
    cfg, params = dense
    eng = ContinuousEngine(cfg, params,
                           PoolConfig(n_slots=2, max_len=MAX_LEN),
                           device="cpu")
    router = EngineRouter([EngineReplica("r0", eng)])
    tr = obs.Tracer()

    async def main():
        with repro_torch.use(tracer=tr):
            async with AsyncFrontend(router) as fe:
                handles = [await fe.submit(r)
                           for r in _requests(cfg, 3)]
                return [await h for h in handles]

    results = asyncio.run(main())
    assert all(r.status == "completed" for r in results)
    # spans were recorded from the executor thread, not the loop thread
    prefills = tr.spans("prefill")
    assert prefills
    assert any(s.thread != threading.get_ident() for s in prefills)
    assert len(tr.spans("request")) == 3


def test_frontend_tier_is_the_engines_own(dense):
    """A ``use(backend=...)`` around the front end does not reach the
    executor thread that steps the router; the engine's own ``backend=``
    does."""
    cfg, params = dense
    eng = ContinuousEngine(cfg, params,
                           PoolConfig(n_slots=2, max_len=MAX_LEN),
                           backend="torch", device="cpu")
    router = EngineRouter([EngineReplica("r0", eng)])
    tr = obs.Tracer()
    TELEMETRY.reset()

    async def main():
        with repro_torch.use(backend="cuda", tracer=tr):
            async with AsyncFrontend(router) as fe:
                handle = await fe.submit(_requests(cfg, 1)[0])
                return await handle

    assert asyncio.run(main()).status == "completed"
    assert {e.attrs["backend"] for e in tr.events("dispatch")} == {"torch"}
    TELEMETRY.reset()


def test_http_shim_generate_metrics_and_400(dense):
    import urllib.error
    import urllib.request

    from repro_torch.serve import HttpFrontend

    cfg, params = dense
    eng = ContinuousEngine(cfg, params,
                           PoolConfig(n_slots=2, max_len=MAX_LEN),
                           device="cpu")
    router = EngineRouter([EngineReplica("r0", eng)])
    with HttpFrontend(router) as hf:
        body = json.dumps({"prompt": [1, 2, 3], "max_tokens": 4,
                           "stop_tokens": []}).encode()
        req = urllib.request.Request(
            hf.url + "/generate", data=body,
            headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert out["status"] == "completed"
        assert len(out["tokens"]) == 4
        assert out["ttft_s"] > 0

        met = urllib.request.urlopen(hf.url + "/metrics", timeout=60)
        assert met.headers["Content-Type"].startswith("text/plain")
        text = met.read().decode()
        assert "repro_serve_ttft_seconds_bucket" in text
        assert 'repro_serve_tokens_generated_total{replica="r0"} 4' in text
        assert "repro_serve_requests_rejected_total 0" in text
        assert "repro_op_dispatch_total" in text

        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                hf.url + "/generate", data=b'{"prompt": []}',
                headers={"Content-Type": "application/json"}), timeout=60)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(hf.url + "/nope", timeout=60)
        assert e.value.code == 404


def test_request_from_payload_validation():
    from repro.serve import request_from_payload as jrequest_from_payload
    from repro_torch.serve import request_from_payload
    payload = {"prompt": [1, 2], "max_tokens": 3, "temperature": 0.5,
               "tier": "fp32", "deadline_s": 2.5}
    req, tier, dl = request_from_payload(payload)
    assert req.prompt == [1, 2] and req.temperature == 0.5
    assert tier == "fp32" and dl == 2.5
    jreq, jtier, jdl = jrequest_from_payload(payload)
    assert (vars(req), tier, dl) == (vars(jreq), jtier, jdl)
    for bad in ({"prompt": []}, {"prompt": "hi"}, {"prompt": [1], "x": 1},
                {"prompt": [1], "max_tokens": 0},
                {"prompt": [1], "stop_tokens": "no"}):
        with pytest.raises(ValueError):
            request_from_payload(bad)

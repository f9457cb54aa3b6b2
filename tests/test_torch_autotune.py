"""The port's tuning surface against the JAX package's, on the CPU: block
policies through ``dispatch.resolve_blocks``, the candidate grids, the
measured policy (``core/autotune.py``) under injected costs, and the
tuning cache's persistence.  Case by case ``tests/test_autotune.py``'s,
where the port has the counterpart; the kernels themselves run only on
the card (``tests/test_torch_gpu.py``), so nothing here measures.
"""
import dataclasses
import json
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

import repro
import repro_torch
from repro.core import autotune as jautotune
from repro.core import blocking as jblocking
from repro.core import dispatch as jdispatch
from repro_torch import obs
from repro_torch.core import autotune, blocking, dispatch
from repro_torch.core.blocking import (AttnGeometry, ConvGeometry,
                                       GemmGeometry, Plan)
from repro_torch.kernels.brgemm import kernel as K
from repro_torch.kernels.brgemm import quant_kernel as QK
from repro_torch.kernels.conv2d import kernel as CK
from repro_torch.kernels.flash_attention import bwd as FB
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.models import api
from repro_torch.serve import (ContinuousEngine, Engine, PoolConfig, Request,
                               ServeConfig)
from repro_torch import configs

BF16 = torch.bfloat16
GEMM = GemmGeometry(True)
# (op, triple, dtype, geometry, quant): the GEMM family (stacked and
# batched over 4 entries, each layout), quantized, conv and attention.
CASES = [
    ("matmul", (64, 576, 576), BF16, GEMM, None),
    ("matmul", (4096, 1536, 576), BF16, GemmGeometry(True, 1, True, False),
     None),
    ("matmul", (8, 7168, 20480), BF16, GEMM, None),
    ("matmul", (77, 133, 100), BF16, GemmGeometry(False), None),
    ("matmul", (512, 512, 4096), torch.float32, GemmGeometry(False), None),
    ("brgemm", (128, 128, 128), BF16, GemmGeometry(True, 32), None),
    ("batched_matmul", (64, 256, 64), BF16, GemmGeometry(True, 4, False,
                                                         True), None),
    ("matmul", (8, 576, 1536), torch.int8, GemmGeometry(True, 1, False,
                                                        True), "int8"),
    ("matmul", (64, 576, 4096), torch.float8_e4m3fn,
     GemmGeometry(True, 1, False, True), "fp8"),
    ("brgemm", (64, 64, 256), torch.int8, GemmGeometry(True, 64, False,
                                                       True), "int8"),
    ("batched_matmul", (128, 128, 128), torch.int8,
     GemmGeometry(True, 32, False, True), "int8"),
    ("conv2d", (56, 64, 64), BF16, ConvGeometry(32, 56, 56, 3, 3, 1, 1),
     None),
    ("flash_attention", (512, 512, 64), BF16, AttnGeometry(True), None),
    ("flash_attention_bwd", (512, 512, 64), BF16, AttnGeometry(True), None),
]
IDS = [f"{c[0]}-{'x'.join(map(str, c[1]))}-{c[4] or c[2]}" for c in CASES]


def _heuristic_of(op, m, n, k, dtype, g, quant):
    """The ``plan*`` function's own pick for a case."""
    bf16 = dtype == BF16
    if quant is not None:
        fp8 = dtype != torch.int8
        return {"matmul": lambda: QK.plan_q(m, n, k, g.tma, fp8),
                "brgemm": lambda: QK.plan_q_stacked(g.nb, m, n, k, g.tma,
                                                    fp8),
                "batched_matmul": lambda: QK.plan_q_batched(
                    g.nb, m, n, k, g.tma, fp8)}[op]()
    if op == "conv2d":
        return CK.plan_conv(g.n, g.h, g.w, n, k, g.r, g.s, g.stride,
                            g.padding, bf16, g.aligned)
    if op.startswith("flash"):
        return FK.plan(bf16, g.tma)
    return {"matmul": lambda: K.plan(m, n, k, bf16, g.tma),
            "brgemm": lambda: K.plan_stacked(g.nb, m, n, k, bf16, g.tma),
            "batched_matmul": lambda: K.plan_batched(m, n, k, bf16,
                                                     g.tma)}[op]()


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.delenv(dispatch.TUNING_CACHE_ENV, raising=False)
    dispatch.clear_tuning_cache()
    jdispatch.clear_tuning_cache()
    yield
    dispatch.clear_tuning_cache()
    jdispatch.clear_tuning_cache()


# --------------------------------------------------------------------------
# the heuristic policy and the plans' JSON form
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op,triple,dtype,geometry,quant", CASES, ids=IDS)
def test_heuristic_policy_returns_the_plan_functions_pick(op, triple, dtype,
                                                          geometry, quant):
    got = dispatch.resolve_blocks(op, *triple, dtype, backend="cuda",
                                  geometry=geometry, quant=quant)
    assert got == _heuristic_of(op, *triple, dtype, geometry, quant)
    with repro_torch.use(blocks_policy="heuristic"):
        assert dispatch.resolve_blocks(op, *triple, dtype, backend="cuda",
                                       geometry=geometry,
                                       quant=quant) == got


def test_wrappers_plans_resolve_through_the_cache():
    """The ``*_call`` plans of CPU operands (the kernels untouched) are the
    heuristic's, keyed as the reference keys its entry points: op, the
    triple of one entry, the storage dtype and quant tag."""
    x, w = torch.ones(64, 576, dtype=BF16), torch.ones(576, 1536, dtype=BF16)
    assert K.plan_call(x, w) == K.plan(64, 1536, 576, True, True)
    a, b = torch.ones(4, 64, 32, dtype=BF16), torch.ones(4, 32, 48,
                                                         dtype=BF16)
    assert K.plan_stacked_call(a, b) == K.plan_stacked(4, 64, 48, 32, True,
                                                       True)
    assert K.plan_batched_call(a, b.transpose(-1, -2).contiguous()
                               .transpose(-1, -2)) == K.plan_batched(
        64, 48, 32, True, True)
    xq = torch.ones(8, 576, dtype=torch.int8)
    wq = torch.ones(1536, 576, dtype=torch.int8).T
    assert QK.plan_q_call(xq, wq) == QK.plan_q(8, 1536, 576, True)
    cx, cw = torch.ones(2, 8, 8, 16, dtype=BF16), torch.ones(3, 3, 16, 32,
                                                             dtype=BF16)
    assert CK.plan_conv_call(cx, cw, 1, 1) == CK.plan_conv(
        2, 8, 8, 16, 32, 3, 3, 1, 1, True, True)
    q = torch.ones(1, 2, 32, 64, dtype=BF16)
    assert FK.plan_call(q, q, q) == "wgmma"
    assert FB.plan_call(q, q, q, q, q) == "wgmma"
    keys = dispatch.tuning_cache_info()
    assert {k[0] for k in keys} == {"matmul", "brgemm", "batched_matmul",
                                    "conv2d", "flash_attention",
                                    "flash_attention_bwd"}
    assert ("matmul", "cuda", 8, 1536, 576, "int8", "heuristic",
            GemmGeometry(True, 1, False, True), None,
            repro_torch.QuantConfig().tag()) in keys
    assert ("conv2d", "cuda", 8, 16, 32, "bfloat16", "heuristic",
            ConvGeometry(2, 8, 8, 3, 3, 1, 1, True), None, None) in keys


@pytest.mark.parametrize("plan", [
    Plan("wgmma", 128, 64, 4, 28, 6), Plan("simt", 64, 16, 1, 36, 9),
    "wgmma"])
def test_plan_json_round_trip(plan):
    d = blocking.plan_to_dict(plan)
    assert blocking.plan_from_dict(json.loads(json.dumps(d))) == plan


@pytest.mark.parametrize("geometry", [
    GemmGeometry(True, 4, True, False), ConvGeometry(32, 56, 56, 3, 3, 2, 1,
                                                     False),
    AttnGeometry(False)])
def test_geometry_json_round_trip(geometry):
    d = blocking.geometry_to_dict(geometry)
    got = blocking.geometry_from_dict(json.loads(json.dumps(d)))
    assert got == geometry and type(got) is type(geometry)


# --------------------------------------------------------------------------
# candidate grids
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op,triple,dtype,geometry,quant", CASES, ids=IDS)
def test_candidates_deterministic_heuristic_first(op, triple, dtype,
                                                  geometry, quant):
    c1 = blocking.candidate_grid(op, *triple, dtype, geometry=geometry,
                                 quant=quant)
    c2 = blocking.candidate_grid(op, *triple, dtype, geometry=geometry,
                                 quant=quant)
    assert c1 == c2
    assert len(c1) == len(set(c1))
    assert c1[0] == _heuristic_of(op, *triple, dtype, geometry, quant)
    if op.startswith("flash"):
        assert c1 == [c1[0]]      # the kernels take no other plan
        return
    m, n, k = triple
    for p in c1:
        # what the launchers take at run time without a rebuild
        assert p.splits >= 1 and p.chunk >= 1
        if p.mainloop == "wgmma":
            assert p.bm in ((64,) if quant == "fp8" else (64, 128))
        if op == "batched_matmul":
            assert p.splits == 1
        reduction = (-(-k // p.bk) * (geometry.nb if op == "brgemm" else 1)
                     if op != "conv2d" else 9 * -(-n // 64))
        assert (p.splits - 1) * p.chunk < reduction <= p.splits * p.chunk
    if op in ("matmul", "brgemm") and quant is None and dtype == BF16 \
            and geometry.tma:
        assert {p.mainloop for p in c1} == {"wgmma", "wmma"}
        assert {p.bm for p in c1 if p.mainloop == "wgmma"} == {64, 128}
    if dtype == torch.float32:
        assert {p.mainloop for p in c1} == {"simt"}


def test_split_candidates_follow_per_sm_targets():
    """At llava's decode shape (8 rows, k = 20480, 56 output tiles) the
    grid holds the split counts of one, two and four blocks an SM."""
    grid = K.candidate_plans("matmul", 8, 7168, 20480, True, True)
    splits = {p.splits for p in grid if p.mainloop == "wgmma" and p.bm == 64}
    tiles = -(-7168 // 128)
    want = {K._split(tiles, 20480 // 64, 64, s)[0] for s in K.PER_SM}
    assert splits == want and len(want) == 3


def test_sweep_and_autotuner_share_one_grid():
    """matmul_sweep.py --variants times ``candidate_plans``: the grid the
    autotuner searches for the same call."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import matmul_sweep
    x, w = torch.ones(8, 576, dtype=BF16), torch.ones(49152, 576,
                                                      dtype=BF16).T
    assert matmul_sweep.variants(x, w) == blocking.candidate_grid(
        "matmul", 8, 49152, 576, BF16,
        geometry=GemmGeometry(True, 1, False, True))


# --------------------------------------------------------------------------
# the measured policy
# --------------------------------------------------------------------------

def _seeded_timer(seed):
    """Deterministic fake cost, pseudo-random in the candidate plan."""
    def timer(op, m, n, k, dtype, backend, plan):
        h = hash((seed, op, dataclasses.astuple(plan)))
        return (h % 1000) / 1000.0
    return timer


def test_autotune_deterministic_under_seeded_costs():
    timer = _seeded_timer(42)
    args = ("matmul", 8, 7168, 20480, BF16, "cuda")
    picks = [autotune.autotune_blocks(*args, timer=timer) for _ in range(3)]
    assert picks[0] == picks[1] == picks[2]
    cands = autotune._prune(
        blocking.candidate_grid("matmul", 8, 7168, 20480, BF16),
        blocking.default_plan("matmul", 8, 7168, 20480, BF16),
        autotune.DEFAULT_MAX_CANDIDATES)
    want = min(cands, key=lambda p: timer(*args, p))
    assert picks[0] == want


def test_autotune_measurably_changes_selected_plan():
    heur = blocking.default_plan("matmul", 8, 7168, 20480, BF16)

    def timer(op, m, n, k, dtype, backend, plan):
        return 2.0 if plan == heur else 1.0     # any other plan wins

    with repro_torch.use(blocks_policy=lambda op, m, n, k, dt, be:
                         autotune.autotune_blocks(op, m, n, k, dt, be,
                                                  timer=timer)):
        tuned = dispatch.resolve_blocks("matmul", 8, 7168, 20480, BF16,
                                        backend="cuda")
    assert tuned != heur


def test_autotune_ties_keep_the_earlier_candidate():
    got = autotune.autotune_blocks("matmul", 8, 7168, 20480, BF16, "cuda",
                                   timer=lambda *_: 1.0)
    assert got == blocking.default_plan("matmul", 8, 7168, 20480, BF16)


def test_autotune_survives_failing_candidates():
    heur = blocking.default_plan("matmul", 64, 64, 64, BF16)
    before = autotune.STATS.snapshot()

    def timer(op, m, n, k, dtype, backend, plan):
        raise RuntimeError("launch failed")

    got = autotune.autotune_blocks("matmul", 64, 64, 64, BF16, "cuda",
                                   timer=timer)
    assert got == heur       # falls back to the heuristic's plan
    n = len(blocking.candidate_grid("matmul", 64, 64, 64, BF16))
    assert autotune.STATS.failed == before["failed"] + n
    assert autotune.STATS.measured == before["measured"]


def test_autotune_skips_measurement_off_cuda():
    before = autotune.STATS.snapshot()
    got = autotune.autotune_blocks("matmul", 64, 64, 64, BF16, "torch",
                                   timer=_seeded_timer(0))
    assert got == blocking.default_plan("matmul", 64, 64, 64, BF16)
    assert autotune.STATS.snapshot() == before


def test_autotune_measures_nothing_for_a_grid_of_one():
    before = autotune.STATS.snapshot()
    got = autotune.autotune_blocks(
        "flash_attention", 512, 512, 64, BF16, "cuda",
        geometry=AttnGeometry(True), timer=_seeded_timer(0))
    assert got == "wgmma" and autotune.STATS.snapshot() == before


def test_autotune_caps_candidates_from_the_environment(monkeypatch):
    monkeypatch.setenv(autotune.ENV_MAX_CANDIDATES, "2")
    seen = []
    autotune.autotune_blocks(
        "matmul", 8, 7168, 20480, BF16, "cuda",
        timer=lambda *a: seen.append(a[-1]) or 1.0)
    assert len(seen) == 2
    assert seen[0] == blocking.default_plan("matmul", 8, 7168, 20480, BF16)


def test_autotune_seeds_from_the_nearest_tuned_neighbour():
    """A search at llava's second prefill length starts from the first
    length's winner where its grid makes the same choice."""
    target = autotune._prune(
        blocking.candidate_grid("matmul", 832, 7168, 7168, BF16),
        blocking.default_plan("matmul", 832, 7168, 7168, BF16),
        autotune.DEFAULT_MAX_CANDIDATES)[-1]

    def timer(op, m, n, k, dtype, backend, plan):
        return 0.5 if autotune._same_choice(plan, target) else 1.0

    with repro_torch.use(blocks_policy="autotune"):
        dispatch.BLOCK_POLICIES["autotune"] = lambda *a, **kw: \
            autotune.autotune_blocks(*a, timer=timer, **kw)
        try:
            before = autotune.STATS.snapshot()
            first = dispatch.resolve_blocks("matmul", 832, 7168, 7168, BF16,
                                            backend="cuda")
            assert autotune.STATS.seeded == before["seeded"]
            second = dispatch.resolve_blocks("matmul", 1088, 7168, 7168,
                                             BF16, backend="cuda")
        finally:
            dispatch.BLOCK_POLICIES["autotune"] = autotune.autotune_blocks
    assert first == target
    assert autotune.STATS.seeded == before["seeded"] + 1
    assert autotune._same_choice(second, first)


COST_TABLES = [[3.0, 2.0, 1.0, 4.0], [1.0, 1.0, 0.5, 0.5],
               [None, 2.0, None, 1.5], [None, None, None, None],
               [5.0, 5.0, 5.0, 5.0]]


@pytest.mark.parametrize("costs", COST_TABLES)
def test_autotune_agrees_with_the_reference_under_one_cost_table(costs):
    """The same costs, by position in each package's pruned candidate list
    (None: the launch raises), through both autotuners: the winner's
    position and the SearchStats counts agree."""
    budget = len(costs)

    def run(mod, blocking_mod, grid_args, backend, key):
        grid = mod._prune(blocking_mod(*grid_args[0]), grid_args[1], budget)

        def timer(op, m, n, k, dtype, be, cand):
            cost = costs[grid.index(cand)]
            if cost is None:
                raise RuntimeError("launch failed")
            return cost

        before = mod.STATS.snapshot()
        got = mod.autotune_blocks(*key, max_candidates=budget, timer=timer)
        after = mod.STATS.snapshot()
        return grid.index(got), {k: after[k] - before[k] for k in after}

    jkey = ("matmul", 64, 128, 256, jnp.float32, "pallas")
    jgrid = ((lambda *a: jblocking.candidate_blocks(*a)),
             jblocking.default_blocks("matmul", 64, 128, 256, jnp.float32))
    want = run(jautotune, jgrid[0], [("matmul", 64, 128, 256, jnp.float32),
                                     jgrid[1]], "pallas", jkey)
    tkey = ("matmul", 8, 7168, 20480, BF16, "cuda")
    tgrid = ((lambda *a: blocking.candidate_grid(*a)),
             blocking.default_plan("matmul", 8, 7168, 20480, BF16))
    got = run(autotune, tgrid[0], [("matmul", 8, 7168, 20480, BF16),
                                   tgrid[1]], "cuda", tkey)
    assert got == want


def test_search_stats_view_the_telemetry():
    obs.TELEMETRY.reset()
    autotune.STATS.measured = 3
    assert obs.TELEMETRY.snapshot()["autotune"]["measured"] == 3
    assert autotune.STATS.snapshot() == obs.TELEMETRY.autotune
    obs.TELEMETRY.reset()


def test_tuning_cache_counts_and_traces():
    obs.TELEMETRY.reset()
    tr = obs.Tracer()
    with repro_torch.use(tracer=tr, blocks_policy=lambda op, m, n, k, dt,
                         be, geometry=None: autotune.autotune_blocks(
                             op, m, n, k, dt, be, geometry=geometry,
                             timer=_seeded_timer(1))):
        for _ in range(3):
            dispatch.resolve_blocks("matmul", 8, 7168, 20480, BF16,
                                    backend="cuda")
    snap = obs.TELEMETRY.snapshot()
    assert (snap["cache_hits"], snap["cache_misses"]) == (2, 1)
    assert snap["blocks_source"] == {"custom": 1, "cache-hit": 2}
    events = tr.events("resolve_blocks")
    assert [e.attrs["source"] for e in events] == ["custom", "cache-hit",
                                                   "cache-hit"]
    assert events[0].attrs["m"] == 8 and events[0].attrs["op"] == "matmul"
    search = [s for s in tr.spans() if s.name == "autotune.search"]
    measure = [s for s in tr.spans() if s.name == "autotune.measure"]
    assert len(search) == 1 and len(measure) == snap["autotune"]["measured"]
    assert all(s.parent_id == search[0].span_id for s in measure)
    text = "\n".join(obs.telemetry.prometheus_lines())
    assert "repro_tuning_cache_hits_total 2" in text
    assert f"repro_autotune_measured_total {len(measure)}" in text
    obs.TELEMETRY.reset()


# --------------------------------------------------------------------------
# precedence and scoping
# --------------------------------------------------------------------------

def test_explicit_plan_then_context_policy_then_heuristic():
    mine = Plan("wmma", 64, 32, 1, 18, 9)
    other = Plan("wgmma", 64, 64, 2, 5, 2)
    heur = blocking.default_plan("matmul", 64, 576, 576, BF16)
    args = ("matmul", 64, 576, 576, BF16)
    with repro_torch.use(blocks_policy=lambda *a: other):
        assert dispatch.resolve_blocks(*args, backend="cuda",
                                       plan=mine) == mine
        assert dispatch.resolve_blocks(*args, backend="cuda") == other
        with repro_torch.use(blocks_policy="heuristic"):
            assert dispatch.resolve_blocks(*args, backend="cuda") == heur
        assert dispatch.snapshot()[2] is not None
    assert dispatch.snapshot()[2] is None
    assert dispatch.resolve_blocks(*args, backend="cuda") == heur
    # an explicit plan bypasses the cache
    assert all(k[6] != "explicit" for k in dispatch.tuning_cache_info())
    assert len(dispatch.tuning_cache_info()) == 2


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown blocks_policy"):
        with repro_torch.use(blocks_policy="fastest"):
            pass
    with pytest.raises(ValueError, match="unknown blocks_policy"):
        Engine(configs.get("smollm-135m").reduced(),
               api.init_params(configs.get("smollm-135m").reduced(),
                               device="cpu"),
               ServeConfig(max_len=8), device="cpu", blocks_policy="fast")


def test_restored_carries_the_state_to_another_thread():
    """Autograd runs a CUDA backward on a thread of its own: the state a
    forward snapshots is the one its backward restores."""
    seen = {}
    with repro_torch.use(backend="torch", quant="int8",
                         blocks_policy="heuristic"):
        state = dispatch.snapshot()

    def other():
        seen["before"] = dispatch.snapshot()
        with dispatch.restored(state):
            seen["inside"] = dispatch.snapshot()
        seen["after"] = dispatch.snapshot()

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen["before"] == seen["after"] == (None,) * 6
    assert seen["inside"] == state
    assert state[0] == "torch" and state[2] == "heuristic"


def test_engines_scope_prefill_and_decode(monkeypatch):
    """Both engines run prefill and decode under their blocks_policy."""
    cfg = configs.get("smollm-135m").reduced()
    model = api.init_params(cfg, device="cpu")
    seen = []
    for name in ("prefill", "decode_step"):
        real = getattr(api, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append((_name, dispatch.snapshot()[2]))
            return _real(*a, **kw)
        monkeypatch.setattr(api, name, spy)
    Engine(cfg, model, ServeConfig(max_len=16), device="cpu",
           blocks_policy="autotune").generate(
        {"tokens": torch.zeros(1, 4, dtype=torch.long)}, n_tokens=3,
        stop_tokens=())
    assert seen == [("prefill", "autotune")] + [("decode_step",
                                                 "autotune")] * 2
    seen.clear()
    ce = ContinuousEngine(cfg, model, PoolConfig(n_slots=2, max_len=16),
                          device="cpu", blocks_policy="heuristic")
    ce.serve([Request(prompt=[1, 2, 3], max_tokens=2, stop_tokens=())])
    assert seen[0] == ("prefill", "heuristic")
    assert all(p == "heuristic" for _, p in seen) and len(seen) == 2


# --------------------------------------------------------------------------
# cache persistence
# --------------------------------------------------------------------------

def _resolve_some():
    for op, triple, dtype, geometry, quant in CASES:
        dispatch.resolve_blocks(op, *triple, dtype, backend="cuda",
                                geometry=geometry, quant=quant)


def test_cache_save_load_round_trip(tmp_path):
    path = str(tmp_path / "cache.json")
    _resolve_some()
    assert dispatch.save_cache(path) == len(CASES)
    before = dispatch.tuning_cache_info()
    dispatch.clear_tuning_cache()
    assert dispatch.load_cache(path) == len(CASES)
    assert dispatch.tuning_cache_info() == before


def test_cache_of_another_platform_is_not_loaded(tmp_path):
    path = tmp_path / "cache.json"
    _resolve_some()
    dispatch.save_cache(str(path))
    data = json.loads(path.read_text())
    for e in data["entries"]:
        e["platform"] = "another card"
    path.write_text(json.dumps(data))
    dispatch.clear_tuning_cache()
    assert dispatch.load_cache(str(path)) == 0


def test_corrupt_cache_raises_when_strict_and_warns_otherwise(tmp_path,
                                                              monkeypatch):
    path = tmp_path / "cache.json"
    path.write_text("{not json")
    with pytest.raises(ValueError):
        dispatch.load_cache(str(path))
    monkeypatch.setenv(dispatch.TUNING_CACHE_ENV, str(path))
    dispatch.clear_tuning_cache()
    with pytest.warns(UserWarning, match="corrupt tuning cache"):
        got = dispatch.resolve_blocks("matmul", 64, 64, 64, BF16,
                                      backend="cuda")
    assert got == blocking.default_plan("matmul", 64, 64, 64, BF16)
    assert dispatch.cache_load_errors() == 1


def test_callable_policy_entries_not_persisted(tmp_path):
    path = str(tmp_path / "cache.json")
    with repro_torch.use(blocks_policy=lambda *a: Plan("wmma", 64, 32, 1, 1,
                                                       1)):
        dispatch.resolve_blocks("matmul", 16, 16, 16, BF16, backend="cuda")
    assert dispatch.save_cache(path) == 0


def test_env_cache_written_through_and_reloaded(tmp_path, monkeypatch):
    """The two-process flow: a cold run persists its picks; a fresh process
    (the cache cleared) reloads them and asks its policy nothing."""
    path = str(tmp_path / "cache.json")
    monkeypatch.setenv(dispatch.TUNING_CACHE_ENV, path)
    calls = []

    def counting_policy(op, m, n, k, dtype, backend, geometry=None):
        calls.append(op)
        return blocking.default_plan(op, m, n, k, dtype, geometry=geometry)

    dispatch.register_block_policy("counting", counting_policy)
    geometry = ConvGeometry(32, 56, 56, 3, 3, 1, 1)
    try:
        with repro_torch.use(blocks_policy="counting"):
            first = dispatch.resolve_blocks("conv2d", 56, 64, 64, BF16,
                                            backend="cuda",
                                            geometry=geometry)
        assert calls == ["conv2d"]
        assert json.load(open(path))["entries"]     # written through
        dispatch.clear_tuning_cache()               # a new process
        with repro_torch.use(blocks_policy="counting"):
            second = dispatch.resolve_blocks("conv2d", 56, 64, 64, BF16,
                                             backend="cuda",
                                             geometry=geometry)
        assert calls == ["conv2d"]     # served from the persisted file
        assert second == first
    finally:
        dispatch.BLOCK_POLICIES.pop("counting", None)


def test_load_cache_requires_path(monkeypatch):
    monkeypatch.delenv(dispatch.TUNING_CACHE_ENV, raising=False)
    with pytest.raises(ValueError, match=dispatch.TUNING_CACHE_ENV):
        dispatch.save_cache()
    with pytest.raises(ValueError, match=dispatch.TUNING_CACHE_ENV):
        dispatch.load_cache()


def test_reference_tuning_cache_variable_is_not_read(tmp_path, monkeypatch):
    """``REPRO_TUNING_CACHE`` names the reference's files of TPU tiles."""
    monkeypatch.setenv(jdispatch.TUNING_CACHE_ENV, str(tmp_path / "j.json"))
    assert dispatch.TUNING_CACHE_ENV != jdispatch.TUNING_CACHE_ENV
    dispatch.resolve_blocks("matmul", 64, 64, 64, BF16, backend="cuda")
    assert not (tmp_path / "j.json").exists()


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_cli_without_a_card_raises_unless_asked_for_torch(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.main(["--op", "matmul", "--shape", "8", "576", "576",
                       "--dtype", "bfloat16"])
    autotune.main(["--op", "matmul", "--shape", "8", "576", "576",
                   "--dtype", "bfloat16", "--backend", "torch"])
    out = capsys.readouterr().out
    assert "measured=0" in out and "failed=0" in out
    assert "selected=Plan(mainloop='wgmma'" in out


def test_cli_reports_a_warm_persisted_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(dispatch.TUNING_CACHE_ENV, str(tmp_path / "c.json"))
    for _ in range(2):
        dispatch.clear_tuning_cache()
        autotune.main(["--op", "brgemm", "--shape", "64", "64", "256",
                       "--nb", "64", "--quant", "int8", "--backend",
                       "torch"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all("measured=0" in ln for ln in lines)
    assert "quant=int8:int8:per_channel:per_row:absmax" in lines[0]
    entries = json.load(open(tmp_path / "c.json"))["entries"]
    assert [e["geometry"]["nb"] for e in entries] == [64]
    assert entries[0]["policy"] == "autotune" and entries[0]["dtype"] == \
        "int8"


def test_reference_and_port_cli_report_alike(capsys, monkeypatch):
    # the reference's CLI writes its caps into the environment
    monkeypatch.setenv(jautotune.ENV_MAX_CANDIDATES, "1")
    monkeypatch.setenv(jautotune.ENV_REPEATS, "1")
    jautotune.main(["--op", "matmul", "--shape", "32", "32", "32",
                    "--candidates", "1", "--repeats", "1"])
    autotune.main(["--op", "matmul", "--shape", "32", "32", "32",
                   "--backend", "torch"])
    jline, tline = capsys.readouterr().out.splitlines()
    fields = [ln.split(" selected=")[0].split() + [
        f for f in ln.split() if f.split("=")[0] in ("cache_errors",)]
        for ln in (jline, tline)]
    assert fields[0] == fields[1]
    assert [f.split("=")[0] for f in jline.split(") ")[1].split()] == [
        f.split("=")[0] for f in tline.split(") ")[1].split()]

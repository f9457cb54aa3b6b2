"""The port's ``ContinuousEngine`` against the JAX package's, and its
scheduler.

Reduced smollm-135m (2 layers, d_model 128, fp32), weights made by the
reference from a fixed key and handed over as numpy arrays.  Greedy tokens
must match exactly: those of the reference ``ContinuousEngine`` on the same
pool (run once per pool, in a module fixture, on its default CPU backend)
and those of the port's static ``Engine`` at batch 1.  Sampled serving
cannot match across PRNGs; it is held to determinism under a fixed
``torch.Generator``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import PoolConfig as JPoolConfig
from repro.serve import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.serve import (ContinuousEngine, Engine, PoolConfig, Request,
                               Scheduler, ServeConfig, completed_lengths)

MAX_LEN = 32
PROMPT_LENS = [5, 20, 3, 17, 7]
MAX_TOKENS = [6, 4, 8, 3, 5]
POOLS = {"slotted": {}, "bucketed": {"prefill_bucket": 8}}


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get("smollm-135m").reduced()
    tcfg = tconfigs.get("smollm-135m").reduced()
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    model = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, model


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).tolist() for n in lens]


def _requests(prompts, max_tokens=MAX_TOKENS, cls=Request):
    return [cls(prompt=p, max_tokens=m, stop_tokens=())
            for p, m in zip(prompts, max_tokens)]


@pytest.fixture(scope="module")
def reference(pair):
    """The reference engine's greedy tokens, one run per pool."""
    jcfg, tcfg, jparams, _ = pair
    prompts = _prompts(tcfg, PROMPT_LENS)
    return {name: JContinuousEngine(
        jcfg, jparams, JPoolConfig(n_slots=3, max_len=MAX_LEN, **kw)).serve(
            _requests(prompts, cls=JRequest))
        for name, kw in POOLS.items()}


@pytest.fixture(scope="module")
def static(pair):
    """The port's static engine, one batch-1 generate per request."""
    _, tcfg, _, model = pair
    eng = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN), device="cpu")
    return [eng.generate({"tokens": torch.tensor([p])}, n_tokens=mt,
                         stop_tokens=())[0].tolist()
            for p, mt in zip(_prompts(tcfg, PROMPT_LENS), MAX_TOKENS)]


def _engine(pair, **kw):
    _, tcfg, _, model = pair
    pool = dict(n_slots=3, max_len=MAX_LEN)
    pool.update(kw.pop("pool", {}))
    return ContinuousEngine(tcfg, model, PoolConfig(**pool), device="cpu",
                            **kw)


# ==========================================================================
# parity with the reference and the static engine
# ==========================================================================

@pytest.mark.parametrize("pool", sorted(POOLS))
def test_greedy_matches_reference_and_static(pair, reference, static, pool):
    ce = _engine(pair, pool=POOLS[pool])
    out = ce.serve(_requests(_prompts(pair[1], PROMPT_LENS)))
    assert out == reference[pool]
    assert [out[rid] for rid in sorted(out)] == static
    # slot hygiene: full drain, no leaks, no double accounting
    assert ce.pool.n_free == ce.pool.n_slots
    assert ce.pool.alloc_count == ce.pool.free_count == len(PROMPT_LENS)
    assert not ce.has_work()
    assert (ce.pool.lengths == 0).all() and (ce.pool.positions == 0).all()
    m = ce.metrics
    assert m.tokens_generated == sum(MAX_TOKENS)
    assert m.requests_submitted == m.requests_completed == len(PROMPT_LENS)
    assert m.prefills == len(PROMPT_LENS)
    assert 0.0 < m.occupancy() <= 1.0
    assert m.ttft_count == len(PROMPT_LENS)
    assert m.max_queue_depth == len(PROMPT_LENS)  # all queued before step 1
    assert m.wall_time_s > 0 and m.tokens_per_s() > 0


def test_slot_pool_lives_on_the_engine_device(pair):
    ce = _engine(pair)
    _, tcfg, _, _ = pair
    dh = tcfg.d_model // tcfg.n_heads if tcfg.head_dim is None else \
        tcfg.head_dim
    want = (tcfg.n_layers, 3, tcfg.n_kv_heads, MAX_LEN, dh)
    for leaf in ce.pool.leaves.values():
        assert tuple(leaf.shape) == want and leaf.device.type == "cpu"
    assert ce.pool.kv_bytes() == 2 * int(np.prod(want)) * 4
    # the model's per-layer views alias the stacked leaves
    with torch.inference_mode():
        ce.pool.cache["blocks"][1]["k"][2, 0, 5, 0] = 3.0
    assert ce.pool.leaves["k"][1, 2, 0, 5, 0] == 3.0


def test_request_caches_are_fresh_and_zeroed(pair):
    ce = _engine(pair, pool={"page_size": 8})
    a = ce.pool.request_cache()
    with torch.inference_mode():
        a["blocks"][0]["k"].fill_(1.0)
    b = ce.pool.request_cache()
    assert b["blocks"][0]["k"].abs().sum() == 0
    assert b["blocks"][0]["k"].data_ptr() != a["blocks"][0]["k"].data_ptr()


def test_early_stop_parity(pair, static):
    """A request that hits its stop token finishes early and matches the
    truncated static output."""
    _, tcfg, _, model = pair
    prompts = _prompts(tcfg, PROMPT_LENS)[:2]
    stop = static[0][2]
    cfg_eos = dataclasses.replace(tcfg, eos_token=stop)
    ce = ContinuousEngine(cfg_eos, model, PoolConfig(n_slots=2,
                                                     max_len=MAX_LEN),
                          device="cpu")
    out = ce.serve([Request(prompt=p, max_tokens=m)
                    for p, m in zip(prompts, MAX_TOKENS)])
    for i in range(2):
        n = completed_lengths(np.asarray([static[i]]), (stop,))[0]
        assert out[i] == static[i][:n]
    assert out[0][-1] == stop
    assert ce.scheduler.finished[0].finish_reason == "stop"


def test_completed_lengths():
    ids = np.arange(6).reshape(2, 3)
    assert completed_lengths(ids, ()).tolist() == [3, 3]
    assert completed_lengths(ids, (1,)).tolist() == [2, 3]


@pytest.mark.parametrize("change", [
    {"window": 8}, {"block": "rglru_hybrid"}, {"n_patches": 4}])
def test_bucketing_refused_where_the_reference_refuses(pair, change):
    jcfg, tcfg, _, _ = pair
    jbad = dataclasses.replace(jcfg, **change)
    with pytest.raises(ValueError, match="prefill_bucket"):
        JContinuousEngine(jbad, None, JPoolConfig(n_slots=1, max_len=MAX_LEN,
                                                  prefill_bucket=8))
    with pytest.raises(ValueError, match="prefill_bucket"):
        ContinuousEngine(dataclasses.replace(tcfg, **change), None,
                         PoolConfig(n_slots=1, max_len=MAX_LEN,
                                    prefill_bucket=8), device="cpu")


def test_submit_validation(pair):
    ce = _engine(pair, pool={"n_slots": 1})
    with pytest.raises(ValueError, match="max_len"):
        ce.submit(Request(prompt=[1] * 30, max_tokens=10))
    with pytest.raises(ValueError, match="empty"):
        ce.submit(Request(prompt=[], max_tokens=1))


def test_params_on_another_device_raise(pair):
    _, tcfg, _, model = pair
    with pytest.raises(ValueError, match="params live on"):
        ContinuousEngine(tcfg, model, PoolConfig(n_slots=1, max_len=8),
                         device="meta")


# ==========================================================================
# scheduler (no tensors)
# ==========================================================================

def test_scheduler_fcfs_and_finish_bookkeeping():
    s = Scheduler()
    ids = [s.submit(Request(prompt=[1], max_tokens=2), stop_tokens=(9,))
           for _ in range(3)]
    assert [s.next_waiting().request_id for _ in range(3)] == ids
    assert s.next_waiting() is None
    s = Scheduler()
    rid = s.submit(Request(prompt=[1], max_tokens=3), stop_tokens=(9,))
    st = s.next_waiting()
    s.start(st, slot=0, step=1)
    assert not s.record_token(st, 4, step=1)
    assert st.first_token_step == 1
    assert s.record_token(st, 9, step=2)          # stop token
    assert (st.finish_reason, st.finish_step) == ("stop", 2)
    assert not s.running and s.finished[rid] is st


def test_scheduler_priority_hook():
    s = Scheduler(priority_fn=lambda r: r.priority)
    a = s.submit(Request(prompt=[1], max_tokens=1, priority=0.0))
    b = s.submit(Request(prompt=[1], max_tokens=1, priority=5.0))
    c = s.submit(Request(prompt=[1], max_tokens=1, priority=0.0))
    assert [s.next_waiting().request_id for _ in range(3)] == [b, a, c]


def test_scheduler_max_tokens_finish():
    s = Scheduler()
    s.submit(Request(prompt=[1], max_tokens=2), stop_tokens=())
    st = s.next_waiting()
    s.start(st, slot=0, step=1)
    assert not s.record_token(st, 4, step=1)
    assert s.record_token(st, 5, step=2)
    assert st.finish_reason == "length" and st.generated == [4, 5]


def test_scheduler_cancel_waiting_and_running():
    s = Scheduler()
    a = s.submit(Request(prompt=[1], max_tokens=5), stop_tokens=())
    b = s.submit(Request(prompt=[1], max_tokens=5), stop_tokens=())
    s.start(s.next_waiting(), slot=0, step=1)
    cancelled = s.cancel(b, step=2)
    assert cancelled is not None and cancelled.slot is None
    assert s.queue_depth == 0
    assert (s.finished[b].finish_reason, s.finished[b].finish_step) == (
        "cancelled", 2)
    cancelled = s.cancel(a, step=3)
    assert cancelled is not None and cancelled.slot == 0
    assert not s.running and s.finished[a].finish_reason == "cancelled"
    assert s.cancel(a) is None and s.cancel(99) is None


def test_scheduler_preempt_folds_generated_into_prompt():
    s = Scheduler()
    s.submit(Request(prompt=[1, 2], max_tokens=5), stop_tokens=())
    st = s.next_waiting()
    s.start(st, slot=1, step=1)
    s.record_token(st, 7, step=1, now=3.0)
    s.preempt(st)
    assert tuple(st.request.prompt) == (1, 2, 7) and st.generated == [7]
    assert (st.status, st.slot, st.first_token_time) == ("waiting", None,
                                                         3.0)
    assert s.next_waiting() is st and not s.running


# ==========================================================================
# engine admission, eviction, cancellation, streaming
# ==========================================================================

def test_fifo_admission_under_capacity_pressure(pair):
    ce = _engine(pair, pool={"n_slots": 2})
    ids = [ce.submit(Request(prompt=p, max_tokens=3, stop_tokens=()))
           for p in _prompts(pair[1], [4] * 6, seed=2)]
    while ce.has_work():
        ce.step()
    admits = [ce.scheduler.finished[r].admit_step for r in ids]
    assert admits == sorted(admits)
    assert admits[0] == admits[1] == 1 and admits[2] > admits[1]


def test_priority_admission(pair):
    ce = _engine(pair, pool={"n_slots": 1}, priority_fn=lambda r: r.priority)
    ids = [ce.submit(Request(prompt=p, max_tokens=2, stop_tokens=(),
                             priority=pr))
           for p, pr in zip(_prompts(pair[1], [4] * 3, seed=4),
                            [0.0, 5.0, 0.0])]
    while ce.has_work():
        ce.step()
    admits = {r: ce.scheduler.finished[r].admit_step for r in ids}
    assert admits[ids[1]] < admits[ids[0]] < admits[ids[2]]


def test_finished_requests_evicted_same_step(pair):
    ce = _engine(pair, pool={"n_slots": 1})
    first, second = [ce.submit(Request(prompt=p, max_tokens=3,
                                       stop_tokens=()))
                     for p in _prompts(pair[1], [4, 5], seed=5)]
    finish_step = None
    while ce.has_work():
        done = [rid for rid, _, fin in ce.step() if fin]
        if first in done:
            finish_step = ce.metrics.steps
            assert first not in [s.request_id
                                 for s in ce.scheduler.running.values()]
            assert ce.pool.n_free == 1
    assert ce.scheduler.finished[first].finish_step == finish_step
    assert ce.scheduler.finished[second].admit_step == finish_step + 1


def test_step_events_cover_admission_tokens(pair):
    ce = _engine(pair, pool={"n_slots": 2})
    p = _prompts(pair[1], [4, 5], seed=7)
    one = ce.submit(Request(prompt=p[0], max_tokens=1, stop_tokens=()))
    two = ce.submit(Request(prompt=p[1], max_tokens=3, stop_tokens=()))
    seen = {one: [], two: []}
    while ce.has_work():
        for rid, tok, fin in ce.step():
            seen[rid].append((tok, fin))
    assert seen[one] == [(ce.scheduler.finished[one].generated[0], True)]
    assert [t for t, _ in seen[two]] == ce.scheduler.finished[two].generated
    assert [f for _, f in seen[two]] == [False, False, True]


def test_cancel_waiting_and_running_frees_the_slot(pair):
    ce = _engine(pair, pool={"n_slots": 1})
    p = _prompts(pair[1], [4, 5], seed=11)
    streamed = []
    r1 = ce.submit(Request(prompt=p[0], max_tokens=8, stop_tokens=()),
                   on_token=lambda rid, t, f: streamed.append(t))
    r2 = ce.submit(Request(prompt=p[1], max_tokens=8, stop_tokens=()))
    ce.step()   # r1 running (holds the only slot), r2 waiting
    assert ce.scheduler.n_running == 1 and ce.scheduler.queue_depth == 1
    assert ce.cancel(r2)
    assert ce.scheduler.finished[r2].finish_reason == "cancelled"
    n_streamed = len(streamed)
    assert ce.cancel(r1)
    assert ce.pool.n_free == 1          # freed the same step
    assert not ce.has_work() and ce.metrics.requests_cancelled == 2
    assert not ce._on_token and len(streamed) == n_streamed
    assert (ce._temps == 0).all() and (ce._tokens == 0).all()
    assert not ce.cancel(r1) and not ce.cancel(999)
    out = ce.serve([Request(prompt=p[0], max_tokens=3, stop_tokens=())])
    assert [len(v) for v in out.values()] == [3]
    assert ce.pool.alloc_count == ce.pool.free_count == 2


def test_streaming_on_token_callback(pair):
    ce = _engine(pair, pool={"n_slots": 2})
    order = []
    ids = [ce.submit(Request(prompt=p, max_tokens=mt, stop_tokens=()),
                     on_token=lambda *ev: order.append(ev))
           for p, mt in zip(_prompts(pair[1], [4, 7, 5], seed=9), [5, 3, 4])]
    events = []
    while ce.has_work():
        before = len(order)
        step_events = ce.step()
        events += step_events
        assert order[before:] == step_events   # inside the step, in order
    assert order == events
    for rid in ids:
        assert [t for r, t, _ in order if r == rid] == list(
            ce.scheduler.finished[rid].generated)
        flags = [f for r, _, f in order if r == rid]
        assert flags == [False] * (len(flags) - 1) + [True]
    assert not ce._on_token


# ==========================================================================
# sampling
# ==========================================================================

def _sampled(pair, seed, temperature=0.8, top_k=16, greedy_too=True):
    p = _prompts(pair[1], [5, 6], seed=6)
    reqs = [Request(prompt=p[0], max_tokens=6, temperature=temperature,
                    top_k=top_k, stop_tokens=())]
    if greedy_too:
        reqs.append(Request(prompt=p[1], max_tokens=6, stop_tokens=()))
    ce = _engine(pair, pool={"n_slots": 2})
    return ce.serve(reqs, generator=torch.Generator().manual_seed(seed))


def test_sampling_deterministic_under_a_generator(pair):
    a, b, c = _sampled(pair, 7), _sampled(pair, 7), _sampled(pair, 8)
    assert a == b
    assert a[0] != c[0]
    assert all(0 <= t < pair[1].vocab for v in a.values() for t in v)


def test_temperature_zero_slots_stay_greedy_beside_sampling(pair):
    p = _prompts(pair[1], [5, 6], seed=6)
    eng = Engine(pair[1], pair[3], ServeConfig(max_len=MAX_LEN),
                 device="cpu")
    greedy = eng.generate({"tokens": torch.tensor([p[1]])}, n_tokens=6,
                          stop_tokens=())[0].tolist()
    for seed in (1, 2):
        assert _sampled(pair, seed)[1] == greedy


def test_top_k_one_is_greedy(pair):
    p = _prompts(pair[1], [5, 6], seed=6)
    eng = Engine(pair[1], pair[3], ServeConfig(max_len=MAX_LEN),
                 device="cpu")
    greedy = eng.generate({"tokens": torch.tensor([p[0]])}, n_tokens=6,
                          stop_tokens=())[0].tolist()
    out = _sampled(pair, 3, temperature=5.0, top_k=1, greedy_too=False)
    assert out[0] == greedy

"""The port's paged KV pool, chunked prefill and pooled decode steps
against the JAX package's.

Reduced smollm-135m (2 layers, d_model 128, fp32), weights made by the
reference from a fixed key and handed over as numpy arrays.  Greedy tokens
of each pool must equal those of the reference ``ContinuousEngine`` on the
same pool (run once per pool, in a module fixture, on its default CPU
backend) and those of the port's static ``Engine`` at batch 1.  Logits
band: atol = rtol = 1e-4, as ``tests/test_torch_serve.py``; chunked
against one-shot prefill within the reference's own 2e-4.  int8 pages:
the reference's own test allows one request of five to differ (an int8
rounding can flip a near-tie), and so does this one; the per-page scales
of one step agree within rtol 1e-6 (fp32 absmax over the same values,
computed in other orders).
"""
import jax
import jax.numpy as jnp
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
from repro_torch.models import api as tapi
from repro_torch.serve import (ContinuousEngine, Engine, PagedKVCache,
                               PoolConfig, Request, ServeConfig)

BAND = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 32
PAGE = 8
PROMPT_LENS = [5, 20, 3, 17, 7]
MAX_TOKENS = [6, 4, 8, 3, 5]
POOLS = {
    "paged": {"page_size": PAGE},
    "preempting": {"page_size": 4, "n_pages": 8},
    "chunked": {"page_size": 4, "prefill_chunk": 8},
    "int8": {"page_size": PAGE, "kv_quant": "int8"},
}


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


def _requests(cfg, cls=Request):
    return [cls(prompt=p, max_tokens=m, stop_tokens=())
            for p, m in zip(_prompts(cfg, PROMPT_LENS), MAX_TOKENS)]


@pytest.fixture(scope="module")
def reference(pair):
    """The reference engine's greedy tokens, one run per pool."""
    jcfg, tcfg, jparams, _ = pair
    return {name: JContinuousEngine(
        jcfg, jparams, JPoolConfig(n_slots=3, max_len=MAX_LEN, **kw)).serve(
            _requests(tcfg, JRequest))
        for name, kw in POOLS.items()}


@pytest.fixture(scope="module")
def static(pair):
    _, tcfg, _, model = pair
    eng = Engine(tcfg, model, ServeConfig(max_len=MAX_LEN), device="cpu")
    return [eng.generate({"tokens": torch.tensor([p])}, n_tokens=mt,
                         stop_tokens=())[0].tolist()
            for p, mt in zip(_prompts(tcfg, PROMPT_LENS), MAX_TOKENS)]


def _serve(pair, **pool):
    _, tcfg, _, model = pair
    eng = ContinuousEngine(tcfg, model,
                           PoolConfig(n_slots=3, max_len=MAX_LEN, **pool),
                           device="cpu")
    return eng, eng.serve(_requests(tcfg))


def _drained(eng):
    pool = eng.pool
    assert pool.page_alloc_count == pool.page_free_count
    assert pool.n_free_pages == pool.n_pages
    assert pool.n_free == pool.n_slots
    assert (pool.page_tables == pool.n_pages).all()


# ==========================================================================
# serving parity
# ==========================================================================

@pytest.mark.parametrize("pool", ["paged", "preempting", "chunked"])
def test_greedy_matches_reference_and_static(pair, reference, static, pool):
    eng, out = _serve(pair, **POOLS[pool])
    assert eng.paged and isinstance(eng.pool, PagedKVCache)
    assert out == reference[pool]
    assert [out[rid] for rid in sorted(out)] == static
    _drained(eng)
    if pool == "preempting":
        assert eng.metrics.preemptions > 0
    if pool == "chunked":
        assert eng.metrics.prefill_chunks > 0


def test_int8_pages_match_reference_but_at_most_one(pair, reference):
    eng, out = _serve(pair, **POOLS["int8"])
    assert all(x.dtype == torch.int8 for x in eng.pool.data.values())
    assert all(s.dtype == torch.float32 for s in eng.pool.scales.values())
    match = sum(out[k] == reference["int8"][k] for k in out)
    assert match >= len(out) - 1
    _drained(eng)


def test_kv_bytes_count_pages_and_scales(pair):
    eng, _ = _serve(pair, **POOLS["int8"])
    _, tcfg, _, _ = pair
    n_pages = 3 * MAX_LEN // PAGE
    page = tcfg.n_layers * tcfg.n_kv_heads * PAGE * tcfg.head_dim
    assert eng.pool.kv_bytes() == 2 * (n_pages * page + 4 * n_pages)


def test_chunked_prefill_stalls_decode_at_most_one_step(pair):
    """While a long prompt is chunking, already-running requests keep
    generating one token every step."""
    _, tcfg, _, model = pair
    eng = ContinuousEngine(tcfg, model, PoolConfig(
        n_slots=2, max_len=MAX_LEN, page_size=4, prefill_chunk=4),
        device="cpu")
    prompts = _prompts(tcfg, [3, 20])
    first = eng.submit(Request(prompt=prompts[0], max_tokens=10,
                               stop_tokens=()))
    eng.step()   # request 0 admitted and decoding
    eng.submit(Request(prompt=prompts[1], max_tokens=2, stop_tokens=()))
    first_done = False
    for _ in range(40):
        got = [e for e in eng.step() if e[0] == first]
        if not first_done:
            assert got, "running decode stalled during chunked prefill"
            first_done = any(e[2] for e in got)
        if not eng.has_work():
            break
    assert not eng.has_work() and eng.metrics.prefill_chunks >= 5


def test_cancel_while_staging_frees_slot_and_pages(pair):
    _, tcfg, _, model = pair
    eng = ContinuousEngine(tcfg, model, PoolConfig(
        n_slots=2, max_len=MAX_LEN, page_size=4, prefill_chunk=4),
        device="cpu")
    rid = eng.submit(Request(prompt=_prompts(tcfg, [20])[0], max_tokens=2,
                             stop_tokens=()))
    eng.step()
    assert eng._staging is not None and eng.pool.n_free == 1
    assert eng.cancel(rid)
    assert eng._staging is None and not eng.has_work()
    assert eng.scheduler.finished[rid].finish_reason == "cancelled"
    _drained(eng)


# ==========================================================================
# the page allocator (no compute)
# ==========================================================================

def _pool(pair, **kw):
    return PagedKVCache(pair[1], kw.pop("n_slots", 2), MAX_LEN,
                        page_size=PAGE, device="cpu", **kw)


def test_page_allocator_churn_no_leaks_no_double_free(pair):
    pool = _pool(pair, n_slots=4, n_pages=12)
    rng = np.random.default_rng(0)
    live = {}
    for _ in range(300):
        if live and (rng.random() < 0.4 or pool.n_free == 0):
            slot = rng.choice(sorted(live))
            pool.free(slot)
            del live[slot]
            continue
        slot = pool.alloc()
        if slot is None:
            continue
        n = int(rng.integers(1, MAX_LEN + 1))
        if pool.alloc_pages(slot, -(-n // PAGE)):
            pool.lengths[slot] = n
            live[slot] = n
        else:
            pool.free(slot)   # all-or-nothing: nothing was allocated
    held = sum(int(pool.pages_used[s]) for s in live)
    assert held + pool.n_free_pages == pool.n_pages
    table_ids = [int(p) for s in live
                 for p in pool.page_tables[s][:pool.pages_used[s]]]
    assert len(table_ids) == len(set(table_ids)) == held
    for slot in sorted(live):
        pool.free(slot)
    assert pool.n_free == 4 and pool.n_free_pages == pool.n_pages
    assert pool.alloc_count == pool.free_count
    assert pool.page_alloc_count == pool.page_free_count
    assert pool.fragmentation == 0.0 and pool.page_occupancy == 0.0


def test_page_allocator_double_free_and_overflow_raise(pair):
    pool = _pool(pair)
    slot = pool.alloc()
    assert pool.ensure(slot, 0)
    pool.free(slot)
    with pytest.raises(ValueError, match="double free"):
        pool.free(slot)
    slot = pool.alloc()
    with pytest.raises(ValueError, match="pages_per_slot"):
        pool.alloc_pages(slot, pool.pages_per_slot + 1)
    with pytest.raises(ValueError, match="out of range"):
        pool.free(7)


def test_page_allocator_all_or_nothing_and_lifo(pair):
    pool = _pool(pair, n_pages=4)
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (0, 1)                 # lowest free slot first
    assert pool.alloc_pages(a, 3)
    assert pool.page_tables[a, :3].tolist() == [0, 1, 2]
    assert not pool.alloc_pages(b, 2)      # only 1 free: refuse whole ask
    assert pool.pages_used[b] == 0
    assert pool.alloc_pages(b, 1)
    assert pool.n_free_pages == 0
    pool.free(a)
    assert pool.alloc() == a and pool.alloc_pages(a, 1)
    # LIFO: free pushed the table's pages in order, so its last comes back
    assert pool.page_tables[a, 0] == 2


def test_fragmentation_counts_trailing_page_waste(pair):
    pool = _pool(pair)
    slot = pool.alloc()
    assert pool.ensure(slot, PAGE)          # 2 pages for position 8
    pool.lengths[slot] = PAGE + 1           # 9 live tokens in 16 capacity
    assert pool.fragmentation == pytest.approx(1 - 9 / 16)


def test_pool_validation(pair):
    _, tcfg, _, model = pair
    with pytest.raises(ValueError, match="kv_quant requires page_size"):
        ContinuousEngine(tcfg, model, PoolConfig(n_slots=2, max_len=MAX_LEN,
                                                 kv_quant="int8"),
                         device="cpu")
    with pytest.raises(ValueError, match="multiple of page_size"):
        ContinuousEngine(tcfg, model, PoolConfig(
            n_slots=2, max_len=MAX_LEN, page_size=8, prefill_chunk=12),
            device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ContinuousEngine(tcfg, model, PoolConfig(
            n_slots=2, max_len=MAX_LEN, prefill_bucket=8, prefill_chunk=8),
            device="cpu")
    with pytest.raises(ValueError, match="only 'int8'"):
        _pool(pair, kv_quant="fp8")
    with pytest.raises(ValueError, match="cannot hold even one full slot"):
        _pool(pair, n_pages=2)


@pytest.mark.parametrize("change", [{"window": 8}, {"n_patches": 4}])
def test_paging_and_chunks_refused_where_the_reference_refuses(pair, change):
    import dataclasses
    jcfg, tcfg, _, model = pair
    jbad, tbad = (dataclasses.replace(c, **change) for c in (jcfg, tcfg))
    assert japi.supports_paging(jbad) is tapi.supports_paging(tbad) is False
    assert japi.supports_paging(jcfg) is tapi.supports_paging(tcfg) is True
    with pytest.raises(ValueError, match="paging is not supported"):
        PagedKVCache(tbad, 2, MAX_LEN, page_size=PAGE, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk is not supported"):
        ContinuousEngine(tbad, model, PoolConfig(n_slots=2, max_len=MAX_LEN,
                                                 prefill_chunk=8),
                         device="cpu")


# ==========================================================================
# chunked prefill and the pooled decode steps, logits against the reference
# ==========================================================================

def test_chunked_prefill_logits_match_reference_and_one_shot(pair):
    jcfg, tcfg, jparams, model = pair
    prompt = _prompts(tcfg, [19], seed=2)[0]
    jcache = japi.init_cache(jcfg, 1, MAX_LEN)
    tcache = tapi.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    pos = 0
    with torch.inference_mode():
        for chunk in (prompt[0:8], prompt[8:16], prompt[16:19]):
            jl, jcache = japi.prefill_chunk(
                jparams, {"tokens": jnp.asarray([chunk], jnp.int32)}, jcfg,
                jcache, pos)
            tl, tcache = tapi.prefill_chunk(
                model, {"tokens": torch.tensor([chunk])}, tcfg, tcache, pos)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BAND)
            pos += len(chunk)
        for key in tapi.KEYS:
            np.testing.assert_allclose(
                tapi.stack_layers(tcache)[key].numpy(),
                np.asarray(jcache["blocks"][key]), **BAND)
        one_shot, _ = tapi.prefill(
            model, {"tokens": torch.tensor([prompt])}, tcfg,
            tapi.init_cache(tcfg, 1, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), one_shot.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_prefill_logit_pos_picks_the_prompt_end(pair):
    jcfg, tcfg, jparams, model = pair
    prompt = _prompts(tcfg, [6], seed=4)[0] + [0, 0]
    jl, _ = japi.prefill(jparams, {"tokens": jnp.asarray([prompt])}, jcfg,
                         japi.init_cache(jcfg, 1, MAX_LEN),
                         logit_pos=jnp.int32(5))
    with torch.inference_mode():
        tl, _ = tapi.prefill(model, {"tokens": torch.tensor([prompt])}, tcfg,
                             tapi.init_cache(tcfg, 1, MAX_LEN, device="cpu"),
                             logit_pos=5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BAND)


def _kv(rng, shape, dtype=np.float32):
    return {key: rng.normal(size=shape).astype(dtype) for key in tapi.KEYS}


def test_decode_step_slots_matches_reference(pair):
    jcfg, tcfg, jparams, model = pair
    rng = np.random.default_rng(5)
    shape = tapi.kv_shape(tcfg, 3, MAX_LEN)
    kv = _kv(rng, shape)
    tokens = rng.integers(0, tcfg.vocab, (3, 1)).astype(np.int32)
    positions = np.array([4, 17, 0], np.int32)
    jl, jcache = japi.decode_step_slots(
        jparams, jnp.asarray(tokens), jcfg,
        {"blocks": {k: jnp.asarray(v) for k, v in kv.items()}},
        jnp.asarray(positions),
        batch_axes=japi.cache_batch_axes(jcfg, MAX_LEN))
    leaves = {k: torch.tensor(v) for k, v in kv.items()}
    with torch.inference_mode():
        tl, _ = tapi.decode_step_slots(model, torch.tensor(tokens), tcfg,
                                       tapi.layer_views(leaves), positions)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BAND)
    for key in tapi.KEYS:
        np.testing.assert_allclose(leaves[key].numpy(),
                                   np.asarray(jcache["blocks"][key]), **BAND)
        # only each slot's own position changed
        changed = np.argwhere(leaves[key].numpy() != kv[key])
        assert {(s, t) for s, t in changed[:, [1, 3]]} == {
            (s, int(positions[s])) for s in range(3)}


# page tables of three slots in a pool of 10 pages of 4 (8 a slot): slot 0
# at position 9 (3 pages), slot 1 at 4 (2 pages, its second page just
# allocated by ensure), slot 2 free (all sentinels).  Pages 0 and 9 (the
# page a sentinel clips to) belong to no slot.
N_PAGES, PS = 10, 4
TABLES = np.full((3, MAX_LEN // PS), N_PAGES, np.int32)
TABLES[0, :3] = [3, 7, 1]
TABLES[1, :2] = [5, 2]
POSITIONS = np.array([9, 4, 0], np.int32)


def _paged_data(tcfg, rng, quant):
    shape = tapi.kv_shape(tcfg, N_PAGES, PS)
    if quant:
        data = {k: rng.integers(-127, 128, shape).astype(np.int8)
                for k in tapi.KEYS}
        scales = {k: rng.uniform(0.01, 0.05, N_PAGES).astype(np.float32)
                  for k in tapi.KEYS}
        return data, scales
    return _kv(rng, shape), None


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_decode_step_paged_matches_reference(pair, quant):
    jcfg, tcfg, jparams, model = pair
    rng = np.random.default_rng(6)
    data, scales = _paged_data(tcfg, rng, quant)
    tokens = rng.integers(0, tcfg.vocab, (3, 1)).astype(np.int32)
    jl, jdata, jscales = japi.decode_step_paged(
        jparams, jnp.asarray(tokens), jcfg,
        {"blocks": {k: jnp.asarray(v) for k, v in data.items()}},
        jnp.asarray(TABLES), jnp.asarray(POSITIONS),
        batch_axes=japi.cache_batch_axes(jcfg, MAX_LEN),
        time_axes=japi.cache_time_axes(jcfg), page_size=PS,
        scales=(tuple(jnp.asarray(scales[k]) for k in tapi.KEYS)
                if quant else None),
        view_dtypes=(jnp.float32,) * 2 if quant else None)
    tdata = {k: torch.tensor(v) for k, v in data.items()}
    tscales = ({k: torch.tensor(v) for k, v in scales.items()} if quant
               else None)
    with torch.inference_mode():
        tl, _, _ = tapi.decode_step_paged(
            model, torch.tensor(tokens), tcfg, tdata, TABLES, POSITIONS,
            page_size=PS, scales=tscales)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BAND)
    for i, key in enumerate(tapi.KEYS):
        want = np.asarray(jdata["blocks"][key])
        if quant:
            np.testing.assert_allclose(tscales[key].numpy(),
                                       np.asarray(jscales[i]), rtol=1e-6)
            # one int8 step at most, where a value sits on a rounding edge
            assert np.abs(tdata[key].numpy().astype(int) - want).max() <= 1
        else:
            np.testing.assert_allclose(tdata[key].numpy(), want, **BAND)
        # pages of no slot (0, the sentinels' clip target 9, ...) untouched
        for page in (0, 4, 6, 8, 9):
            np.testing.assert_array_equal(tdata[key].numpy()[:, page],
                                          data[key][:, page])
            if quant:
                assert tscales[key][page] == scales[key][page]


def test_pages_to_view_round_trip_and_reference_layout():
    rng = np.random.default_rng(0)
    view = rng.normal(size=(2, 1, 3, 16, 8)).astype(np.float32)
    want = japi.view_to_pages(jnp.asarray(view), 1, 3, 4)   # (2,4,3,4,8)
    pages = tapi.view_to_pages(torch.tensor(view[:, 0]), 4)
    assert tuple(pages.shape) == (2, 4, 3, 4, 8)
    np.testing.assert_array_equal(pages.numpy(), np.asarray(want))
    back = tapi.pages_to_view(pages)
    np.testing.assert_array_equal(back.numpy(), view[:, 0])

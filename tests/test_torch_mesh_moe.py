"""Expert-parallel MoE training, microbatches and gradient compression on a
mesh of the running world, in gloo worlds on the CPU, held to the JAX
package.

grok-1-314b's reduced config (4 layers, 4 experts, top-2, ``moe_d_ff``
64) trains on (1, 2) (expert parallelism: 2 experts a rank), (2, 1)
(ZeRO-3 over the expert stacks, one routing group a batch row local to
its data rank, the aux losses reduced over the data axis) and (2, 2); with
3 experts on (1, 2) the experts' F goes on the model axis instead (the
reference's few-experts fallback).  Each run starts from the reference's
initial state (a checkpoint it wrote) and is held, loss and load-balance
loss at every step, to the reference's ``make_train_step`` on one device
with the same options within ``BAND`` (the reference's own mesh test
fails: ROADMAP queue 3, fault 1).  A world runs its configurations one
after the other in the same ranks: (2, 2) also with ``microbatches=2``
and with int8 gradient compression, (2, 1) smollm-135m with each, and
(2, 2) writes a checkpoint that (1, 2) and (2, 1) restore.  Each rank
imports this module, so its top level stays free of JAX.
"""
import ast
import contextlib
import dataclasses
import json
import math
import time

import numpy as np
import pytest
import torch

from repro_torch import configs, obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.core import dispatch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import parallel
from repro_torch.launch import train
from repro_torch.sharding import local

STEPS, BATCH, SEQ = 4, 4, 32     # steps 2 and 3 follow updates
BAND = dict(rtol=2e-3, atol=2e-3)  # the reference's mesh test's band
GROK = "grok-1-314b"
# name -> (config, options of make_train_step)
RUNS = {
    "grok": ("grok", {}),
    "fallback": ("grok3", {}),
    "grok_mb2": ("grok", {"microbatches": 2}),
    "grok_int8": ("grok", {"grad_compression": "int8"}),
    "smollm_mb2": ("smollm", {"microbatches": 2}),
    "smollm_int8": ("smollm", {"grad_compression": "int8"}),
}
# world -> the runs its ranks make, in order
WORLDS = {
    (1, 1): ("grok",),
    (1, 2): ("grok", "fallback"),
    (2, 1): ("grok", "smollm_mb2", "smollm_int8"),
    (2, 2): ("grok", "grok_mb2", "grok_int8"),
}
RESTORED = ((1, 2), (2, 1))      # restore the checkpoint (2, 2) writes


def _cfg(name, module=configs):
    if name == "smollm":
        return module.get("smollm-135m").reduced()
    cfg = module.get(GROK).reduced()
    return dataclasses.replace(cfg, n_experts=3) if name == "grok3" else cfg


def _tag(world):
    return f"{world[0]}x{world[1]}"


def _spy():
    """The plain matmul, flash forward and batched GEMM resolving their
    plans from their operands, as the card's wrappers do."""
    from repro_torch.kernels.brgemm import kernel as K
    mm = dispatch._REGISTRY["matmul"]["torch"]
    fa = dispatch._REGISTRY["flash_attention"]["torch"]
    bm = dispatch._REGISTRY["batched_matmul"]["torch"]

    def matmul(x, w, *args, **kw):
        K.plan_call(x.reshape(-1, x.size(-1)), w)
        return mm(x, w, *args, **kw)

    def flash(q, k, v, *args, **kw):
        dispatch.resolve_blocks("flash_attention", q.size(2), k.size(2),
                                q.size(3), q.dtype, backend="cuda")
        return fa(q, k, v, *args, **kw)

    def batched(a, b, *args, **kw):
        K.plan_batched_call(a, b)
        return bm(a, b, *args, **kw)

    dispatch._REGISTRY["matmul"]["torch"] = matmul
    dispatch._REGISTRY["flash_attention"]["torch"] = flash
    dispatch._REGISTRY["batched_matmul"]["torch"] = batched


@contextlib.contextmanager
def _probes():
    """The first step's expert ids (each MoE layer's ``route``) and the
    gradients the optimizer is handed first, by name."""
    from repro_torch.layers import moe
    from repro_torch.train import optimizer
    route, update = moe.route, optimizer.adamw_update
    got = {"ids": [], "grads": None}

    def routed(*args, **kw):
        out = route(*args, **kw)
        if got["grads"] is None:
            got["ids"].append(out[3].tolist())
        return out

    def adamw(grads, *args, **kw):
        if got["grads"] is None:
            got["grads"] = {n: g.float().tolist() for n, g in grads.items()
                            if n.endswith("moe.router")}
        return update(grads, *args, **kw)

    moe.route, optimizer.adamw_update = routed, adamw
    try:
        yield got
    finally:
        moe.route, optimizer.adamw_update = route, update


def _train(run, init, mesh):
    """One run of RUNS from the reference's initial state: each step's
    loss and load-balance loss, the first step's forward triples, expert
    ids and router gradients; and the state."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    name, options = RUNS[run]
    cfg = _cfg(name)
    state, _ = CheckpointManager(init).restore(cfg, device="cpu", mesh=mesh)
    step = ts.make_train_step(cfg, opt.AdamWCfg(), mesh=mesh, **options)
    pipe = TokenPipeline(cfg, ShapeCfg("t", "train", SEQ, BATCH), seed=0)
    tracer, rec = obs.Tracer(), {"losses": [], "lb": []}
    try:
        with _probes() as got:
            for i in range(STEPS):
                with dispatch.use(tracer=tracer) if i == 0 else \
                        contextlib.nullcontext():
                    state, metrics = step(state, next(pipe))
                rec["losses"].append(float(metrics["loss"]))
                rec["lb"].append(float(metrics.get("load_balance_loss",
                                                   math.nan)))
    finally:
        pipe.close()
    rec.update(triples=train.forward_triples(tracer), ids=got["ids"],
               router_grads=got["grads"])
    return rec, state


def _restore(ckpt, mesh):
    """The checkpoint (2, 2) wrote, restored on this world's mesh: every
    shard is its slice of the saved leaf, and gathered whole they are
    equal.  Returns the step."""
    cfg = _cfg("grok")
    mgr = CheckpointManager(ckpt)
    state, step = mgr.restore(cfg, device="cpu", mesh=mesh)
    whole, _ = mgr.restore(cfg, device="cpu")
    layout = parallel.Layout(cfg, mesh)
    back = parallel.gather_state(state, cfg, mesh)
    for key in ("m", "v", "master"):
        for name, t in state["opt"][key].items():
            assert torch.equal(t, layout.shard(name, whole["opt"][key][name]))
            assert torch.equal(back["opt"][key][name],
                               whole["opt"][key][name]), (key, name)
    return step


COMPRESS_GROUPS = {"blocks.0.w": "blocks.w", "blocks.1.w": "blocks.w"}


def _compress_grads_whole():
    """Three gradients, two of them one stacked leaf of the reference's
    tree (one int8 scale between them)."""
    gen = torch.Generator().manual_seed(5)
    return {"blocks.0.w": torch.randn(8, 6, generator=gen),
            "blocks.1.w": 3 * torch.randn(8, 6, generator=gen),
            "head": torch.randn(8, 6, generator=gen)}


def _compress_shards(rank):
    """This rank's quarter of each gradient's rows, compressed with the
    scale of the whole (``ax``: the world) and dequantized."""
    from repro_torch.distributed import collectives as C
    world = C.AxisGroup("world", None, 4, rank)
    shards = {n: g[2 * rank:2 * rank + 2]
              for n, g in _compress_grads_whole().items()}
    q, scales = C.compress_grads(shards, kind="int8", groups=COMPRESS_GROUPS,
                                 ax=world)
    return {n: t.tolist() for n, t in C.decompress_grads(
        q, scales, kind="int8").items()}


def _rank_main(rank, world, store, tmp):
    """One spawned rank: join the world, make its runs, write its
    records, leave."""
    import pathlib
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    tmp = pathlib.Path(tmp)
    torch.set_num_threads(1)        # nine ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world[0] * world[1])
    try:
        _spy()
        mesh = make_mesh(world, ("data", "model"))
        out = {}
        for run in WORLDS[world]:
            out[run], state = _train(run, tmp / f"init_{RUNS[run][0]}",
                                     mesh)
            if world == (2, 2) and run == "grok":
                cfg = _cfg("grok")
                CheckpointManager(tmp / "ckpt").save(STEPS, state, cfg=cfg,
                                                     mesh=mesh)
                (tmp / "ckpt_done").touch()
        if world == (2, 2):
            out["compressed"] = _compress_shards(rank)
        if world in RESTORED:
            deadline = time.time() + 300
            while not (tmp / "ckpt_done").exists():
                assert time.time() < deadline, "no checkpoint from 2x2"
                time.sleep(0.1)
            out["restored_step"] = _restore(tmp / "ckpt", mesh)
        (tmp / f"{_tag(world)}.{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _reference(run, jcfg, jstate):
    """The reference's ``make_train_step`` with RUN's options on one
    device: each step's loss and load-balance loss."""
    import jax
    from repro.configs.shapes import ShapeCfg as JShapeCfg
    from repro.data.pipeline import TokenPipeline as JTokenPipeline
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    step = jax.jit(jts.make_train_step(jcfg, jopt.AdamWCfg(),
                                       **RUNS[run][1]))
    pipe = JTokenPipeline(jcfg, JShapeCfg("t", "train", SEQ, BATCH), seed=0)
    losses, lb = [], []
    try:
        for _ in range(STEPS):
            jstate, metrics = step(jstate, next(pipe))
            losses.append(float(metrics["loss"]))
            lb.append(float(metrics.get("load_balance_loss", math.nan)))
    finally:
        pipe.close()
    return {"losses": losses, "lb": lb}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's records (started first), the reference's runs (made
    while the worlds train) and the port's meshless run of grok."""
    import jax
    from repro import configs as jconfigs
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    tmp = tmp_path_factory.mktemp("moe_worlds")
    jstates = {}
    for name in ("grok", "grok3", "smollm"):
        jstates[name] = jts.init_state(jax.random.PRNGKey(0),
                                       _cfg(name, jconfigs), jopt.AdamWCfg())
        JManager(tmp / f"init_{name}").save(0, jstates[name])
    ctx = torch.multiprocessing.get_context("spawn")
    procs = []
    for world in WORLDS:
        n = world[0] * world[1]
        for rank in range(n):
            p = ctx.Process(target=_rank_main, args=(
                rank, world, str(tmp / f"store_{_tag(world)}"), str(tmp)))
            p.start()
            procs.append((world, rank, p))
    try:
        ref = {run: _reference(run, _cfg(RUNS[run][0], jconfigs),
                               jstates[RUNS[run][0]]) for run in RUNS}
        saved = {op: dict(dispatch._REGISTRY[op]) for op in
                 ("matmul", "flash_attention", "batched_matmul")}
        try:
            _spy()
            meshless = {run: _train(run, tmp / f"init_{RUNS[run][0]}",
                                    None)[0] for run in ("grok", "fallback")}
        finally:
            for op, entries in saved.items():
                dispatch._REGISTRY[op].update(entries)
    finally:
        failed = []
        for world, rank, p in procs:
            p.join(300)
            if p.is_alive():
                p.kill()
                failed.append((world, rank, "timed out"))
            elif p.exitcode != 0:
                failed.append((world, rank, p.exitcode))
    assert not failed, failed
    records = {(world, rank): json.loads(
        (tmp / f"{_tag(world)}.{rank}.json").read_text())
        for world, rank, _ in procs}
    return {"ref": ref, "records": records, "meshless": meshless}


CASES = [(world, run) for world, names in WORLDS.items() for run in names]


@pytest.mark.parametrize("world,run", CASES,
                         ids=[f"{_tag(w)}-{r}" for w, r in CASES])
def test_world_matches_the_reference_single_device(runs, world, run):
    """Losses and load-balance losses at every step, within BAND of the
    reference's one-device run with the same options."""
    got, want = runs["records"][(world, 0)][run], runs["ref"][run]
    assert len(got["losses"]) == len(want["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], **BAND)
    if RUNS[run][0] != "smollm":
        np.testing.assert_allclose(got["lb"], want["lb"], **BAND)


def test_one_rank_world_is_the_meshless_step(runs):
    got, want = runs["records"][((1, 1), 0)]["grok"], runs["meshless"]["grok"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["lb"], want["lb"], rtol=0, atol=1e-6)
    for run in ("grok", "fallback"):
        np.testing.assert_allclose(runs["meshless"][run]["losses"],
                                   runs["ref"][run]["losses"], **BAND)


@pytest.mark.parametrize("world,run", [((1, 2), "grok"), ((2, 2), "grok"),
                                       ((1, 2), "fallback")])
def test_router_gradient_is_equal_on_the_model_ranks(runs, world, run):
    """The router, which the model axis replicates, gets the same gradient
    on both model ranks: the gates' and the experts' input's partial
    gradients are summed over the axis before they reach it."""
    for d in range(world[0]):
        a = runs["records"][(world, 2 * d)][run]["router_grads"]
        b = runs["records"][(world, 2 * d + 1)][run]["router_grads"]
        assert sorted(a) == sorted(b) and len(a) == 4
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])


PROBED = [((1, 2), "grok"), ((2, 1), "grok"), ((2, 2), "grok"),
          ((1, 2), "fallback")]


@pytest.mark.parametrize("world,run", PROBED,
                         ids=[f"{_tag(w)}-{r}" for w, r in PROBED])
def test_rank0_routes_its_rows_as_one_rank_does(runs, world, run):
    """Rank 0's expert ids on the first step are the one-rank run's for
    its rows (a routing group is a row); a near-tie that flips fails."""
    got = runs["records"][(world, 0)][run]["ids"]
    want = runs["meshless"][run]["ids"]
    rows = BATCH // world[0]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g == w[:rows]


@pytest.mark.parametrize("world,run", PROBED,
                         ids=[f"{_tag(w)}-{r}" for w, r in PROBED])
def test_rank0_resolves_the_local_problems(runs, world, run):
    """Rank 0's forward triples are ``local_problem`` of the one-rank
    run's, in call order, each keyed with the mesh signature and under
    the axes its event names.  One exception to the reference's
    abstract-mesh rule for ``batched_matmul`` (``(dp, model, None)``,
    which would shard the expert GEMM's n): under expert parallelism the
    model axis splits the expert entries, which lie outside the triple,
    so a rank runs (its rows, F, D) and (its rows, D, F) over E/m entries,
    and keys them with the axes ``(dp, None, None)``; so does the router,
    which the model axis replicates.  Every other call follows the dense
    rules (the fallback's down projection is a row-parallel one)."""
    want = runs["meshless"][run]["triples"]
    got = runs["records"][(world, 0)][run]["triples"]
    mesh = local.abstract_mesh(world, ("data", "model"))
    assert got and len(got) == len(want)
    dp_rows = repr((("pod", "data"), None, None))
    batched = [g.get("axes") for g in got if g["op"] == "batched_matmul"]
    for g, w in zip(got, want):
        assert g["op"] == w["op"] and "mesh" not in w
        assert g["mesh"] == str(("data", "model"))
        specs = ({g["op"]: ast.literal_eval(g["axes"])} if "axes" in g
                 else None)
        assert (g["m"], g["n"], g["k"]) == local.local_problem(
            w["op"], w["m"], w["n"], w["k"], mesh, specs), (g, w)
    layers = 4
    assert len(batched) == 3 * layers
    if world[1] == 1:
        assert batched == [None] * (3 * layers)
    elif run == "grok":       # expert parallelism
        assert batched == [dp_rows] * (3 * layers)
    else:                     # F on the model axis: gate, up, down
        assert batched == [None, None, repr(
            (("pod", "data"), None, "model"))] * layers


def test_checkpoint_written_at_2x2_restores_on_other_meshes(runs):
    for world in RESTORED:
        for rank in range(world[0] * world[1]):
            assert runs["records"][(world, rank)]["restored_step"] == STEPS


@pytest.mark.parametrize("run", WORLDS[(2, 2)])
def test_every_rank_reports_the_global_metrics(runs, run):
    recs = runs["records"]
    for rank in range(1, 4):
        for key in ("losses", "lb"):
            assert recs[((2, 2), rank)][run][key] == \
                recs[((2, 2), 0)][run][key]


def test_int8_compression_takes_the_scale_of_the_whole(runs):
    """Each rank's shard, compressed over the world, is the slice of the
    whole compressed on one device (one absmax scale a stacked leaf)."""
    from repro_torch.distributed import collectives as C
    whole = _compress_grads_whole()
    want = C.decompress_grads(*C.compress_grads(
        whole, kind="int8", groups=COMPRESS_GROUPS), kind="int8")
    for rank in range(4):
        got = runs["records"][((2, 2), rank)]["compressed"]
        for name, t in want.items():
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          t[2 * rank:2 * rank + 2].numpy())

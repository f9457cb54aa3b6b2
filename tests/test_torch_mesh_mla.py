"""MLA and a VLM's patch projection trained data x model parallel on a mesh
of the running world, in gloo worlds on the CPU, held to the JAX package.

Three reduced configs: smollm-135m with ``mla=True`` (dense MLA),
deepseek-v3-671b (a dense MLA block, MoE MLA blocks on 4 experts and the
MTP block) and llava-next-34b (its patch projection before the tokens).
The worlds (1, 2), (2, 1) and (2, 2) each train all three in one set of
ranks ((1, 2) deepseek-v3 also under ``remat``, whose backward reruns
the blocks' gathers), from the reference's initial state (a checkpoint it
wrote), and
every step's ``loss``, ``ce_loss``, ``mtp_loss`` and
``load_balance_loss`` is held within ``BAND`` of the reference's
``make_train_step`` on one device.  The first step's gradients that
AdamW receives are held, leaf by leaf, to the port's meshless step's
(each rank's shard of them) within relative L2 ``GRAD_REL``; and on (1,
2) and (2, 2) the MLA layer and ``VisionProj`` alone, split over the
model axis, give the output and every parameter's gradient of one rank's
whole layer (``q_norm``, ``kv_norm``, ``wq_a``, ``wkv_a``, ``b1`` and
``b2`` among them).  Each rank imports this module, so its top level
stays free of JAX.
"""
import ast
import contextlib
import dataclasses
import json
import math

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

STEPS, BATCH, SEQ = 3, 4, 16     # step 2 follows an update (lr 0 at step 0)
BAND = dict(rtol=2e-3, atol=2e-3)  # the reference's mesh test's band
GRAD_REL = 1e-4                  # fp32: the sums' order alone
NAMES = ("mla", "deepseek", "llava")
METRICS = ("loss", "ce_loss", "mtp_loss", "load_balance_loss")
WORLDS = ((1, 2), (2, 1), (2, 2))
# world -> its runs: a run is a name of NAMES, or "<name>_remat" (the
# config with remat=True, held to the name's reference and gradients)
RUNS = {world: NAMES for world in WORLDS}
RUNS[(1, 2)] = NAMES + ("deepseek_remat",)
LAYER_WORLDS = ((1, 2), (2, 2))  # the layers alone, split over the model axis


def _base(run):
    return run.removesuffix("_remat")


def _cfg(name, module=configs):
    if name.endswith("_remat"):
        return dataclasses.replace(_cfg(_base(name), module), remat=True)
    if name == "mla":
        return dataclasses.replace(module.get("smollm-135m"),
                                   mla=True).reduced()
    return module.get({"deepseek": "deepseek-v3-671b",
                       "llava": "llava-next-34b"}[name]).reduced()


def _tag(world):
    return f"{world[0]}x{world[1]}"


def _spy():
    """The plain matmul and flash forward resolving their plans from their
    operands, as the card's wrappers do."""
    from repro_torch.kernels.brgemm import kernel as K
    mm = dispatch._REGISTRY["matmul"]["torch"]
    fa = dispatch._REGISTRY["flash_attention"]["torch"]

    def matmul(x, w, *args, **kw):
        K.plan_call(x.reshape(-1, x.size(-1)), w)
        return mm(x, w, *args, **kw)

    def flash(q, k, v, *args, **kw):
        dispatch.resolve_blocks("flash_attention", q.size(2), k.size(2),
                                q.size(3), q.dtype, backend="cuda")
        return fa(q, k, v, *args, **kw)

    dispatch._REGISTRY["matmul"]["torch"] = matmul
    dispatch._REGISTRY["flash_attention"]["torch"] = flash


@contextlib.contextmanager
def _first_grads():
    """The gradients AdamW is handed first, by name (fp32 copies)."""
    from repro_torch.train import optimizer
    update = optimizer.adamw_update
    got = {}

    def adamw(grads, *args, **kw):
        if not got:
            got.update({n: g.detach().float().clone()
                        for n, g in grads.items()})
        return update(grads, *args, **kw)

    optimizer.adamw_update = adamw
    try:
        yield got
    finally:
        optimizer.adamw_update = update


def _train(name, init, mesh):
    """STEPS steps of NAME's config from the reference's initial state on
    ``mesh`` (None: one device): each step's metrics, the first step's
    forward triples, and the gradients AdamW got first."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    cfg = _cfg(name)
    state, _ = CheckpointManager(init).restore(cfg, device="cpu", mesh=mesh)
    step = ts.make_train_step(cfg, opt.AdamWCfg(), mesh=mesh)
    pipe = TokenPipeline(cfg, ShapeCfg("t", "train", SEQ, BATCH), seed=0)
    tracer, rec = obs.Tracer(), {k: [] for k in METRICS}
    try:
        with _first_grads() as grads:
            for i in range(STEPS):
                with dispatch.use(tracer=tracer) if i == 0 else \
                        contextlib.nullcontext():
                    state, metrics = step(state, next(pipe))
                for k in METRICS:
                    rec[k].append(float(metrics.get(k, math.nan)))
    finally:
        pipe.close()
    rec["triples"] = train.forward_triples(tracer)
    return rec, grads


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _layer_grads(layer, x, r, *, vision=False):
    """The layer's output and the gradients of sum(y * r) with respect to
    x (MLA's input) and its parameters."""
    layer.zero_grad(set_to_none=True)
    if not vision:
        x = x.clone().requires_grad_()
    y = layer(x) if vision else layer(x, mode="train")
    (y * r).sum().backward()
    out = {"y": y.detach(), **{n: p.grad for n, p in
                               layer.named_parameters()}}
    if not vision:
        out["x"] = x.grad
    return out


def _layers_alone(mesh):
    """The MLA layer of the deepseek config and llava's ``VisionProj``,
    each whole on this rank and split over the model axis with the whole
    one's weights: relative L2 of the output and of every gradient (a
    split weight's against its block of the whole one's)."""
    from repro_torch.layers.attention import MLAttention
    from repro_torch.models import blocks
    from repro_torch.models.transformer import VisionProj, fill_params
    layout = parallel.Layout(_cfg("deepseek"), mesh)
    tp = layout.model
    n = tp.size
    out = {}
    for what in ("mla", "vision"):
        gen = torch.Generator().manual_seed(7)
        if what == "mla":
            cfg = _cfg("deepseek")
            acfg = blocks.attn_cfg(cfg)
            whole = fill_params(MLAttention(acfg), gen)
            part = MLAttention(dataclasses.replace(
                acfg, n_heads=acfg.n_heads // n))
            part.split(tp)
            shape = (2, 8, cfg.d_model)
        else:
            cfg = _cfg("llava")
            whole = VisionProj(cfg.d_model, dtype=torch.float32,
                               device="cpu")
            with torch.no_grad():      # biases drawn too, not zeros
                for p in whole.parameters():
                    p.normal_(generator=gen).mul_(cfg.d_model ** -0.5)
            part = VisionProj(cfg.d_model, dtype=torch.float32, device="cpu")
            part.split(tp)
            shape = (2, cfg.n_patches, cfg.d_model)
        x = torch.randn(shape, generator=gen)
        r = torch.randn(shape, generator=gen)
        dims = {}
        with torch.no_grad():
            for name, p in part.named_parameters():
                w = dict(whole.named_parameters())[name]
                dim = next((d for d in range(w.dim())
                            if w.shape[d] != p.shape[d]), None)
                dims[name] = dim
                p.copy_(w if dim is None else w.narrow(
                    dim, tp.index * p.shape[dim], p.shape[dim]))
        want = _layer_grads(whole, x, r, vision=what == "vision")
        got = _layer_grads(part, x, r, vision=what == "vision")
        errs = {}
        for key, g in got.items():
            w = want[key]
            dim = dims.get(key)
            if dim is not None:
                w = w.narrow(dim, tp.index * g.shape[dim], g.shape[dim])
            errs[key] = _rel(g, w)
        out[what] = errs
    return out


def _wait(path):
    import time
    deadline = time.time() + 300
    while not path.exists():
        assert time.time() < deadline, f"no {path.name}"
        time.sleep(0.05)


def _rank_main(rank, world, store, tmp):
    """One spawned rank: join the world, train every config once the
    reference's initial state is written, hold its first gradients'
    shards against the meshless ones the test process saved, run the
    layers alone, write its records, leave."""
    import pathlib
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    tmp = pathlib.Path(tmp)
    torch.set_num_threads(1)        # eight ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world[0] * world[1])
    try:
        _spy()
        mesh = make_mesh(world, ("data", "model"))
        out = {}
        for run in RUNS[world]:
            base = _base(run)
            _wait(tmp / f"init_{base}.done")
            rec, grads = _train(run, tmp / f"init_{base}", mesh)
            _wait(tmp / f"meshless_{base}.done")
            want = torch.load(tmp / f"meshless_{base}.pt")
            layout = parallel.Layout(_cfg(run), mesh)
            assert sorted(grads) == sorted(want), run
            rec["grad_rel"] = {n: _rel(g, layout.shard(n, want[n]))
                               for n, g in grads.items()}
            out[run] = rec
        if world in LAYER_WORLDS:
            out["layers"] = _layers_alone(mesh)
        (tmp / f"{_tag(world)}.{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _reference(name, jcfg, jstate):
    """The reference's ``make_train_step`` on one device: each step's
    metrics."""
    import jax
    from repro.configs.shapes import ShapeCfg as JShapeCfg
    from repro.data.pipeline import TokenPipeline as JTokenPipeline
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    step = jax.jit(jts.make_train_step(jcfg, jopt.AdamWCfg()))
    pipe = JTokenPipeline(jcfg, JShapeCfg("t", "train", SEQ, BATCH), seed=0)
    rec = {k: [] for k in METRICS}
    try:
        for _ in range(STEPS):
            jstate, metrics = step(jstate, next(pipe))
            for k in METRICS:
                rec[k].append(float(metrics.get(k, math.nan)))
    finally:
        pipe.close()
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's records (its ranks started first, to import while
    the reference draws its initial states), the port's meshless runs
    (their first gradients saved for the ranks) and the reference's runs,
    made while the worlds train."""
    import jax
    from repro import configs as jconfigs
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    tmp = tmp_path_factory.mktemp("mla_worlds")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = []
    for world in WORLDS:
        for rank in range(world[0] * world[1]):
            p = ctx.Process(target=_rank_main, args=(
                rank, world, str(tmp / f"store_{_tag(world)}"), str(tmp)))
            p.start()
            procs.append((world, rank, p))
    try:
        jstates = {}
        for name in NAMES:
            jcfg = _cfg(name, jconfigs)
            jstates[name] = jax.jit(lambda key, jcfg=jcfg: jts.init_state(
                key, jcfg, jopt.AdamWCfg()))(jax.random.PRNGKey(0))
            JManager(tmp / f"init_{name}").save(0, jstates[name])
            (tmp / f"init_{name}.done").touch()
        saved = {op: dict(dispatch._REGISTRY[op]) for op in
                 ("matmul", "flash_attention")}
        meshless = {}
        try:
            _spy()
            for name in NAMES:
                meshless[name], grads = _train(name, tmp / f"init_{name}",
                                               None)
                torch.save(grads, tmp / f"meshless_{name}.pt")
                (tmp / f"meshless_{name}.done").touch()
        finally:
            for op, entries in saved.items():
                dispatch._REGISTRY[op].update(entries)
        ref = {name: _reference(name, _cfg(name, jconfigs), jstates[name])
               for name in NAMES}
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


CASES = [(world, run) for world in WORLDS for run in RUNS[world]]
IDS = [f"{_tag(w)}-{r}" for w, r in CASES]


def _present(run):
    """The metrics RUN's config reports."""
    return [k for k in METRICS
            if (k != "mtp_loss" or _base(run) == "deepseek")
            and (k != "load_balance_loss" or _base(run) == "deepseek")]


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_world_matches_the_reference_single_device(runs, world, name):
    """Every loss metric at every step within BAND of the reference's
    one-device run; the ones the config lacks absent on both sides."""
    got = runs["records"][(world, 0)][name]
    want = runs["ref"][_base(name)]
    for key in METRICS:
        assert len(got[key]) == len(want[key]) == STEPS
        if key in _present(name):
            np.testing.assert_allclose(got[key], want[key], **BAND,
                                       err_msg=key)
        else:
            assert all(math.isnan(v) for v in got[key] + want[key]), key


@pytest.mark.parametrize("name", NAMES)
def test_meshless_port_matches_the_reference(runs, name):
    got, want = runs["meshless"][name], runs["ref"][name]
    for key in _present(name):
        np.testing.assert_allclose(got[key], want[key], **BAND,
                                   err_msg=key)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_every_gradient_is_the_one_rank_gradients_shard(runs, world, name):
    """On every rank, each leaf's gradient that AdamW gets first (the data
    axes' sum, this rank's shard) is its shard of the meshless step's,
    within relative L2 GRAD_REL: the norms' scales, the biases, the
    low-rank projections and the router included (a partial sum left on
    a model rank, or one summed twice, is off by a whole part)."""
    for rank in range(world[0] * world[1]):
        errs = runs["records"][(world, rank)][name]["grad_rel"]
        bad = {n: e for n, e in errs.items() if not e <= GRAD_REL}
        assert not bad, (rank, bad)
    names = runs["records"][(world, 0)][name]["grad_rel"]
    for leaf in {"mla": ("attn.q_norm.scale", "attn.kv_norm.scale",
                         "attn.wq_a", "attn.wkv_a"),
                 "deepseek": ("mtp_block.attn.wkv_a", "moe.router"),
                 "llava": ("vision_proj.b1", "vision_proj.b2",
                           "vision_proj.w1")}[_base(name)]:
        assert any(n.endswith(leaf) for n in names), leaf


LAYER_CASES = [(world, what) for world in LAYER_WORLDS
               for what in ("mla", "vision")]


@pytest.mark.parametrize("world,what", LAYER_CASES,
                         ids=[f"{_tag(w)}-{x}" for w, x in LAYER_CASES])
def test_split_layer_gives_one_ranks_gradients(runs, world, what):
    """The MLA layer and ``VisionProj`` split over the model axis: the
    output, x's gradient (MLA) and every parameter's gradient, each within
    relative L2 GRAD_REL of the whole layer's on one rank."""
    want_keys = {"mla": {"y", "x", "wq_a", "q_norm.scale", "wq_b", "wkv_a",
                         "kv_norm.scale", "wkv_b", "wo"},
                 "vision": {"y", "w1", "b1", "w2", "b2"}}[what]
    for rank in range(world[0] * world[1]):
        errs = runs["records"][(world, rank)]["layers"][what]
        assert set(errs) == want_keys
        bad = {k: e for k, e in errs.items() if not e <= GRAD_REL}
        assert not bad, (rank, bad)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_rank0_resolves_the_local_problems(runs, world, name):
    """Rank 0's forward triples are ``local_problem`` of the meshless
    run's, in call order, each keyed with the mesh signature: MLA's
    low-rank projections and a VLM's projection column-parallel (their
    blocks gathered after the GEMM), ``wo`` row-parallel."""
    want = runs["meshless"][_base(name)]["triples"]
    got = runs["records"][(world, 0)][name]["triples"]
    mesh = local.abstract_mesh(world, ("data", "model"))
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        assert g["op"] == w["op"] and "mesh" not in w
        assert g["mesh"] == str(("data", "model"))
        specs = ({g["op"]: ast.literal_eval(g["axes"])} if "axes" in g
                 else None)
        assert (g["m"], g["n"], g["k"]) == local.local_problem(
            w["op"], w["m"], w["n"], w["k"], mesh, specs), (g, w)


@pytest.mark.parametrize("world", WORLDS, ids=[_tag(w) for w in WORLDS])
def test_every_rank_reports_the_global_metrics(runs, world):
    recs = runs["records"]
    for rank in range(1, world[0] * world[1]):
        for name in RUNS[world]:
            for key in _present(name):
                assert recs[(world, rank)][name][key] == \
                    recs[(world, 0)][name][key], (rank, name, key)

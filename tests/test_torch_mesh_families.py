"""The recurrent families and the encoder-decoder trained data x model
parallel on a mesh of the running world, in gloo worlds on the CPU, held
to the JAX package.

Three reduced configs: xlstm-1.3b (seven mLSTM blocks and an sLSTM block,
at T = SEQ = 32, two of its 16-token mLSTM chunks, so that the chunk
state runs), recurrentgemma-9b (RG-LRU blocks and local attention over
its one KV head, which a 2-way model axis cuts within) and
seamless-m4t-large-v2 (its encoder, the decoder's cross-attention over
SEQ / 2 frames and the untied head).  The worlds (1, 2), (2, 1) and (2,
2) each train all three in one set of ranks, from the reference's
initial state (a checkpoint it wrote), and every step's ``loss`` and
``ce_loss`` is held within ``BAND`` of the reference's
``make_train_step`` on one device.  The first step's gradients that
AdamW receives are held, leaf by leaf, to the port's meshless step's
(each rank's shard of them) within relative L2 ``GRAD_REL``; and on (1,
2) and (2, 2) each layer alone, split over the model axis as the
executor splits it (``parallel.wire``), gives the output and every
parameter's gradient of one rank's whole layer: xLSTM's mLSTM block (its
row-sharded output gate ``wo``, the replicated ``bi``, ``bf`` and
``head_norm`` scale) and sLSTM block (``w``, ``r`` and ``b``, run whole),
RecurrentGemma's rec block (``conv_w``, ``lam`` and the gate biases on a
block of d_rnn) and attention block (its KV head's columns gathered),
and the encoder-decoder whole (the encoder's and the cross-attention's
leaves, ``enc_ln``).  Each rank imports this module, so its top level
stays free of JAX.
"""
import ast
import contextlib
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

STEPS, BATCH, SEQ = 3, 4, 32     # step 2 follows an update (lr 0 at step 0)
BAND = dict(rtol=2e-3, atol=2e-3)  # the reference's mesh test's band
GRAD_REL = 1e-4                  # fp32: the sums' order alone
# xLSTM's fp32 gradients move by far more than GRAD_REL when its weights
# move by a few fp32 ulps: its input-gate biases' gradients cancel to near
# zero (a head's output is invariant to a shift of all its input gates but
# for the denominator's floor), and the stabilised denominator max(|q n|,
# exp(-m)) switches branch under a rounding; with every fp32 of the port
# widened to fp64 the worlds match the meshless step to fp64's rounding.
# So a leaf's limit is the larger of GRAD_REL and SPREAD_FACTOR times the
# meshless step's own spread: its gradients' change when every weight
# moves by SPREAD of itself (8 ulps), as the card's smoke bands its
# worlds.  The worlds' sums in other orders perturb the activations
# themselves, which moves the xLSTM leaves by more than that spread,
# within SPREAD_FACTOR of it; a wiring fault (a partial sum, one summed
# twice) is off by a whole part.
SPREAD, SPREAD_FACTOR = 2.0 ** -20, 4.0
ARCHS = {"xlstm": "xlstm-1.3b", "rgemma": "recurrentgemma-9b",
         "seamless": "seamless-m4t-large-v2"}
NAMES = tuple(ARCHS)
METRICS = ("loss", "ce_loss")
WORLDS = ((1, 2), (2, 1), (2, 2))
LAYER_WORLDS = ((1, 2), (2, 2))  # the layers alone, split over the model axis
# layer -> (arch, the leaves of the split that the rules cut across the
# layer, each of which a wrong wiring gets wrong)
LAYERS = {"mlstm": ("xlstm", ("mlstm.wo", "mlstm.bi", "mlstm.bf",
                              "mlstm.head_norm.scale", "mlstm.wi")),
          "slstm": ("xlstm", ("slstm.w", "slstm.r", "slstm.b")),
          "rec": ("rgemma", ("rglru.conv_w", "rglru.lam", "rglru.b_rgate",
                             "rglru.b_igate", "rglru.w_rgate")),
          "attn": ("rgemma", ("attn.wk", "attn.wv", "attn.wq")),
          "encdec": ("seamless", ("enc_blocks.0.attn.wk",
                                  "enc_blocks.0.ln1.scale",
                                  "dec_blocks.1.cross_attn.wk",
                                  "dec_blocks.1.cross_attn.wq",
                                  "dec_blocks.1.ln_x.scale",
                                  "enc_ln.scale", "head.w"))}


def _cfg(name, module=configs):
    return module.get(ARCHS[name]).reduced()


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


def _move(params, gen):
    """Every tensor of ``params`` moved by SPREAD of itself, in place (a
    random sign an element)."""
    with torch.no_grad():
        for w in params:
            w.mul_(1 + SPREAD * torch.randn(w.shape, generator=gen).sign())


def _train(name, init, mesh, steps=STEPS, moved=False):
    """``steps`` steps of NAME's config from the reference's initial state
    (``moved``: every weight moved by SPREAD) on ``mesh`` (None: one
    device): each step's metrics, the first step's forward triples, and
    the gradients AdamW got first."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    cfg = _cfg(name)
    state, _ = CheckpointManager(init).restore(cfg, device="cpu", mesh=mesh)
    if moved:
        _move(state["opt"]["master"].values(),
              torch.Generator().manual_seed(91))
    step = ts.make_train_step(cfg, opt.AdamWCfg(), mesh=mesh)
    pipe = TokenPipeline(cfg, ShapeCfg("t", "train", SEQ, BATCH), seed=0)
    tracer, rec = obs.Tracer(), {k: [] for k in METRICS}
    try:
        with _first_grads() as grads:
            for i in range(steps):
                with dispatch.use(tracer=tracer) if i == 0 else \
                        contextlib.nullcontext():
                    state, metrics = step(state, next(pipe))
                for k in METRICS:
                    rec[k].append(float(metrics[k]))
    finally:
        pipe.close()
    rec["triples"] = train.forward_triples(tracer)
    return rec, grads


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _block_of(whole, part, index):
    """``whole``'s block that a rank at ``index`` holds of a tensor shaped
    ``part`` (cut along the one dim where the shapes differ)."""
    dim = next((d for d in range(whole.dim())
                if whole.shape[d] != part.shape[d]), None)
    if dim is None:
        return whole
    n = part.shape[dim]
    return whole.narrow(dim, index * n, n)


def _layer(what, cfg, layout=None):
    """LAYER's module of ``cfg``, whole, or cut as the executor cuts it on
    ``layout``'s mesh (uninitialised)."""
    from repro_torch.models import blocks
    from repro_torch.models.encdec import EncDec
    if layout is not None:
        full = cfg
        cfg = parallel.local_cfg(cfg, layout.mesh)
    if what == "encdec":
        model = EncDec(cfg, device="cpu")
        if layout is not None:
            parallel.wire(model, full, layout)
        return model
    block = blocks.RECURRENT_BLOCKS[what](cfg, device="cpu")
    if layout is not None:
        parallel.wire_block(block, layout.model,
                            parallel.kv_split(full, layout.model.size))
    return block


def _layer_grads(what, layer, x, r, tokens, index=0):
    """The layer's output and the gradients of sum(y * r) with respect to
    x (a block's input, the encoder-decoder's frames) and its parameters
    (the encoder-decoder's output: the block of the logits a rank at
    ``index`` holds, and of r)."""
    layer.zero_grad(set_to_none=True)
    x = x.clone().requires_grad_()
    if what == "encdec":
        y, _ = layer.logits_and_aux(tokens, src_embeds=x)
    else:
        y, _, _ = layer(x, mode="train")
    (y * _block_of(r, y, index)).sum().backward()
    return {"y": y.detach(), "x": x.grad,
            **{n: p.grad for n, p in layer.named_parameters()}}


def _layers_alone(mesh):
    """Each layer of LAYERS, whole on this rank and split over the model
    axis with the whole one's weights: relative L2 of the output and of
    every gradient (a split one's against its block of the whole one's),
    and the whole layer's own spread (its weights moved by SPREAD), by
    key."""
    from repro_torch.models.transformer import fill_params
    out = {}
    for what, (name, _) in LAYERS.items():
        cfg = _cfg(name)
        layout = parallel.Layout(cfg, mesh)
        index = layout.model.index
        gen = torch.Generator().manual_seed(7)
        whole = fill_params(_layer(what, cfg), gen)
        part = _layer(what, cfg, layout)
        with torch.no_grad():
            for n, p in part.named_parameters():
                p.copy_(_block_of(dict(whole.named_parameters())[n], p,
                                  index))
        frames = SEQ // 2 if what == "encdec" else SEQ
        x = torch.randn((2, frames, cfg.d_model), generator=gen)
        tokens = torch.randint(0, cfg.vocab, (2, SEQ), generator=gen)
        shape = (2, SEQ, cfg.vocab if what == "encdec" else cfg.d_model)
        r = torch.randn(shape, generator=gen)
        want = _layer_grads(what, whole, x, r, tokens)
        got = _layer_grads(what, part, x, r, tokens, index)
        _move(whole.parameters(), gen)
        moved = _layer_grads(what, whole, x, r, tokens)
        out[what] = {k: _rel(g, _block_of(want[k], g, index))
                     for k, g in got.items()}
        out[what + ".spread"] = {
            k: _rel(_block_of(moved[k], g, index),
                    _block_of(want[k], g, index)) for k, g in got.items()}
    return out


def _wait(path):
    import time
    deadline = time.time() + 300
    while not path.exists():
        assert time.time() < deadline, f"no {path.name}"
        time.sleep(0.05)


def _rank_main(rank, world, store, tmp):
    """One spawned rank: join the world, run the layers alone, train every
    config once the reference's initial state is written, hold its first
    gradients' shards against the meshless ones the test process saved,
    write its records, leave."""
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
        if world in LAYER_WORLDS:
            out["layers"] = _layers_alone(mesh)
        for name in NAMES:
            _wait(tmp / f"init_{name}.done")
            rec, grads = _train(name, tmp / f"init_{name}", mesh)
            _wait(tmp / f"meshless_{name}.done")
            want, moved = torch.load(tmp / f"meshless_{name}.pt")
            layout = parallel.Layout(_cfg(name), mesh)
            assert sorted(grads) == sorted(want), name
            rec["grad_rel"] = {n: _rel(g, layout.shard(n, want[n]))
                               for n, g in grads.items()}
            rec["grad_spread"] = {
                n: _rel(layout.shard(n, moved[n]), layout.shard(n, want[n]))
                for n in grads}
            out[name] = rec
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
                rec[k].append(float(metrics[k]))
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
    tmp = tmp_path_factory.mktemp("family_worlds")
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
                _, moved = _train(name, tmp / f"init_{name}", None, 1, True)
                torch.save((grads, moved), tmp / f"meshless_{name}.pt")
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


CASES = [(world, name) for world in WORLDS for name in NAMES]
IDS = [f"{_tag(w)}-{n}" for w, n in CASES]


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_world_matches_the_reference_single_device(runs, world, name):
    """``loss`` and ``ce_loss`` at every step within BAND of the
    reference's one-device run."""
    got = runs["records"][(world, 0)][name]
    want = runs["ref"][name]
    for key in METRICS:
        assert len(got[key]) == len(want[key]) == STEPS
        np.testing.assert_allclose(got[key], want[key], **BAND, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_meshless_port_matches_the_reference(runs, name):
    got, want = runs["meshless"][name], runs["ref"][name]
    for key in METRICS:
        np.testing.assert_allclose(got[key], want[key], **BAND,
                                   err_msg=key)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_every_gradient_is_the_one_rank_gradients_shard(runs, world, name):
    """On every rank, each leaf's gradient that AdamW gets first (the data
    axes' sum, this rank's shard) is its shard of the meshless step's,
    within relative L2 GRAD_REL, or SPREAD_FACTOR times the meshless
    step's own spread where that is larger (xLSTM): the replicated biases,
    decays and norm scales, the gathered weights and the encoder's leaves
    included (a partial sum left on a model rank, or one summed twice, is
    off by a whole part)."""
    for rank in range(world[0] * world[1]):
        rec = runs["records"][(world, rank)][name]
        bad = {n: (e, rec["grad_spread"][n])
               for n, e in rec["grad_rel"].items()
               if not e <= max(GRAD_REL,
                               SPREAD_FACTOR * rec["grad_spread"][n])}
        assert not bad, (rank, bad)
    names = runs["records"][(world, 0)][name]["grad_rel"]
    for leaf in {"xlstm": ("mlstm.wo", "mlstm.bi", "mlstm.head_norm.scale",
                           "slstm.w", "slstm.r", "slstm.b"),
                 "rgemma": ("rglru.conv_w", "rglru.lam", "rglru.b_igate",
                            "rglru.w_rgate", "attn.wk", "attn.wv"),
                 "seamless": ("enc_blocks.0.attn.wq", "enc_ln.scale",
                              "cross_attn.wk", "ln_x.scale", "head.w")}[name]:
        assert any(n.endswith(leaf) for n in names), leaf


LAYER_CASES = [(world, what) for world in LAYER_WORLDS for what in LAYERS]


@pytest.mark.parametrize("world,what", LAYER_CASES,
                         ids=[f"{_tag(w)}-{x}" for w, x in LAYER_CASES])
def test_split_layer_gives_one_ranks_gradients(runs, world, what):
    """Each layer split over the model axis: the output, x's gradient and
    every parameter's gradient, each within relative L2 GRAD_REL of the
    whole layer's on one rank (a split one's against its block), or
    SPREAD_FACTOR times the whole layer's own spread where that is larger
    (mLSTM's input-gate biases)."""
    for rank in range(world[0] * world[1]):
        layers = runs["records"][(world, rank)]["layers"]
        errs, spread = layers[what], layers[what + ".spread"]
        for key in ("y", "x") + LAYERS[what][1]:
            assert key in errs, key
        bad = {k: (e, spread[k]) for k, e in errs.items()
               if not e <= max(GRAD_REL, SPREAD_FACTOR * spread[k])}
        assert not bad, (rank, bad)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_rank0_resolves_the_local_problems(runs, world, name):
    """Rank 0's forward triples are ``local_problem`` of the meshless
    run's, in call order, each keyed with the mesh signature: the rank's
    heads, d_rnn and vocab columns, ``w_out`` and ``wo`` row-parallel, the
    sLSTM's gathered gate GEMM whole in n and k."""
    want = runs["meshless"][name]["triples"]
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
        for name in NAMES:
            for key in METRICS:
                assert recs[(world, rank)][name][key] == \
                    recs[(world, 0)][name][key], (rank, name, key)
        assert not math.isnan(recs[(world, rank)][NAMES[0]]["loss"][0])

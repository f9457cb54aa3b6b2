"""The port's data x model parallel training, checkpoints across meshes and
the GPipe substrate, in gloo worlds on the CPU, held to the JAX package.

Each world's ranks are spawned processes that join through a ``file://``
store under the test's ``tmp_path`` (no port to collide under ``-n``);
they take the reference's initial state from a checkpoint it wrote (a
spawned rank sees no monkeypatch).  The reference trains on one device
(``repro.launch.train.run`` on a (1, 1) mesh): its own 2 x 2 mesh test
fails (ROADMAP queue 3, fault 1), so its multi-device losses are not used.
On the CPU the plain versions run, which resolve no plan; a rank's
``spy`` makes them resolve theirs as the card's wrappers do, so the first
step's ``resolve_blocks`` triples can be read.
"""
import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import dispatch
from repro_torch.distributed import parallel
from repro_torch.launch import train
from repro_torch.sharding import local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH, SEQ = 5, 4, 32     # resumed after step 0: steps 1-4 train
WORLDS = ((1, 1), (2, 1), (1, 2), (2, 2))
BAND = dict(rtol=2e-3, atol=2e-3)  # the reference's mesh test's band


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


def _cli(mesh, ckpt, out, *extra):
    return ["--reduced", "--steps", str(STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--device", "cpu", "--mesh",
            f"{mesh[0]}x{mesh[1]}", "--ckpt-dir", str(ckpt), "--out",
            str(out), *extra]


def _rank_main(rank, world, store, task, kw):
    """One spawned rank: join the world, run ``task``, leave."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        _spy()
        if task == "train":
            train.main(kw["argv"])
        elif task == "restore":
            _restore(kw)
        elif task == "pipeline":
            _pipeline(kw)
    finally:
        dist.destroy_process_group()


def _restore(kw):
    """Restore the latest checkpoint onto this world's mesh: every shard
    is its slice of the saved leaf, and gathered whole they are equal."""
    from repro_torch.launch.mesh import make_mesh
    cfg = configs.get("smollm-135m").reduced()
    mesh = make_mesh(kw["mesh"], ("data", "model"))
    mgr = CheckpointManager(kw["ckpt"])
    state, step = mgr.restore(cfg, device="cpu", mesh=mesh)
    whole, _ = mgr.restore(cfg, device="cpu")
    layout = parallel.Layout(cfg, mesh)
    for key in ("m", "v", "master"):
        for name, t in state["opt"][key].items():
            assert torch.equal(t, layout.shard(name, whole["opt"][key][name]))
    back = parallel.gather_state(state, cfg, mesh)
    for key in ("m", "v", "master"):
        for name, t in back["opt"][key].items():
            assert torch.equal(t, whole["opt"][key][name]), (key, name)
    if mesh.index(("data", "model")) == 0:
        with open(kw["out"], "w") as f:
            json.dump({"step": step, "state_step": back["opt"]["step"]}, f)


def _pipeline(kw):
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    data = np.load(kw["npz"])
    mesh = make_mesh((4,), ("stage",))
    w = torch.from_numpy(data["w"])
    x = torch.from_numpy(data["x"])
    y = pipeline_apply({"w": w}, x,
                       lambda p, h: torch.relu(h @ p["w"]), mesh=mesh,
                       n_microbatches=x.shape[0])
    np.save(kw["out"] + f".{mesh.index('stage')}.npy", y.numpy())


def _spawn(tmp_path, jobs):
    """Run every world of ``jobs`` ([(name, world, task, kw)]) at once;
    each rank a process.  Raises if any rank fails."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = []
    for name, world, task, kw in jobs:
        store = tmp_path / f"store_{name}"
        for rank in range(world):
            p = ctx.Process(target=_rank_main,
                            args=(rank, world, str(store), task, kw))
            p.start()
            procs.append((name, rank, p))
    failed = []
    for name, rank, p in procs:
        p.join(240)
        if p.is_alive():
            p.kill()
            failed.append((name, rank, "timed out"))
        elif p.exitcode != 0:
            failed.append((name, rank, p.exitcode))
    assert not failed, failed


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's single-device losses from its own initial state
    (checkpoint step 0), the port's meshless run from the same checkpoint,
    and every world's record."""
    import jax
    from repro import configs as jconfigs
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.configs.shapes import ShapeCfg
    from repro.launch.mesh import make_mesh
    from repro.launch.train import run
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    tmp = tmp_path_factory.mktemp("worlds")
    jcfg = jconfigs.get("smollm-135m").reduced()
    init = tmp / "init"
    JManager(init).save(0, jts.init_state(jax.random.PRNGKey(0), jcfg,
                                          jopt.AdamWCfg()))
    ckpts = {}
    for w in WORLDS + ("one",):
        ckpts[w] = tmp / f"ckpt_{w}"
        shutil.copytree(init, ckpts[w])
    _, ref = run(jcfg, ShapeCfg("t", "train", SEQ, BATCH),
                 mesh=make_mesh((1, 1), ("data", "model")), steps=STEPS,
                 ckpt_dir=str(shutil.copytree(init, tmp / "ckpt_ref")),
                 log_every=100)
    jobs = [(f"{d}x{m}", d * m, "train",
             {"argv": _cli((d, m), ckpts[(d, m)], tmp / f"{d}x{m}.json",
                           *(("--save-every", "1") if (d, m) == (2, 2)
                             else ()))})
            for d, m in WORLDS]
    _spawn(tmp, jobs)
    records = {w: json.loads((tmp / f"{w[0]}x{w[1]}.json").read_text())
               for w in WORLDS}
    return {"ref": [float(v) for v in ref], "records": records, "tmp": tmp,
            "ckpts": ckpts}


@pytest.fixture(scope="module")
def meshless(runs):
    """The port's one-device run from the same checkpoint, its plain
    versions resolving plans as the world's ranks do."""
    saved = dict(dispatch._REGISTRY["matmul"]), dict(
        dispatch._REGISTRY["flash_attention"])
    try:
        _spy()
        out = runs["tmp"] / "one.json"
        rec = train.main(_cli((1, 1), runs["ckpts"]["one"], out))
    finally:
        dispatch._REGISTRY["matmul"].update(saved[0])
        dispatch._REGISTRY["flash_attention"].update(saved[1])
    return rec


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_world_losses_match_the_reference_single_device(runs, world):
    got = runs["records"][world]["losses"]
    assert len(got) == len(runs["ref"]) == STEPS - 1
    np.testing.assert_allclose(got, runs["ref"], **BAND)


def test_one_rank_world_is_the_meshless_run(runs, meshless):
    np.testing.assert_allclose(runs["records"][(1, 1)]["losses"],
                               meshless["losses"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(meshless["losses"], runs["ref"], **BAND)


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_rank0_resolves_the_local_problems(runs, meshless, world):
    """Rank 0's forward triples are ``local_problem`` of the one-device
    run's, in call order, each keyed with the mesh signature (a row-
    parallel GEMM's under its k-sharding axis spec)."""
    rec = runs["records"][world]
    mesh = local.abstract_mesh(world, ("data", "model"))
    got, want = rec["forward_triples"], meshless["forward_triples"]
    assert got and len(got) == len(want)
    rows = 0
    for g, w in zip(got, want):
        assert g["op"] == w["op"] and "mesh" not in w
        assert g["mesh"] == str(("data", "model"))
        specs = ({g["op"]: ast.literal_eval(g["axes"])} if "axes" in g
                 else None)
        rows += "axes" in g
        assert (g["m"], g["n"], g["k"]) == local.local_problem(
            w["op"], w["m"], w["n"], w["k"], mesh, specs), (g, w)
    cfg = configs.get("smollm-135m").reduced()
    # wo and w_down a layer are row-parallel on a model axis
    assert rows == (2 * cfg.n_layers if world[1] > 1 else 0)


def test_world_records_collectives_and_backend(runs):
    recs = runs["records"]
    assert recs[(1, 1)]["collectives"] == {}
    assert recs[(2, 1)]["dist_backend"] == "gloo"
    assert recs[(2, 1)]["collectives"]["reduce_scatter_bytes"] > 0
    assert recs[(2, 1)]["collectives"]["all_gather_bytes"] > 0
    assert "reduce_scatter_bytes" not in recs[(1, 2)]["collectives"]
    assert recs[(1, 2)]["collectives"]["all_reduce_bytes"] > 0
    assert len(recs[(2, 2)]["peak_bytes"]) == 4


def test_checkpoint_written_at_2x2_restores_on_other_meshes(runs):
    ckpt = runs["ckpts"][(2, 2)]
    mgr = CheckpointManager(ckpt)
    assert mgr.latest_step() == STEPS - 1
    outs = {w: runs["tmp"] / f"restore_{w[0]}x{w[1]}.json"
            for w in ((1, 2), (2, 2), (1, 1))}
    _spawn(runs["tmp"], [(f"restore{w[0]}x{w[1]}", w[0] * w[1], "restore",
                          {"mesh": w, "ckpt": str(ckpt), "out": str(o)})
                         for w, o in outs.items()])
    for o in outs.values():
        assert json.loads(o.read_text()) == {"step": STEPS - 1,
                                             "state_step": STEPS - 1}
    # one device: the reference's layout on disk, read by the reference
    import jax
    from repro import configs as jconfigs
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    jcfg = jconfigs.get("smollm-135m").reduced()
    like = jts.init_state(jax.random.PRNGKey(1), jcfg, jopt.AdamWCfg())
    jstate, _ = JManager(ckpt).restore(like)
    state, _ = mgr.restore(configs.get("smollm-135m").reduced(),
                           device="cpu")
    np.testing.assert_array_equal(
        np.asarray(jstate["opt"]["master"]["embed"]["table"]),
        state["opt"]["master"]["embed.table"].numpy())
    assert int(jstate["opt"]["step"]) == state["opt"]["step"] == STEPS - 1


def test_pipeline_apply_matches_the_reference(tmp_path):
    npz = tmp_path / "pp.npz"
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.launch.mesh import make_mesh
        from repro.distributed.pipeline import pipeline_apply
        mesh = make_mesh((4,), ("stage",))
        S, M, mb, d = 4, 8, 2, 16
        rng = np.random.default_rng(0)
        w = (rng.normal(size=(S, d, d)) * (1 / d) ** 0.5).astype(np.float32)
        x = rng.normal(size=(M, mb, d)).astype(np.float32)
        y = pipeline_apply({{"w": jnp.asarray(w)}}, jnp.asarray(x),
                           lambda p, h: jax.nn.relu(h @ p["w"]),
                           mesh=mesh, n_microbatches=M)
        np.savez({str(npz)!r}, w=w, x=x, y=np.asarray(y))
        # NamedSharding's slices on a (2, 2, 2) mesh, for local_slices
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        import json
        m3 = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                  ("pod", "data", "model"))
        out = {{}}
        for name, spec, shape in (
                ("a", P(("pod", "data"), "model"), (8, 12)),
                ("b", P(None, ("data", "model")), (6, 8)),
                ("c", P("model", None, "pod"), (4, 3, 10))):
            idx = NamedSharding(m3, spec).devices_indices_map(shape)
            out[name] = [[[s.start or 0, s.stop if s.stop is not None
                           else shape[i]] for i, s in enumerate(idx[dev])]
                         for dev in m3.devices.flat]
        with open({str(tmp_path / 'slices.json')!r}, "w") as f:
            json.dump(out, f)
    """)
    env = {**os.environ, "XLA_FLAGS":
           "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = str(tmp_path / "y")
    _spawn(tmp_path, [("pp", 4, "pipeline", {"npz": str(npz),
                                             "out": out})])
    want = np.load(npz)["y"]
    for stage in range(4):
        np.testing.assert_allclose(np.load(f"{out}.{stage}.npy"), want,
                                   rtol=1e-5, atol=1e-5)
    # a rank's slices are NamedSharding's
    from repro_torch.sharding import rules
    m3 = local.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    slices = json.loads((tmp_path / "slices.json").read_text())
    for name, spec, shape in (("a", (("pod", "data"), "model"), (8, 12)),
                              ("b", (None, ("data", "model")), (6, 8)),
                              ("c", ("model", None, "pod"), (4, 3, 10))):
        for dev, want_sl in enumerate(slices[name]):
            coords = dict(zip(("pod", "data", "model"),
                              np.unravel_index(dev, (2, 2, 2))))
            got = rules.local_slices(shape, rules.P(*spec), m3, coords)
            assert [[s.start or 0, s.stop if s.stop is not None else
                     shape[i]] for i, s in enumerate(got)] == want_sl


def test_a_model_axis_that_cuts_heads_raises():
    smollm = configs.get("smollm-135m")
    with pytest.raises(ValueError, match="9 q heads do not split"):
        parallel.Layout(smollm, local.abstract_mesh((1, 2),
                                                    ("data", "model")))
    # xlstm runs on a mesh now (tests/test_torch_mesh_families.py); its 4
    # heads do not split three ways
    parallel.Layout(configs.get("xlstm-1.3b").reduced(),
                    local.abstract_mesh((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="4 q heads do not split"):
        parallel.Layout(configs.get("xlstm-1.3b").reduced(),
                        local.abstract_mesh((1, 3), ("data", "model")))
    # grok's MoE runs on a mesh now (tests/test_torch_mesh_moe.py)
    grok = configs.get("grok-1-314b").reduced()
    parallel.Layout(grok, local.abstract_mesh((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="neither its 3 experts nor"):
        parallel.Layout(dataclasses.replace(grok, n_experts=3, moe_d_ff=63),
                        local.abstract_mesh((1, 2), ("data", "model")))

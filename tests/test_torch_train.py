"""The port's training path against the JAX package, on the CPU.

Reduced smollm-135m (2 layers, d_model 128, fp32).  Weights come from the
reference's ``init_params`` at a fixed key and cross as numpy arrays (the two
frameworks' generators give different draws from one seed); data is the
same numpy stream on both sides.

Tolerances, and why:
  * loss and gradients (1e-5 absolute on the loss, atol = rtol = 1e-4 on
    gradients): fp32 on both sides, two frameworks' GEMM sum orders through
    2 layers, the head and a 512-way log-softmax;
  * AdamW (atol = rtol = 1e-6): elementwise fp32 on both sides; the bias
    corrections and the learning rate are Python floats here, fp32 scalars
    in the reference, an ulp apart;
  * the 10-step loss trajectory (1e-4 absolute): the gradient band carried
    through ten updates; each loss is ~6.8 and the observed spread ~4e-6;
  * resuming from a checkpoint continues the port's own trajectory exactly
    (the same ops on the same values).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs.shapes import ShapeCfg as JShapeCfg
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch.mesh import make_mesh
from repro.launch.train import run as jrun
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro.train import schedule as jschedule
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import dispatch as tdispatch
from repro_torch.models import api as tapi
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.shapes import SHAPES, ShapeCfg
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as tlaunch
from repro_torch.train import optimizer as topt
from repro_torch.train import schedule as tschedule
from repro_torch.train import train_step as tts

GRAD = dict(atol=1e-4, rtol=1e-4)
ADAM = dict(atol=1e-6, rtol=1e-6)
SHAPE = ShapeCfg("quickstart", "train", 64, 8)


@pytest.fixture(scope="module")
def cfgs():
    return (jconfigs.get("smollm-135m").reduced(),
            tconfigs.get("smollm-135m").reduced())


@pytest.fixture(scope="module")
def ref_state(cfgs):
    """The reference's initial train state at seed 0, as numpy."""
    jcfg, _ = cfgs
    state = jts.init_state(jax.random.PRNGKey(0), jcfg, jopt.AdamWCfg())
    return jax.tree.map(np.asarray, state)


def _assert_tree_close(got, want, **tol):
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_allclose(np.asarray(flat_got[path], np.float32),
                                   np.asarray(leaf, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def test_shapes_and_adamw_cfg_match_reference():
    from repro.configs.shapes import SHAPES as JSHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert dataclasses.asdict(topt.AdamWCfg()) == dataclasses.asdict(
        jopt.AdamWCfg())


def test_loss_and_grads_match_reference(cfgs, ref_state):
    jcfg, tcfg = cfgs
    params = jax.tree.map(jnp.asarray, ref_state["opt"]["master"])
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        japi.loss_fn, has_aux=True)(params, batch, jcfg)

    model = interop.params_from_numpy(ref_state["opt"]["master"], tcfg,
                                      device="cpu")
    metrics, grads = tts.loss_and_grads(model, batch, tcfg)
    assert set(metrics) == {"ce_loss", "loss"}
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(metrics["ce_loss"]),
                               float(jmetrics["ce_loss"]), atol=1e-5, rtol=0)
    jgrads = jax.tree.map(np.asarray, jgrads)
    named = dict(interop.named_leaves(jgrads, tcfg))
    assert set(named) == set(grads)
    for name, want in named.items():
        np.testing.assert_allclose(grads[name].numpy(), want, err_msg=name,
                                   **GRAD)


@pytest.mark.parametrize("clip_active", [True, False])
def test_adamw_update_matches_reference(clip_active):
    rng = np.random.default_rng(5)
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 2, 4)}
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()}
    # Global norm ~14 with unit-normal grads; scaled to 0.3 when inactive.
    scale = 1.0 if clip_active else 0.3 / np.sqrt(sum(
        np.prod(s) for s in shapes.values()))
    grads = [{n: (rng.normal(size=s) * scale).astype(np.float32)
              for n, s in shapes.items()} for _ in range(2)]

    jcfg, tcfg = jopt.AdamWCfg(), topt.AdamWCfg()
    jstate = jopt.adamw_init(jax.tree.map(jnp.asarray, params), jcfg)
    tstate = topt.adamw_init({n: torch.from_numpy(p.copy())
                              for n, p in params.items()}, tcfg)
    for g in grads:
        jstate, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), jstate,
                                       jcfg, 1.0)
        tstate, tm = topt.adamw_update({n: torch.from_numpy(a)
                                        for n, a in g.items()}, tstate,
                                       tcfg, 1.0)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **ADAM)
        assert (float(jm["grad_norm"]) > tcfg.grad_clip) == clip_active
    assert tstate["step"] == int(jstate["step"]) == 2
    for key in ("m", "v", "master"):
        for n in shapes:
            np.testing.assert_allclose(tstate[key][n].numpy(),
                                       np.asarray(jstate[key][n]),
                                       err_msg=f"{key}/{n}", **ADAM)
    working = {n: torch.zeros(s, dtype=torch.bfloat16)
               for n, s in shapes.items()}
    topt.cast_params(tstate, working)
    for n in shapes:
        np.testing.assert_array_equal(
            working[n].float().numpy(),
            np.asarray(jopt.cast_params(jstate, jnp.bfloat16)[n],
                       np.float32))


@pytest.mark.parametrize("step", [0, 1, 999, 1000, 50000, 100000])
def test_schedules_match_reference(step):
    np.testing.assert_allclose(
        tschedule.warmup_cosine(step),
        float(jschedule.warmup_cosine(jnp.int32(step))), rtol=1e-6,
        atol=1e-7)
    assert tschedule.constant(step, value=0.5) == jschedule.constant(
        step, value=0.5)


def test_token_pipeline_matches_reference(cfgs):
    jcfg, tcfg = cfgs
    for start in (0, 5):
        jp = JTokenPipeline(jcfg, JShapeCfg("q", "train", 64, 8), seed=3,
                            start_step=start)
        tp = TokenPipeline(tcfg, SHAPE, seed=3, start_step=start)
        try:
            for _ in range(3):
                jb, tb = next(jp), next(tp)
                assert set(tb) == {"tokens", "labels"}
                for key in tb:
                    assert tb[key].dtype == np.int32
                    np.testing.assert_array_equal(tb[key], jb[key])
            assert tp.step == start + 3
        finally:
            jp.close()
            tp.close()


def test_checkpoints_restore_across_packages(cfgs, ref_state, tmp_path):
    jcfg, tcfg = cfgs
    # A reference checkpoint restores in the port ...
    ref_tree = jax.tree.map(np.asarray, ref_state)
    ref_tree["opt"]["m"] = jax.tree.map(lambda a: a + 0.5,
                                        ref_tree["opt"]["m"])
    ref_tree["opt"]["step"] = np.asarray(7, np.int32)
    JCheckpointManager(tmp_path / "ref").save(7, ref_tree)
    state, step = CheckpointManager(tmp_path / "ref").restore(tcfg,
                                                              device="cpu")
    assert step == 7 and state["opt"]["step"] == 7
    _assert_tree_close({"opt": interop.opt_state_to_numpy(state["opt"])},
                       ref_tree, atol=0, rtol=0)
    # ... and a port checkpoint in the reference.
    tstate = tts.init_state(tcfg, topt.AdamWCfg(),
                            torch.Generator().manual_seed(1), "cpu")
    tstate["opt"]["step"] = 3
    mgr = CheckpointManager(tmp_path / "port", keep=2)
    mgr.save_async(3, tstate)
    mgr.save(4, tstate)
    mgr.save(5, tstate)
    mgr.wait()
    assert sorted(p.name for p in (tmp_path / "port").glob("step_*")) == [
        "step_00000004", "step_00000005"]
    jmgr = JCheckpointManager(tmp_path / "port")
    restored, jstep = jmgr.restore(ref_state, step=4)
    assert jstep == 4 and int(restored["opt"]["step"]) == 3
    _assert_tree_close(jax.tree.map(np.asarray, restored),
                       {"opt": interop.opt_state_to_numpy(tstate["opt"])},
                       atol=0, rtol=0)


def test_run_matches_reference_and_resumes(cfgs, ref_state, tmp_path,
                                           monkeypatch):
    jcfg, tcfg = cfgs
    _, want = jrun(jcfg, JShapeCfg("quickstart", "train", 64, 8),
                   mesh=make_mesh((1, 1), ("data", "model")), steps=10,
                   log_every=100)
    # The port's run starts from the reference's weights (see the module
    # docstring); everything after that is its own.
    monkeypatch.setattr(tts, "init_state", lambda *a, **k: {
        "opt": interop.opt_state_from_numpy(ref_state["opt"], tcfg, "cpu")})
    ckpt = tmp_path / "ckpt"
    _, got = tlaunch.run(tcfg, SHAPE, steps=10, device="cpu",
                         ckpt_dir=ckpt, save_every=5, log_every=100)
    assert len(got) == 10
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert CheckpointManager(ckpt).latest_step() == 5
    _, resumed = tlaunch.run(tcfg, SHAPE, steps=10, device="cpu",
                             ckpt_dir=ckpt, log_every=100)
    np.testing.assert_allclose(resumed, got[6:], atol=1e-6, rtol=0)


def test_microbatches_average_gradients(cfgs, ref_state):
    _, tcfg = cfgs
    batch = TokenPipeline(tcfg, SHAPE, seed=0)
    b = next(batch)
    batch.close()
    grads = {}
    for mb in (1, 2):
        state = {"opt": interop.opt_state_from_numpy(ref_state["opt"], tcfg,
                                                     "cpu")}
        state["opt"]["step"] = 1500      # a non-zero learning rate
        new, _ = tts.make_train_step(tcfg, topt.AdamWCfg(),
                                     microbatches=mb)(state, b)
        grads[mb] = new["opt"]["m"]
    for name in grads[1]:
        torch.testing.assert_close(grads[2][name], grads[1][name],
                                   atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("name", ["smollm-135m", "llava-next-34b"])
def test_remat_changes_nothing_but_memory(cfgs, ref_state, name,
                                         monkeypatch):
    """``cfg.remat`` checkpoints each decoder block: the loss and every
    gradient equal, bit for bit, those of the step without it (the same
    ops on the same values, the forward run again in the backward), and
    so does a train step's new state."""
    _, tcfg = cfgs
    if name != "smollm-135m":     # llava's prefix through checkpointed blocks
        tcfg = tconfigs.get(name).reduced()
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": tokens, "labels": labels}
    if tcfg.n_patches:
        batch["patch_embeds"] = rng.standard_normal(
            (2, tcfg.n_patches, tcfg.d_model)).astype(np.float32)
    model = (interop.params_from_numpy(ref_state["opt"]["master"], tcfg,
                                       device="cpu")
             if name == "smollm-135m" else
             tapi.init_params(tcfg, device="cpu"))
    from repro_torch.models import transformer
    calls = []
    real = transformer.checkpoint.checkpoint
    monkeypatch.setattr(transformer.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        metrics, grads = tts.loss_and_grads(model, batch, cfg)
        out[remat] = (metrics, {n: g.clone() for n, g in grads.items()})
        assert len(calls) == tcfg.n_layers * remat   # one a block
    calls.clear()
    assert torch.equal(out[True][0]["loss"], out[False][0]["loss"])
    assert set(out[True][1]) == set(out[False][1])
    for n, g in out[False][1].items():
        assert torch.equal(out[True][1][n], g), n
    if name != "smollm-135m":
        return
    states = {}
    b = {k: v for k, v in batch.items()}
    for remat in (False, True):
        state = {"opt": interop.opt_state_from_numpy(ref_state["opt"], tcfg,
                                                     "cpu")}
        state["opt"]["step"] = 1500
        states[remat], _ = tts.make_train_step(
            dataclasses.replace(tcfg, remat=remat), topt.AdamWCfg())(state, b)
    assert len(calls) == tcfg.n_layers
    for key in ("m", "v", "master"):
        for n, t in states[False]["opt"][key].items():
            assert torch.equal(states[True]["opt"][key][n], t), (key, n)


def test_train_step_takes_block_policies_and_refuses_the_rest(
        cfgs, ref_state, monkeypatch):
    _, tcfg = cfgs
    seen = []
    real = tts.loss_and_grads

    def spy(model, batch, cfg):
        seen.append(tdispatch.snapshot()[2])   # the block policy
        return real(model, batch, cfg)

    state = {"opt": interop.opt_state_from_numpy(ref_state["opt"], tcfg,
                                                 "cpu")}
    b = {"tokens": np.zeros((2, 8), np.int32),
         "labels": np.ones((2, 8), np.int32)}
    monkeypatch.setattr(tts, "loss_and_grads", spy)
    tts.make_train_step(tcfg, topt.AdamWCfg(),
                        blocks_policy="autotune")(state, b)
    assert seen == ["autotune"]
    # mesh and axis_specs are ported (tests/test_torch_mesh.py): they
    # scope the step's dispatch, and an axis spec dispatch refuses raises
    from repro_torch.sharding.local import abstract_mesh
    mesh = abstract_mesh((2, 4), ("data", "model"))
    specs = {"matmul": (None, "model", None)}
    monkeypatch.setattr(tts, "loss_and_grads", lambda model, batch, cfg: (
        seen.append(tdispatch.snapshot()[4:]), real(model, batch, cfg))[1])
    tts.make_train_step(tcfg, topt.AdamWCfg(), mesh=mesh,
                        axis_specs=specs)(state, b)
    assert seen[-1] == (mesh, specs)
    with pytest.raises(ValueError, match="axis_specs"):
        tts.make_train_step(tcfg, topt.AdamWCfg(), axis_specs={"mm": None})
    # accum_dtype is ported (tests/test_torch_accum.py): a dtype it does
    # not know raises
    tts.make_train_step(tcfg, topt.AdamWCfg(), accum_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="accum_dtype"):
        tts.make_train_step(tcfg, topt.AdamWCfg(), accum_dtype=torch.float16)
    with pytest.raises(ValueError, match="unknown blocks_policy"):
        tts.make_train_step(tcfg, topt.AdamWCfg(), blocks_policy="fast")

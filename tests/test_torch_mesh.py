"""The port's meshes, sharding rules and mesh-aware dispatch against the
JAX package's, on the CPU with no devices: every check here is the
reference's function on the same inputs (``tests/test_mesh_dispatch.py``
and ``tests/test_distributed.py``'s cases, where the port has the
counterpart).  Meshes are abstract: only axis names and sizes are read.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.core import autotune as jautotune
from repro.core import blocking as jblocking
from repro.core import dispatch as jdispatch
from repro.launch import dryrun as jdryrun
from repro.launch import mesh as jmesh
from repro.models import api as japi
from repro.sharding import local as jlocal
from repro.sharding import rules as jrules
from repro_torch import configs, interop
from repro_torch.configs import shapes
from repro_torch.core import autotune, blocking, dispatch
from repro_torch.core.blocking import GemmGeometry, Plan
from repro_torch.distributed import parallel
from repro_torch.kernels.brgemm import kernel as K
from repro_torch.launch import dryrun, mesh
from repro_torch.models import api
from repro_torch.serve import engine as tengine
from repro_torch.sharding import annotate, local, rules
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((1, 3), ("data", "model"))]
MESH_IDS = ["2x4", "16x16", "pod2x2x2", "1x3"]
MESH8 = local.abstract_mesh((2, 4), ("data", "model"))
JMESH8 = jlocal.abstract_mesh((2, 4), ("data", "model"))


def both(shape, axes):
    return local.abstract_mesh(shape, axes), jlocal.abstract_mesh(shape, axes)


@pytest.fixture(autouse=True)
def _fresh_caches():
    dispatch.clear_tuning_cache()
    jdispatch.clear_tuning_cache()
    yield
    dispatch.clear_tuning_cache()
    jdispatch.clear_tuning_cache()


# --------------------------------------------------------------------------
# meshes and local shapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_mesh_helpers_match_reference(shape, axes):
    tm, jm = both(shape, axes)
    assert tm.axis_names == tuple(jm.axis_names)
    assert dict(tm.shape) == dict(jm.shape)
    assert tm.size == int(np.prod(shape)) and tm.is_abstract
    assert mesh.dp_axes(tm) == jmesh.dp_axes(jm)
    assert mesh.dp_size(tm) == jmesh.dp_size(jm)
    assert mesh.model_size(tm) == jmesh.model_size(jm)
    assert local.mesh_signature(tm) == jlocal.mesh_signature(jm)
    assert tm.shape.get("pod", 1) == dict(jm.shape).get("pod", 1)


def test_production_and_host_meshes():
    assert dict(mesh.make_production_mesh().shape) == {"data": 16,
                                                       "model": 16}
    assert dict(mesh.make_production_mesh(multi_pod=True).shape) == {
        "pod": 2, "data": 16, "model": 16}
    for n, want in ((8, (2, 4)), (4, (2, 2)), (1, (1, 1)), (2, (2, 1)),
                    (64, (4, 16))):
        assert tuple(mesh.make_host_mesh(n).shape.values()) == want
    with pytest.raises(ValueError, match="running world"):
        mesh.make_mesh((2, 1), ("data", "model"))
    assert mesh.make_mesh((1, 1), ("data", "model")).is_abstract


SHARD_CASES = [(8192, ("data",)), (8192, "model"), (8192, ("data", "model")),
               (7, ("data", "model")), (6, "model"), (3, ("data",)),
               (64, ("pod", "data")), (64, None), (16, ("pod", "data",
                                                        "model"))]


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_shard_count_and_local_shape(shape, axes):
    tm, jm = both(shape, axes)
    for dim, ax in SHARD_CASES:
        assert local.shard_count(dim, ax, tm) == jlocal.shard_count(
            dim, ax, jm), (dim, ax)
    for dims, spec in (((8192, 512, 1024), (("data",), "model", None)),
                       ((64, 64, 64), ("model",)),
                       ((30, 576, 192), (None, ("pod", "data"), "model")),
                       ((255, 126), (("data", "model"), None))):
        assert local.local_shape(dims, spec, tm) == jlocal.local_shape(
            dims, spec, jm)


TRIPLES = [("matmul", 8192, 512, 1024), ("matmul", 6 * 512, 576, 576),
           ("brgemm", 128, 1536, 576), ("batched_matmul", 64, 256, 64),
           ("conv2d", 28, 128, 512), ("flash_attention", 128, 4096, 64),
           ("flash_attention_bwd", 512, 512, 64), ("matmul", 3, 7, 5)]
OVERRIDES = [None, {"matmul": (("data",), None, "model")},
             {"matmul": {"backend": "torch"}},
             {"matmul": {"axes": (None, "model", None)}},
             {"flash_attention": ("data", None, None)}]


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_default_axis_specs_and_local_problem(shape, axes):
    tm, jm = both(shape, axes)
    assert local.default_axis_specs(tm) == jlocal.default_axis_specs(jm)
    assert set(local.default_axis_specs(tm)) == set(dispatch.MESH_OPS) \
        == set(jblocking.BLOCK_SCHEMAS)
    for override in OVERRIDES:
        jover = None if override is None else {
            op: ({**e, "backend": "pallas"} if isinstance(e, dict)
                 and "backend" in e else e) for op, e in override.items()}
        for op, m, n, k in TRIPLES:
            assert local.local_problem(op, m, n, k, tm, axis_specs=override) \
                == jlocal.local_problem(op, m, n, k, jm,
                                        axis_specs=jover), (op, override)


# --------------------------------------------------------------------------
# the sharding rules
# --------------------------------------------------------------------------

def _jax_tree(cfg):
    return jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0),
                                                   cfg))


def _leaf(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _port_shapes(cfg):
    from repro_torch.models import encdec
    from repro_torch.models.transformer import Transformer
    model = (encdec.EncDec if cfg.block == "encdec" else Transformer)(
        cfg, device="meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
@pytest.mark.parametrize("shape,axes", MESHES[:3], ids=MESH_IDS[:3])
def test_param_spec_every_parameter_of_every_family(arch, shape, axes):
    """Each port parameter's spec is the reference's spec of its stacked
    leaf, the stack's leading (unsharded) dims dropped."""
    tcfg, jcfg = configs.get(arch).reduced(), jconfigs.get(arch).reduced()
    tm, jm = both(shape, axes)
    tree = _jax_tree(jcfg)
    stacked = interop.stacked_leaves(tcfg)
    specs = rules.param_shardings(_port_shapes(tcfg), tm, tcfg)
    assert specs
    for name, port_shape in _port_shapes(tcfg).items():
        ref_path = stacked.get(name, name)
        ref_shape = tuple(_leaf(tree, ref_path).shape)
        lead = len(ref_shape) - len(port_shape)
        assert ref_shape[lead:] == port_shape, name
        want = tuple(jrules.param_spec(
            [types.SimpleNamespace(key=k) for k in ref_path.split(".")],
            ref_shape, jm))
        want = want + (None,) * (len(ref_shape) - len(want))
        # the reference shards a stack dim only where its MoE rule takes
        # a shared expert's layers for experts
        assert all(e is None for e in want[:lead]) or ".shared." in name, \
            (name, want)
        assert interop.stack_dims(tcfg).get(name, ()) == ref_shape[:lead]
        got = tuple(specs[name]) + (None,) * (len(port_shape)
                                              - len(specs[name]))
        assert got == want[lead:], (name, got, want)
        # and the stacked leaf itself, through the port's own path form
        assert tuple(rules.param_spec(ref_path, ref_shape, tm)) == \
            tuple(jrules.param_spec(
                [types.SimpleNamespace(key=k) for k in ref_path.split(".")],
                ref_shape, jm))


def test_param_spec_reference_cases():
    P = rules.P
    assert rules.param_spec("blocks.attn.wq", (30, 512, 256), MESH8) == \
        P(None, ("data",), "model")
    assert rules.param_spec("attn/wo", (256, 512), MESH8) == \
        P("model", ("data",))
    assert rules.param_spec(("embed", "table"), (1024, 512), MESH8) == \
        P("model", ("data",))
    assert rules.param_spec("moe.w_gate", (4, 8, 64, 128), MESH8) == \
        P(None, "model", ("data",), None)
    assert rules.param_spec("attn.wq", (30, 7, 9), MESH8) == \
        P(None, None, None)
    assert rules.param_spec("opt.step", (), MESH8) == P()
    assert rules.param_spec("b", (129,), MESH8) == P()
    assert repr(P(None, "model")) == "P(None, 'model')"


BATCHES = [(4, 16), (1, 16), (1, 15), (8,), (6, 512, 64), (256, 4096),
           (1, 524288), (3, 5)]


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_batch_spec_and_sequence_fallback(shape, axes):
    tm, jm = both(shape, axes)
    for b in BATCHES:
        assert tuple(rules.batch_spec(b, tm)) == tuple(
            jrules.batch_spec(b, jm)), b
    assert rules.batch_spec((1, 16), MESH8) == rules.P(None, ("data",))


CACHES = [("blocks.k", (2, 8, 4, 64, 32)), ("v", (8, 4, 64, 32)),
          ("k", (8, 3, 64, 32)), ("k", (8, 3, 6, 32)),
          ("c_kv", (2, 8, 64, 16)), ("k_rope", (8, 6, 8)),
          ("mlstm_groups.mlstm.c", (2, 8, 4, 16, 16)),
          ("rec.h", (8, 128)), ("conv", (8, 3, 128)), ("slstm.n", (8, 64)),
          ("m", (8,)), ("other", (8, 16))]


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_cache_spec_and_activation_rules(shape, axes):
    tm, jm = both(shape, axes)
    for path, dims in CACHES:
        jpath = [types.SimpleNamespace(key=k) for k in path.split(".")]
        assert tuple(rules.cache_spec(path, dims, tm)) == tuple(
            jrules.cache_spec(jpath, dims, jm)), (path, dims)
    trules, jr = rules.activation_rules(tm), jrules.activation_rules(jm)
    for kind, dims in (("activation", (8, 16, 64)), ("logits", (8, 16, 512)),
                       ("logits", (1, 16, 510)), ("moe_dispatch",
                                                  (8, 4, 5, 64)),
                       ("activation", (8,)), ("activation", (3, 5, 64))):
        want = jr(jax.ShapeDtypeStruct(dims, jnp.float32), kind)
        got = trules(torch.empty(dims, device="meta"), kind)
        assert (got is None) == (want is None), (kind, dims)
        if want is not None:
            assert tuple(got) == tuple(want), (kind, dims)


def test_constrain_is_identity_and_rules_scope():
    x = torch.randn(2, 3)
    assert annotate.constrain(x, "activation") is x
    assert annotate.current_mesh() is None
    r = rules.activation_rules(MESH8)
    with annotate.use_rules(r, MESH8):
        assert annotate.current_mesh() is MESH8
        assert annotate.current_rules() is r
        assert annotate.constrain(x, "logits") is x
    assert annotate.current_mesh() is None


def test_to_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    m3 = local.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    assert rules.to_placements(rules.P(("pod", "data"), "model"), m3) == (
        Shard(0), Shard(0), Shard(1))
    assert rules.to_placements(rules.P(None, "model"), MESH8) == (
        Replicate(), Shard(1))
    assert rules.to_placements(rules.P(), MESH8) == (Replicate(),
                                                      Replicate())
    with pytest.raises(ValueError, match="order"):
        rules.to_placements(rules.P(("model", "data")), MESH8)
    with pytest.raises(ValueError, match="shards dims"):
        rules.to_placements(rules.P("model", "model"), MESH8)


# --------------------------------------------------------------------------
# dispatch under a mesh
# --------------------------------------------------------------------------

REFUSALS = [
    {"conv3d": None},
    {"matmul": "model"},
    {"matmul": (None, "model")},
    {"matmul": (None, 3, None)},
    {"matmul": {"axis": (None, None, None)}},
    {"matmul": {"backend": "tpu"}},
]


@pytest.mark.parametrize("specs", REFUSALS)
def test_use_refuses_axis_specs_as_the_reference_does(specs):
    with pytest.raises(ValueError) as jerr:
        with repro.use(mesh=JMESH8, axis_specs=specs):
            pass
    with pytest.raises(ValueError) as terr:
        with dispatch.use(mesh=MESH8, axis_specs=specs):
            pass
    if "backend" not in str(specs):
        assert str(terr.value) == str(jerr.value)
    else:
        assert "unknown backend 'tpu'" in str(terr.value)


def test_use_scopes_mesh_and_axis_specs():
    specs = {"matmul": ((("data",)), "model", None)}
    assert dispatch.current_mesh() is None
    with dispatch.use(mesh=MESH8, axis_specs=specs):
        assert dispatch.current_mesh() is MESH8
        assert dispatch.current_axis_specs() is specs
        assert dispatch.snapshot()[4:] == (MESH8, specs)
        # innermost mapping replaces the outer one whole
        with dispatch.use(axis_specs={"conv2d": (None, None, "model")}):
            assert "matmul" not in dispatch.current_axis_specs()
            assert dispatch.current_mesh() is MESH8
    assert dispatch.current_mesh() is None
    assert dispatch.current_axis_specs() is None


def test_axis_specs_backend_pin_precedence():
    """explicit arg > per-op pin > context backend > env > hardware, as
    the reference's resolve."""
    x = torch.zeros(2, 2)
    pin = {"matmul": {"backend": "torch"}}
    with dispatch.use(backend="cuda", axis_specs=pin):
        assert dispatch.resolve("matmul", None, x) == "torch"
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            dispatch.resolve("matmul", "cuda", x)
        # the pin is per op
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            dispatch.resolve("flash_attention", None, x)
    with dispatch.use(axis_specs={"matmul": {"backend": "cuda"}}):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            dispatch.resolve("matmul", None, x)
    # the reference: the pin beats the context, the argument beats both
    with repro.use(backend="xla",
                   axis_specs={"matmul": {"backend": "pallas"}}):
        assert jdispatch.resolve("matmul") == "pallas"
        assert jdispatch.resolve("matmul", "xla") == "xla"


def _key_of(op, m, n, k, mesh_, specs=None, backend="cuda"):
    with dispatch.use(mesh=mesh_, axis_specs=specs):
        dispatch.resolve_blocks(op, m, n, k, torch.bfloat16,
                                backend=backend)
    (key,) = dispatch.tuning_cache_info()
    dispatch.clear_tuning_cache()
    return key


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_resolve_blocks_localises_and_keys_the_signature(shape, axes):
    tm, jm = both(shape, axes)
    for op, m, n, k in TRIPLES[:6]:
        for specs in (None, {op: (("data",), None, "model")}):
            key = _key_of(op, m, n, k, tm, specs)
            with repro.use(mesh=jm, axis_specs=specs):
                jdispatch.resolve_blocks(op, m, n, k, jnp.bfloat16,
                                         backend="pallas")
            (jkey,) = jdispatch.tuning_cache_info()
            jdispatch.clear_tuning_cache()
            assert key[2:5] == jkey[2:5] == local.local_problem(
                op, m, n, k, tm, specs)
            assert key[8] == jkey[8] == tuple(axes)
    # no mesh: the global triple, signature None
    assert _key_of("matmul", 64, 576, 576, None)[2:5] == (64, 576, 576)
    assert _key_of("matmul", 64, 576, 576, None)[8] is None


def test_running_mesh_triples_are_not_divided_again():
    """A rank of a running mesh hands dispatch its shard's triple: keyed
    with the signature, never localised a second time."""
    running = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": 2, "model": 4},
                                    is_abstract=False, size=8)
    key = _key_of("matmul", 32, 144, 576, running)
    assert key[2:5] == (32, 144, 576) and key[8] == ("data", "model")
    local_ = local.local_problem("matmul", 64, 576, 576, MESH8)
    assert local_ == (32, 144, 576)


def test_mesh_signature_round_trips_save_and_load(tmp_path):
    path = tmp_path / "cache.json"
    with dispatch.use(mesh=MESH8):
        plan = dispatch.resolve_blocks("matmul", 4096, 1536, 576,
                                       torch.bfloat16, backend="cuda")
    dispatch.resolve_blocks("matmul", 4096, 1536, 576, torch.bfloat16,
                            backend="cuda")
    keys = set(dispatch.tuning_cache_info())
    assert {k[8] for k in keys} == {None, ("data", "model")}
    assert dispatch.save_cache(str(path)) == 2
    meshes = sorted(str(e["mesh"]) for e in
                    json.loads(path.read_text())["entries"])
    assert meshes == ["None", "['data', 'model']"]
    dispatch.clear_tuning_cache()
    assert dispatch.load_cache(str(path)) == 2
    assert set(dispatch.tuning_cache_info()) == keys
    assert dispatch.tuning_cache_info()[next(
        k for k in keys if k[8])] == plan
    # the reference's file form: the same "mesh" field, a list of names
    with repro.use(mesh=JMESH8):
        jdispatch.resolve_blocks("matmul", 4096, 1536, 576, jnp.bfloat16,
                                 backend="pallas")
    jpath = tmp_path / "jcache.json"
    jdispatch.save_cache(str(jpath))
    (jentry,) = json.loads(jpath.read_text())["entries"]
    tentry = next(e for e in json.loads(path.read_text())["entries"]
                  if e["mesh"])
    assert jentry["mesh"] == tentry["mesh"]
    assert (jentry["m"], jentry["n"], jentry["k"]) == (
        tentry["m"], tentry["n"], tentry["k"]) == (2048, 384, 576)


def test_trace_event_carries_mesh_and_axes():
    from repro_torch import obs
    tr = obs.Tracer()
    specs = {"matmul": (("data",), None, "model")}
    with dispatch.use(mesh=MESH8, axis_specs=specs, tracer=tr):
        dispatch.resolve_blocks("matmul", 64, 576, 576, torch.bfloat16,
                                backend="cuda")
    (ev,) = tr.events("resolve_blocks")
    assert ev.attrs["mesh"] == str(("data", "model"))
    assert ev.attrs["axes"] == repr((("data",), None, "model"))
    assert (ev.attrs["m"], ev.attrs["n"], ev.attrs["k"]) == (32, 576, 144)


def test_autotune_neighbor_seeds_across_mesh_signatures():
    """A tuned winner under one mesh signature seeds a search under
    another (and none), in both packages: the local problem carries the
    shape, the signature only tags the entry."""
    win = Plan("wgmma", 64, 64, 2, 5, 40)
    dispatch._TUNING_CACHE[("matmul", "cuda", 16, 576, 576, "bfloat16",
                            "autotune", GemmGeometry(True),
                            ("data", "model"), None)] = win
    assert autotune.nearest_tuned_neighbor(
        "matmul", 32, 576, 576, torch.bfloat16, "cuda") == win
    jwin = jblocking.choose_blocks(16, 16, 16, jnp.float32)
    jdispatch._TUNING_CACHE[("matmul", "pallas", 16, 16, 16, "float32",
                             "autotune", None, ("data", "model"),
                             None)] = jwin
    assert jautotune.nearest_tuned_neighbor(
        "matmul", 32, 16, 16, jnp.float32, "pallas") == jwin
    # a heuristic entry never seeds, signature or not
    dispatch.clear_tuning_cache()
    with dispatch.use(mesh=MESH8):
        dispatch.resolve_blocks("matmul", 16, 576, 576, torch.bfloat16,
                                backend="cuda")
    assert autotune.nearest_tuned_neighbor(
        "matmul", 32, 576, 576, torch.bfloat16, "cuda") is None


@pytest.mark.parametrize("op,m,n,k,local_k", [
    ("matmul", 96, 200, 4096, 1024), ("matmul", 4096, 576, 1536, 512),
    ("brgemm", 64, 64, 256, 64), ("batched_matmul", 128, 128, 4096, 1024)])
def test_a_shard_plan_covers_the_global_reduction(op, m, n, k, local_k):
    """Under an abstract mesh the kernel runs the global shape with the
    shard's plan: fitted, its runs cover every slice of the global k and
    keep its split count, and at its own problem it is unchanged."""
    geom = GemmGeometry(True, 4 if op != "matmul" else 1)
    plan = blocking.default_plan(op, m, n, local_k, torch.bfloat16,
                                 geometry=geom)
    nb = 4 if op == "brgemm" else 1
    own = nb * -(-local_k // plan.bk)
    assert blocking.fit_plan(plan, own) == plan
    slices = nb * -(-k // plan.bk)
    fitted = blocking.fit_plan(plan, slices)
    assert fitted.splits * fitted.chunk >= slices > \
        (fitted.splits - 1) * fitted.chunk
    assert fitted.splits <= plan.splits and fitted.mainloop == plan.mainloop
    assert blocking.fit_plan("wgmma", 7) == "wgmma"


def test_matmul_plan_under_an_abstract_mesh_fits_the_call():
    """``plan_call`` on the global operands under a k-localising axis spec:
    the shard's plan, fitted to the whole k."""
    x = torch.zeros(96, 4096, dtype=torch.bfloat16)
    w = torch.zeros(4096, 200, dtype=torch.bfloat16)
    with dispatch.use(mesh=MESH8,
                      axis_specs={"matmul": (None, None, "model")}):
        p = K.plan_call(x, w)
    shard = K.plan(96, 200, 1024, True, True)
    assert (p.mainloop, p.bm, p.bk) == (shard.mainloop, shard.bm, shard.bk)
    assert p.splits * p.chunk * p.bk >= 4096


# --------------------------------------------------------------------------
# the consumers capture the mesh
# --------------------------------------------------------------------------

def test_train_step_captures_explicit_and_annotate_mesh(monkeypatch):
    cfg = configs.get("smollm-135m").reduced()
    ocfg = topt.AdamWCfg()
    state = tts.init_state(cfg, ocfg, torch.Generator().manual_seed(0),
                           "cpu")
    batch = {"tokens": np.zeros((2, 4), np.int32),
             "labels": np.ones((2, 4), np.int32)}
    seen = []
    real = tts.loss_and_grads

    def spy(model, batch, cfg):
        seen.append(dispatch.current_mesh())
        return real(model, batch, cfg)

    monkeypatch.setattr(tts, "loss_and_grads", spy)
    tts.make_train_step(cfg, ocfg, mesh=MESH8)(state, batch)
    assert seen[-1] is MESH8
    with annotate.use_rules(lambda x, kind: None, MESH8):
        tts.make_train_step(cfg, ocfg)(state, batch)
    assert seen[-1] is MESH8
    tts.make_train_step(cfg, ocfg)(state, batch)
    assert seen[-1] is None


def test_serve_tier_context_mesh_fallback():
    assert tengine._tier_context(None, None, None)["mesh"] is None
    with annotate.use_rules(lambda x, kind: None, MESH8):
        assert tengine._tier_context(None, None, None)["mesh"] is MESH8
        other = local.abstract_mesh((4, 2), ("data", "model"))
        assert tengine._tier_context(None, None, None,
                                     mesh=other)["mesh"] is other
    cfg = configs.get("smollm-135m").reduced()
    params = api.init_params(cfg, device="cpu")
    running = types.SimpleNamespace(is_abstract=False, size=4)
    for ctor, conf in ((tengine.Engine, tengine.ServeConfig(max_len=8)),
                       (tengine.ContinuousEngine,
                        tengine.PoolConfig(n_slots=1, max_len=8))):
        with pytest.raises(NotImplementedError, match="queue 1, item 6"):
            ctor(cfg, params, conf, device="cpu", mesh=running)
        with pytest.raises(ValueError, match="axis_specs"):
            ctor(cfg, params, conf, device="cpu", axis_specs={"mm": None})
        eng = ctor(cfg, params, conf, device="cpu", mesh=MESH8,
                   axis_specs={"matmul": (None, "model", None)})
        assert eng.mesh is MESH8


def _spy_matmul(monkeypatch):
    """The plain matmul resolving its plan from its operands as the
    card's wrapper does (``plan_call``): the CPU runs no kernel."""
    real = dispatch._REGISTRY["matmul"]["torch"]

    def resolving(x, w, *args, **kw):
        K.plan_call(x.reshape(-1, x.size(-1)), w)
        return real(x, w, *args, **kw)

    monkeypatch.setitem(dispatch._REGISTRY["matmul"], "torch", resolving)


def test_continuous_engine_resolves_the_references_local_triples(
        monkeypatch):
    """End to end: under the same (2, 4) mesh the port's engine resolves
    the local matmul problems the reference's does (its spy on the
    interpreted Pallas path), quartered out dims among them."""
    from repro.serve import ContinuousEngine as JEngine
    from repro.serve import PoolConfig as JPool
    from repro.serve import Request as JRequest
    jcfg = jconfigs.get("smollm-135m").reduced()
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = configs.get("smollm-135m").reduced()
    tparams = interop.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    _spy_matmul(monkeypatch)

    def run(mesh_, port):
        calls = []

        def spy(op, m, n, k, dtype, backend):
            calls.append((op, m, n, k))
            return (blocking.default_plan(op, m, n, k, dtype) if port
                    else jblocking.default_blocks(op, m, n, k, dtype))

        if port:
            eng = tengine.ContinuousEngine(
                tcfg, tparams, tengine.PoolConfig(n_slots=1, max_len=16),
                blocks_policy=spy, mesh=mesh_, device="cpu")
            eng.serve([tengine.Request(prompt=[3, 5, 7], max_tokens=1,
                                       stop_tokens=())])
        else:
            eng = JEngine(jcfg, jparams, JPool(n_slots=1, max_len=16),
                          backend="pallas", interpret=True,
                          blocks_policy=spy, mesh=mesh_)
            eng.serve([JRequest(prompt=[3, 5, 7], max_tokens=1,
                                stop_tokens=())])
        return {c for c in calls if c[0] == "matmul"}

    meshed, jmeshed = run(MESH8, True), run(JMESH8, False)
    assert meshed == jmeshed and meshed
    meshless = run(None, True)
    assert meshed != meshless
    shrunk = {(op, m, n // 4, k) for op, m, n, k in meshless if n % 4 == 0}
    assert shrunk & meshed


# --------------------------------------------------------------------------
# the dry-run's per-shard plans, the applicability rule, the executor's
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-135m", "grok-1-314b",
                                  "starcoder2-15b"])
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_block_choices_local_triples_match_reference(arch, shape_name):
    tcfg, jcfg = configs.get(arch), jconfigs.get(arch)
    got = dryrun.block_choices(tcfg, shapes.SHAPES[shape_name], MESH8)
    want = jdryrun.block_choices(jcfg, jshapes.SHAPES[shape_name], JMESH8)
    assert [(r["name"], r["op"], r["global"], r["local"]) for r in got] \
        == [(r["name"], r["op"], r["global"], r["local"]) for r in want]
    assert [p[1] for p in dryrun.cell_problems(tcfg, shapes.SHAPES[
        shape_name])] == [p[1] for p in jdryrun.cell_problems(
            jcfg, jshapes.SHAPES[shape_name])]


def test_blocks_smoke_finds_per_shard_plans(capsys):
    assert dryrun.blocks_smoke("smollm-135m", "decode_32k") == 0
    out = capsys.readouterr().out
    assert "per_shard_differs=" in out
    rec = json.loads(out[:out.rindex("}") + 1])
    assert rec["mesh_axes"] == {"data": 2, "model": 4}


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_applicable_matches_reference(arch):
    for name in shapes.SHAPES:
        assert shapes.applicable(configs.get(arch), shapes.SHAPES[name])[0] \
            == jshapes.applicable(jconfigs.get(arch),
                                  jshapes.SHAPES[name])[0]


def test_executor_refuses_what_it_cannot_run():
    smollm = configs.get("smollm-135m")
    two = local.abstract_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="9 q heads"):
        parallel.check_supported(smollm, two)
    parallel.check_supported(smollm, local.abstract_mesh((1, 3),
                                                         ("data", "model")))
    assert parallel.local_cfg(smollm, local.abstract_mesh(
        (2, 3), ("data", "model"))) == dataclasses.replace(
            smollm, n_heads=3, n_kv_heads=1, d_ff=512, vocab=16384,
            head_dim=64)
    # the recurrent families and the encoder-decoder run on any mesh that
    # cuts them evenly, full and reduced; what still raises: an uneven cut
    # (ValueError), and a batch the data axes do not divide (sequence
    # parallelism, queue 1, item 6.3)
    for arch in ("xlstm-1.3b", "recurrentgemma-9b", "seamless-m4t-large-v2"):
        for cfg in (configs.get(arch), configs.get(arch).reduced()):
            for shape in ((1, 2), (2, 1), (2, 2)):
                parallel.check_supported(cfg, local.abstract_mesh(
                    shape, ("data", "model")))
    xlstm = configs.get("xlstm-1.3b")
    with pytest.raises(ValueError, match="4 q heads"):
        parallel.check_supported(xlstm, local.abstract_mesh(
            (1, 3), ("data", "model")))
    layout = parallel.Layout(xlstm.reduced(), local.abstract_mesh(
        (2, 1), ("data", "model")))
    with pytest.raises(NotImplementedError, match="queue 1, item 6.3"):
        layout.batch_rows(3, 16)
    # recurrentgemma's one KV head stays whole in a rank's config (a
    # block of its columns is the rank's: Attention.split), as do its
    # d_rnn (RGLRU.split) and xLSTM's heads (MLSTM.split, SLSTM.split)
    gemma = configs.get("recurrentgemma-9b")
    assert parallel.local_cfg(gemma, local.abstract_mesh(
        (1, 2), ("data", "model"))) == dataclasses.replace(
            gemma, n_heads=8, n_kv_heads=1, d_ff=6144, vocab=128000,
            head_dim=256)
    assert parallel.kv_split(gemma, 2) and not parallel.kv_split(smollm, 3)
    assert parallel.local_cfg(xlstm, local.abstract_mesh(
        (2, 2), ("data", "model"))) == dataclasses.replace(xlstm,
                                                           vocab=25152)
    # dense MLA, deepseek-v3 (mla_moe, MTP) and a VLM run: a rank keeps
    # its heads and vocab rows, and d_ff's block in the dense family and
    # mla_moe's dense blocks (MLA keeps its KV heads' count: it has none)
    dense_mla = dataclasses.replace(smollm, mla=True).reduced()
    deepseek = configs.get("deepseek-v3-671b").reduced()
    llava = configs.get("llava-next-34b").reduced()
    two = local.abstract_mesh((2, 2), ("data", "model"))
    for cfg in (dense_mla, deepseek, llava):
        parallel.check_supported(cfg, local.abstract_mesh(
            (2, 1), ("data", "model")))
        parallel.check_supported(cfg, two)
    assert parallel.local_cfg(dense_mla, two) == dataclasses.replace(
        dense_mla, n_heads=2, d_ff=128, vocab=256, head_dim=32)
    assert parallel.local_cfg(deepseek, two) == dataclasses.replace(
        deepseek, n_heads=2, d_ff=128, vocab=256, head_dim=32)
    assert parallel.local_cfg(llava, two) == dataclasses.replace(
        llava, n_heads=2, n_kv_heads=1, d_ff=128, vocab=256)
    leaves = parallel.Layout(deepseek, two).leaves
    assert [leaves[f"blocks.0.attn.{n}"].model_dim for n in (
        "wq_a", "wkv_a", "wq_b", "wkv_b", "wo", "q_norm.scale")] == \
        [1, 1, 1, 1, 0, None]
    assert leaves["mtp_block.mlp.w_up"].model_dim == 1
    full = configs.get("deepseek-v3-671b")
    assert parallel.local_cfg(full, local.abstract_mesh(
        (1, 2), ("data", "model"))).d_ff == 9216
    with pytest.raises(ValueError, match="25 kv_lora_rank"):
        parallel.check_supported(dataclasses.replace(
            deepseek, kv_lora_rank=17), local.abstract_mesh(
                (1, 2), ("data", "model")))
    # one rank runs any family's config through the same code
    parallel.check_supported(configs.get("deepseek-v3-671b").reduced(),
                             local.abstract_mesh((1, 1), ("data", "model")))
    # the MoE family runs: grok's layout on (2, 2), its expert stacks'
    # E on the model axis and D on the data axis, the router's D on the
    # data axis, E whole on every model rank
    grok = configs.get("grok-1-314b").reduced()
    layout = parallel.Layout(grok, local.abstract_mesh((2, 2),
                                                       ("data", "model")))
    leaves = layout.leaves
    assert (leaves["blocks.0.moe.w_gate"].model_dim,
            leaves["blocks.0.moe.w_gate"].dp_dim) == (0, 1)
    assert (leaves["blocks.3.moe.w_down"].model_dim,
            leaves["blocks.3.moe.w_down"].dp_dim) == (0, 2)
    assert (leaves["blocks.0.moe.router"].model_dim,
            leaves["blocks.0.moe.router"].dp_dim) == (None, 0)
    assert parallel.local_cfg(grok, local.abstract_mesh(
        (2, 2), ("data", "model"))) == dataclasses.replace(
            grok, n_heads=2, n_kv_heads=1, vocab=256, head_dim=32)
    # three experts on two model ranks: each expert's F on the axis
    three = dataclasses.replace(grok, n_experts=3)
    leaves = parallel.Layout(three, local.abstract_mesh(
        (1, 2), ("data", "model"))).leaves
    assert leaves["blocks.0.moe.w_up"].model_dim == 2
    assert leaves["blocks.0.moe.w_down"].model_dim == 1

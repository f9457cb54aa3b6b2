"""The quant tiers on the MoE, MLA and recurrent families, MLA's int8
pages and gradient compression, against the JAX package on the CPU.

Weights are made by the reference from fixed keys and handed over as numpy
arrays (``interop``); inputs come from seeded numpy streams.  The
reference has two expert paths: its XLA branch (``repro/layers/moe.py``,
``expert_gemm``) computes the experts with one einsum in full precision
whatever the quant tier, and cannot take calibrated experts; its kernel
path runs ``batched_matmul`` per routing group, which a tier routes to
``batched_matmul_q``.  The port follows the kernel path, so wherever
experts are quantized the reference runs with ``batched_matmul`` pinned to
its Pallas backend in interpret mode (``kernel_path``), the rest on XLA,
whose quantized GEMMs are the Pallas kernels' exact oracles.

Bands, and why:
  * calibration bits and scales, compression bits, scales and residuals:
    exact (the same fp32 arithmetic on the same values);
  * the folded expert GEMM against the reference's per-group calls: int8
    atol = rtol = 1e-6 (the exact integer sum, the same fp32 epilogue),
    fp8 1e-5 (fp32 sums in other orders), as ``test_torch_quant.py``; the
    activations' int8 / fp8 bits and scales exactly;
  * the MoE layer under a tier: atol = rtol = 1e-4, the MoE layer's fp32
    band (``test_torch_moe.py``): equal routing, then the same quantized
    GEMMs on activations an ulp apart;
  * greedy tokens: exact (each engine under each tier, every family, in
    ``test_torch_quant_engines.py``; here DeepSeek's on int8 pages);
  * int8 pages of MLA's compressed cache: the int8 bits exactly; each
    page's scale (its fp32 absmax / 127) within rtol 1e-6, a few ulps,
    since the pages' fp32 values come from two frameworks' GEMMs;
  * two AdamW steps under gradient compression: the port's own losses
    within the train test's trajectory band (1e-4, ``test_torch_train.py``);
    each step on the reference's own gradients, the master weights within
    its AdamW band (atol = rtol = 1e-6): an int8 code that two
    frameworks' fp32 gradients round apart moves AdamW's first update by
    the learning rate, so the weights are held on equal gradients.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import configs as jconfigs
from repro.core import quantize as JQ
from repro.distributed import collectives as jcollectives
from repro.kernels.brgemm import quant as JQR
from repro.kernels.brgemm import quant_kernel as JQK
from repro.layers import moe as jmoe
from repro.models import api as japi
from repro.models import blocks as jblocks
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import PoolConfig as JPoolConfig
from repro.serve import Request as JRequest
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import interop, quant
from repro_torch.core import brgemm, dispatch
from repro_torch.distributed import collectives
from repro_torch.kernels.brgemm import quant as TQ
from repro_torch.layers import moe
from repro_torch.serve import ContinuousEngine, PoolConfig, Request
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

FAMILIES = ("grok-1-314b", "deepseek-v3-671b", "xlstm-1.3b",
            "recurrentgemma-9b")
MOE_FAMILIES = FAMILIES[:2]
TIERS = ("decode_int8", "calibrated_int8", "calibrated_fp8")
LAYER = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 32
PIN = {"batched_matmul": {"backend": "pallas"}}


@contextlib.contextmanager
def kernel_path(**kw):
    """The reference with its expert GEMMs on its kernel path."""
    with repro.use(axis_specs=PIN, interpret=True, **kw):
        yield


def _bits(a):
    if isinstance(a, torch.Tensor):
        return (a.numpy() if a.dtype == torch.int8
                else a.view(torch.uint8).numpy())
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.view(np.uint8)


@pytest.fixture(scope="module")
def families():
    out = {}
    for name in FAMILIES:
        jcfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
        jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, tcfg, jparams, interop.params_from_numpy(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    return out


@pytest.fixture(scope="module")
def ref_calibrated(families):
    """The reference's calibrated trees, each made once when first asked
    for."""
    made = {}

    def get(name, spec):
        if (name, spec) not in made:
            made[name, spec] = JQ.calibrate_params(families[name][2], spec)
        return made[name, spec]
    return get


# ==========================================================================
# calibration
# ==========================================================================

@pytest.mark.parametrize("spec", ["int8", "fp8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_calibration_matches_reference_bits(families, ref_calibrated, name,
                                            spec):
    """Every weight the reference calibrates, the port calibrates to the
    same bits and scales: the (E, D, F) / (E, F, D) experts per expert and
    column, (E, F) scales; MLA's wkv_b, the routers, sLSTM's r and the
    biases stay full precision in both."""
    jcfg, tcfg, jparams, model = families[name]
    want = {n: leaf for n, leaf in interop.named_leaves(
        jax.tree.map(np.asarray, ref_calibrated(name, spec)), tcfg)
        if isinstance(leaf, tuple)}
    own = quant.calibrate_params(model, spec)
    got = {n: m for n, m in own.named_modules()
           if isinstance(m, quant.QuantizedTensor)}
    assert sorted(got) == sorted(want)
    assert not any(n.endswith(("wkv_b", "router", ".r")) for n in got)
    if name in MOE_FAMILIES:
        experts = [n for n in got if n.endswith("moe.w_gate")]
        assert experts
        for n in experts:
            e, d, f = got[n].shape
            assert got[n].scale.shape == (e, f)
    for n, qt in got.items():
        q, scale = want[n]
        np.testing.assert_array_equal(_bits(qt.q), _bits(q), err_msg=n)
        np.testing.assert_array_equal(qt.scale.numpy(), scale, err_msg=n)
        assert qt.q.mT.is_contiguous()          # K-major storage
    # the copy holds no full-precision copy of a replaced weight
    assert sum(p.numel() for p in own.parameters()) < sum(
        p.numel() for p in model.parameters())


def test_stacked_weights_quantize_a_chunk_at_a_time(monkeypatch):
    """A stacked weight quantized a few entries at a time gives one pass's
    bits, scales and K-major layout."""
    from repro_torch.core import quantize as Q
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, 48, 40)).astype(np.float32))
    for g in ("per_channel", "per_tensor"):
        qcfg = quant.QuantConfig(granularity=g)
        whole = Q.quantize_weight(w, qcfg)
        monkeypatch.setattr(Q, "QUANT_CHUNK_BYTES", 4 * 48 * 40 * 4)
        parts = Q.quantize_weight(w, qcfg)
        monkeypatch.undo()
        assert torch.equal(parts.q, whole.q)
        assert torch.equal(parts.scale, whole.scale)
        assert parts.q.stride() == whole.q.stride()


# ==========================================================================
# the folded expert operand
# ==========================================================================

def _expert_operands(seed=7, g=3, e=4, cap=8, d=32, f=24):
    """(G, E, cap, D) routed rows with empty slots (all-zero rows) and one
    all-zero group, and (E, D, F) expert weights."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((g, e, cap, d)).astype(np.float32)
    a[:, :, cap - 3:] = 0.0            # slots routing left empty
    a[1] = 0.0                         # a group that routed nothing
    a[2] *= 3.0                        # groups of different ranges
    w = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    return a, w


def _reference_groups(a, w, qcfg):
    """The reference's kernel path: one call a group (its MoE's vmap), each
    quantizing its activations (``_quantize_act``) and running
    ``batched_matmul_q_pallas`` interpreted.  Returns (out, aq, sa)."""
    bq, sb = JQR._weight_qparams(jnp.asarray(w), qcfg)

    def one(lhs):
        aq, sa = JQR._quantize_act(lhs, qcfg, axis=(-1,))
        sa = jnp.broadcast_to(jnp.atleast_2d(sa), lhs.shape[:2])
        return JQK.batched_matmul_q_pallas(aq, bq, sa, sb,
                                           interpret=True), aq, sa

    return jax.vmap(one)(jnp.asarray(a))


def _fold(x):
    """(G, E, cap, ...) -> the port's (E, G * cap, ...)."""
    x = np.asarray(x)
    g, e, cap = x.shape[:3]
    return np.swapaxes(x, 0, 1).reshape(e, g * cap, *x.shape[3:])


@pytest.mark.parametrize("a_granularity", ["per_row", "per_tensor"])
@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_folded_experts_match_reference_groups(dtype, a_granularity):
    """``batched_matmul_q`` on the folded (E, G * cap, D) operand against a
    vmap of the reference's kernel over the groups: per-row scales are the
    same either way; per-tensor ones are taken a group across the experts
    (``a_groups``), an all-zero group's being the reference's scale of
    zeros.  Activation bits and scales exactly, outputs in the band."""
    a, w = _expert_operands()
    g = a.shape[0]
    qcfg = JQ.QuantConfig(w_dtype=dtype, a_dtype=dtype,
                          a_granularity=a_granularity)
    want, jaq, jsa = _reference_groups(a, w, qcfg)
    tcfg = quant.QuantConfig(w_dtype=dtype, a_dtype=dtype,
                             a_granularity=a_granularity)
    ta = torch.from_numpy(_fold(a))
    if a_granularity == "per_tensor":
        aq, sa = TQ._quantize_act_groups(ta, tcfg, g)
        assert (sa[:, 8:16] == np.float32(1e-30) / np.float32(
            JQ.QMAX[dtype])).all()           # the all-zero group
    else:
        aq, sa = TQ._quantize_act(ta, tcfg, axis=(-1,))
    np.testing.assert_array_equal(_bits(aq), _fold(_bits(jaq)))
    np.testing.assert_array_equal(sa.expand(ta.shape[:2]).numpy(),
                                  _fold(np.asarray(jsa)))
    with torch.no_grad():
        got = brgemm.batched_matmul(ta, torch.from_numpy(w), quant=tcfg,
                                    a_groups=g)
    band = (dict(atol=1e-6, rtol=1e-6) if dtype == "int8"
            else dict(atol=1e-5, rtol=1e-5))
    np.testing.assert_allclose(got.numpy(), _fold(want), **band)
    if a_granularity == "per_tensor":     # one scale over every group is not
        with torch.no_grad():             # the reference's
            flat = brgemm.batched_matmul(ta, torch.from_numpy(w), quant=tcfg)
        assert not np.allclose(flat.numpy(), _fold(want), **band)


# ==========================================================================
# the MoE layer under a tier
# ==========================================================================

LAYER_TIERS = ("ambient_int8", "calibrated_int8", "calibrated_fp8",
               "per_tensor_int8")


def _moe_layer(name, seed=1):
    jmcfg = jblocks.moe_cfg(jconfigs.get(name).reduced())
    jp = jmoe.init(jax.random.PRNGKey(seed), jmcfg)
    layer = moe.MoE(moe.MoECfg(**dataclasses.asdict(jmcfg)))
    with torch.no_grad():
        for pname, p in layer.named_parameters():
            node = jp
            for key in pname.split("."):
                node = node[key]
            p.copy_(torch.tensor(np.asarray(node)))
    return jmcfg, jp, layer


@pytest.mark.parametrize("tier", LAYER_TIERS)
@pytest.mark.parametrize("name", MOE_FAMILIES)
def test_moe_layer_tiers_match_reference(name, tier):
    """The layer of reduced grok (no shared expert) and reduced DeepSeek
    (a shared expert, 8 experts) under each tier against the reference's
    kernel-path layer, two routing groups (a prefill's, one a row) folded
    into the experts' rows: the router (under an ambient tier), the
    shared experts and the three expert GEMMs quantized.  Decode's one
    group and the slots' one a slot run in the engine tests."""
    jmcfg, jp, layer = _moe_layer(name)
    x = np.random.default_rng(2).standard_normal(
        (2, 12, jmcfg.d_model)).astype(np.float32)
    spec = None
    if tier.startswith("calibrated"):
        jp = JQ.calibrate_params(jp, tier.split("_")[1])
        layer = quant.calibrate_params(layer, tier.split("_")[1])
    elif tier == "ambient_int8":
        spec = "int8"
    else:
        spec = "int8:int8:per_channel:per_tensor:absmax"
    with kernel_path(quant=spec):
        want, waux = jmoe.apply(jp, jnp.asarray(x), jmcfg)
    with torch.no_grad(), dispatch.use(quant=spec):
        got, aux = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    for key in ("load_balance_loss", "router_z_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(aux[key]), float(waux[key]),
                                   **LAYER)
    if tier != "per_tensor_int8":
        return
    with torch.no_grad():                 # the tier changed the output
        full, _ = _moe_layer(name)[2](torch.from_numpy(x))
    assert not np.allclose(full.numpy(), got.numpy(), **LAYER)


# ==========================================================================
# int8 pages of MLA's compressed cache
# ==========================================================================

def _page_pools(families, lens, max_tokens):
    """The reference's and the port's DeepSeek pools on int8 pages, two
    slots of pages of 4, after serving prompts of ``lens`` tokens to
    ``max_tokens`` tokens each, and both outputs."""
    jcfg, tcfg, jparams, model = families["deepseek-v3-671b"]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in lens]
    kw = dict(n_slots=2, max_len=MAX_LEN, page_size=4, kv_quant="int8")
    ref = JContinuousEngine(jcfg, jparams, JPoolConfig(**kw))
    port = ContinuousEngine(tcfg, model, PoolConfig(**kw), device="cpu")
    want = ref.serve([JRequest(prompt=p, max_tokens=m, stop_tokens=())
                      for p, m in zip(prompts, max_tokens)])
    got = port.serve([Request(prompt=p, max_tokens=m, stop_tokens=())
                      for p, m in zip(prompts, max_tokens)])
    return ref.pool, port.pool, want, got


@pytest.mark.parametrize("max_tokens", [(1, 1), (2, 2), (3, 5, 2)],
                         ids=["after_prefill", "after_decode",
                              "slots_refill"])
def test_mla_int8_pages_match_reference(families, max_tokens):
    """Each page of ``{"c_kv", "k_rope"}`` has one scale a stack (the
    dense block and the MoE blocks apart, as the reference's tree stacks
    them), keyed ``<stack>.<key>``: the int8 bits of every page equal the
    reference's, the scales within a few ulps, and so do the tokens.
    After the prefills' inserts alone (one token each, no decode step);
    after one decode step; and three requests through two slots, a freed
    slot's pages taken again, every page re-quantized each step."""
    lens = (13, 6, 9)[:len(max_tokens)]
    jpool, tpool, want, got = _page_pools(families, lens, max_tokens)
    assert got == want
    assert tpool.page_alloc_count == tpool.page_free_count
    nd = families["deepseek-v3-671b"][1].n_dense_layers
    leaves = jax.tree_util.tree_flatten_with_path(jpool.data)[0]
    names = [".".join(str(k.key) for k in path) for path, _ in leaves]
    assert sorted(tpool.scales) == sorted(names) == [
        "dense_blocks.c_kv", "dense_blocks.k_rope", "moe_blocks.c_kv",
        "moe_blocks.k_rope"]
    for (_, leaf), name, scale in zip(leaves, names, jpool.scales):
        stack, key = name.split(".")
        pages = tpool.data[key]
        pages = pages[:nd] if stack == "dense_blocks" else pages[nd:]
        np.testing.assert_array_equal(pages.numpy(), np.asarray(leaf),
                                      err_msg=name)
        np.testing.assert_allclose(tpool.scales[name].numpy(),
                                   np.asarray(scale), rtol=1e-6, atol=0,
                                   err_msg=name)
    assert tpool.kv_bytes() == int(jpool.kv_bytes())


# ==========================================================================
# gradient compression
# ==========================================================================

def _grads(seed=9):
    rng = np.random.default_rng(seed)
    grads = {"a": rng.standard_normal((6, 5)).astype(np.float32),
             "b": (rng.standard_normal(7) * 1e-3).astype(np.float32),
             "c": np.zeros((3, 2, 4), np.float32),
             "d": (rng.standard_normal((4, 4)) * 50).astype(np.float32)}
    grads["a"][0, 0] = 2.5 * np.abs(grads["a"]).max()   # a lone absmax
    return grads


def test_compress_grads_share_a_stacked_leaf_scale():
    """The reference's leaf stacks the layers, so one int8 scale covers
    every layer of it: the port's per-layer gradients grouped as
    ``interop.stacked_leaves`` names them get the stacked leaf's bits."""
    stack = _grads()["a"][None] * np.array([1.0, 3.0, 0.0],
                                             np.float32)[:, None, None]
    jq, js = jcollectives.compress_grads({"s": jnp.asarray(stack)})
    tq, ts = collectives.compress_grads(
        {f"s.{i}": torch.from_numpy(stack[i]) for i in range(3)},
        groups={f"s.{i}": "s" for i in range(3)})
    np.testing.assert_array_equal(
        np.stack([tq[f"s.{i}"].numpy() for i in range(3)]),
        np.asarray(jq["s"]))
    assert all(ts[f"s.{i}"].item() == float(js["s"]) for i in range(3))
    tcfg = tconfigs.get("smollm-135m").reduced()
    leaves = interop.stacked_leaves(tcfg)
    assert leaves["blocks.1.attn.wq"] == leaves["blocks.0.attn.wq"] == \
        "blocks.attn.wq"


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_compress_grads_match_reference_bits(kind):
    grads = _grads()
    jq, js = jcollectives.compress_grads(
        {n: jnp.asarray(g) for n, g in grads.items()}, kind=kind)
    tq, ts = collectives.compress_grads(
        {n: torch.from_numpy(g) for n, g in grads.items()}, kind=kind)
    assert (ts is None) == (js is None) == (kind == "bf16")
    for n in grads:
        if kind == "int8":
            assert tq[n].dtype == torch.int8
            np.testing.assert_array_equal(tq[n].numpy(), np.asarray(jq[n]))
            np.testing.assert_array_equal(ts[n].numpy(), np.asarray(js[n]))
        else:
            assert tq[n].dtype == torch.bfloat16
            np.testing.assert_array_equal(tq[n].float().numpy(),
                                          np.asarray(jq[n], np.float32))
    jd = jcollectives.decompress_grads(jq, js, kind=kind)
    td = collectives.decompress_grads(tq, ts, kind=kind)
    for n in grads:
        assert td[n].dtype == torch.float32
        np.testing.assert_array_equal(td[n].numpy(), np.asarray(jd[n]))
    with pytest.raises(ValueError):
        collectives.compress_grads(tq, kind="fp4")


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_error_feedback_matches_reference_bits(kind):
    """Two steps: from no residual, then carrying the first's."""
    jres = tres = None
    for seed in (9, 10):
        grads = _grads(seed)
        jd, jres = jcollectives.compress_with_error_feedback(
            {n: jnp.asarray(g) for n, g in grads.items()}, jres, kind=kind)
        td, tres = collectives.compress_with_error_feedback(
            {n: torch.from_numpy(g) for n, g in grads.items()}, tres,
            kind=kind)
        for n in grads:
            np.testing.assert_array_equal(td[n].numpy(), np.asarray(jd[n]))
            np.testing.assert_array_equal(tres[n].numpy(),
                                          np.asarray(jres[n]))


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_train_step_grad_compression_matches_reference(kind, monkeypatch):
    """Two AdamW steps of reduced smollm at a full learning rate under
    gradient compression, both ways the train tests hold a step:

    * the port's own two steps: the losses within the train test's
      trajectory band (1e-4), since each framework's fp32 gradients can
      straddle an int8 rounding step differently, and AdamW's first
      update moves a weight by about the learning rate whatever the size
      of its gradient;
    * each step on the reference's own gradients, taken from its step
      (from the reference's state before it): the master weights within
      the AdamW band (1e-6), AdamW handed fp32 gradients, exactly the
      reference's compression of them."""
    jcfg = jconfigs.get("smollm-135m").reduced()
    tcfg = tconfigs.get("smollm-135m").reduced()
    state = jts.init_state(jax.random.PRNGKey(0), jcfg, jopt.AdamWCfg())
    state["opt"]["step"] = jnp.asarray(1500, jnp.int32)
    rng = np.random.default_rng(6)
    batches = [{k: rng.integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]

    raw = []            # the reference step's gradients, before compression
    real_compress = jts.compress_grads

    def capture(grads, *, kind):
        jax.debug.callback(lambda g: raw.append(jax.tree.map(np.asarray, g)),
                           grads)
        return real_compress(grads, kind=kind)

    monkeypatch.setattr(jts, "compress_grads", capture)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.AdamWCfg(),
                                        grad_compression=kind))
    jstates, jlosses = [jax.tree.map(np.asarray, state)], []
    for b in batches:
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        jax.effects_barrier()
        jstates.append(jax.tree.map(np.asarray, state))
        jlosses.append(float(jm["loss"]))

    own = {"opt": interop.opt_state_from_numpy(jstates[0]["opt"], tcfg,
                                               "cpu")}
    step = tts.make_train_step(tcfg, topt.AdamWCfg(), grad_compression=kind)
    for b, want in zip(batches, jlosses):
        own, tm = step(own, b)
        np.testing.assert_allclose(float(tm["loss"]), want, atol=1e-4,
                                   rtol=0)

    handed = []
    real_adamw = topt.adamw_update

    def spy(grads, *args):
        handed.append(grads)
        return real_adamw(grads, *args)

    monkeypatch.setattr(topt, "adamw_update", spy)
    for i, b in enumerate(batches):
        grads = {n: torch.from_numpy(np.array(g)) for n, g in
                 interop.named_leaves(raw[i], tcfg)}
        monkeypatch.setattr(tts, "loss_and_grads", lambda model, batch, cfg:
                            ({}, grads))
        start = {"opt": interop.opt_state_from_numpy(jstates[i]["opt"],
                                                     tcfg, "cpu")}
        new, _ = step(start, b)
        want = collectives.decompress_grads(*collectives.compress_grads(
            grads, kind=kind, groups=interop.stacked_leaves(tcfg)),
            kind=kind)
        assert all(handed[-1][n].dtype == torch.float32 and torch.equal(
            handed[-1][n], want[n]) for n in want)
        assert any(not torch.equal(want[n], grads[n]) for n in want)
        got = dict(jax.tree_util.tree_leaves_with_path(
            interop.opt_state_to_numpy(new["opt"])["master"]))
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                jstates[i + 1]["opt"]["master"]):
            np.testing.assert_allclose(got[path], leaf, atol=1e-6,
                                       rtol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="grad_compression"):
        tts.make_train_step(tcfg, topt.AdamWCfg(), grad_compression="fp4")

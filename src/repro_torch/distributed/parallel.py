"""Data x model parallel training of every family (the dense, MoE and MLA
ones, a VLM's patch projection among them, the recurrent xLSTM and
RecurrentGemma, and the encoder-decoder) on a mesh of the running world:
what the reference gets from GSPMD, done by hand.

Each rank holds the shards that ``sharding.rules.param_shardings`` gives
its coordinate: the fp32 master copy and AdamW's moments split over the
data axes (ZeRO-3: a column-parallel weight's in dim, a row-parallel
weight's out dim, the table's embed dim, an expert stack's D, where they
divide) and over the model axis (tensor and expert parallelism).  The
working model is the ``Transformer`` (or ``EncDec``) of the rank's part
of the model axis (``local_cfg``: its heads, ``d_ff`` and vocab rows),
its layers told the model axis (``tp``, a ``collectives.AxisGroup``):

  * column-parallel ``wq``, ``wk``, ``wv``, ``w_gate`` and ``w_up`` run on
    the rank's heads and ``d_ff`` columns; their input's gradient is
    summed over the axis (``collectives.copy_to_model``);
  * row-parallel ``wo`` and ``w_down`` sum their partial outputs
    (``collectives.reduce_from_model``);
  * MLA (dense, and DeepSeek-V3's dense and MoE stacks and MTP block)
    runs its heads' ``wq_b``, ``wkv_b`` and ``wo`` so, and all-gathers its
    blocks of the low-rank outputs ``x @ wq_a`` and ``x @ wkv_a`` to norm
    them whole (``layers/attention.py::MLAttention``,
    ``collectives.gather_from_model``); a VLM's patch projection gathers
    its column blocks likewise (``models/transformer.py::VisionProj``);
  * where the axis cuts within the KV heads (recurrentgemma's one), a
    rank keeps them whole in its config, computes its block of K's and
    V's columns and all-gathers it before RoPE (``Attention.split``);
  * xLSTM's mLSTM runs the rank's heads, its output gate's row-sharded
    ``wo`` gathered whole; its sLSTM gathers its gate-major ``w`` and
    ``r`` and runs whole on every rank; RG-LRU runs the rank's block of
    d_rnn, its block of v gathered for the gates (``layers/
    recurrent.py``: ``MLSTM.split``, ``SLSTM.split``, ``RGLRU.split``);
  * the encoder-decoder's encoder and cross-attention read their inputs
    and the memory through ``copy_to_model`` (``models/encdec.py``);
  * a MoE layer holds E/m whole experts (expert parallelism), or every
    expert's F/m columns where E does not divide (the reference's
    few-experts fallback), routes over all E from the replicated router,
    and sums its partial outputs over the axis (``layers/moe.py``); its
    routing groups are the rank's batch rows, and its aux losses the
    reference's global means, reduced over the data axes;
  * the vocab-sharded table embeds by a masked lookup and a sum, and the
    tied head (or an untied ``head.w``) gives the rank's block of the
    logits, which are never gathered: :func:`xent_sum` takes the
    cross-entropy over them, its max and sum of exponentials reduced over
    the axis.

Before a top-level module's first forward of a step (the embedding, each
block, the final norm, an untied head) a hook casts its master shards to
``cfg.dtype`` and all-gathers them over the data axes into the working
parameters (ZeRO-3's gather; the gathered copies stay until the next
step).  After the backward each gradient is reduce-scattered over the data
axes back to the shard (a leaf the data axes replicate is all-reduced).
The loss is the global mean: each rank's sum over its tokens, divided by
the token count summed over the data axes, so gradients sum exactly
whatever the ranks' counts.  The gradient norm that clips the update sums
squares over every rank, each leaf's counted once (``optimizer.
global_norm``).  A rank takes its batch rows by ``rules.batch_spec``.

Microbatches are the reference's: microbatch i is rows [i B/mb, (i+1)
B/mb) of the global batch, of which each rank takes its data share; the
rank's gradients are summed in fp32 over the microbatches, divided by
their count and then reduced; the metrics are the last microbatch's.
Gradient compression quantizes the reduced shards, each stacked leaf of
the reference's tree with one absmax scale, the max over every rank that
holds a part of it (``collectives.compress_grads(ax=)``), so the values
quantized are the reference's global ones.

With an MTP block the loss adds ``MTP_WEIGHT`` times its cross-entropy
over the vocab-sharded MTP logits, its own global mean (its token count,
``labels[:, 1:]``'s, summed over the data axes).  Sequence parallelism,
a batch the data axes do not divide, raises ``NotImplementedError``
(ROADMAP queue 1, item 6.3).  A one-rank mesh runs the same code with
every collective a no-op, and matches the meshless step.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import obs
from repro_torch.configs.base import ArchCfg
from repro_torch.core import dispatch
from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import dp_axes, model_size
from repro_torch.sharding import rules
from repro_torch.sharding.local import shard_count
from repro_torch.train import optimizer as opt
from repro_torch.train.schedule import warmup_cosine

SEQUENCE = "ROADMAP.md queue 1, item 6.3 (sequence parallelism)"


def kv_split(cfg: ArchCfg, m: int) -> bool:
    """Whether an ``m``-way model axis cuts within ``cfg``'s KV heads (a
    GQA config whose KV heads do not divide: ``Attention.split``)."""
    return not cfg.mla and cfg.n_kv_heads % m != 0


def check_supported(cfg: ArchCfg, mesh) -> None:
    """Raises ``ValueError`` where the model axis would cut a head, the
    KV heads' columns (whole heads in the encoder-decoder), ``d_ff``, the
    vocab, MLA's low-rank outputs, a VLM's projection, the experts, xLSTM's
    gate columns or RG-LRU's channels unevenly: the executor never
    replicates a weight the rules would shard."""
    if mesh.size == 1:
        return
    m = model_size(mesh)
    sizes = [("q heads", cfg.n_heads), ("vocab", cfg.vocab)]
    if cfg.mla:
        sizes += [("q_lora_rank", cfg.q_lora_rank),
                  ("kv_lora_rank + qk_rope_dim",
                   cfg.kv_lora_rank + cfg.qk_rope_dim)]
    elif cfg.block == "encdec":
        sizes.append(("kv heads", cfg.n_kv_heads))
    elif cfg.block != "xlstm":
        sizes.append(("kv heads x head_dim (K's and V's columns)",
                      cfg.n_kv_heads * cfg.dh))
    if cfg.n_patches:
        sizes.append(("d_model (the patch projection)", cfg.d_model))
    if cfg.block == "xlstm":
        sizes += [("d_model (mLSTM's output-gate rows)", cfg.d_model),
                  ("4 x d_model (sLSTM's gate columns)", 4 * cfg.d_model),
                  ("4 x sLSTM head size (its recurrent columns)",
                   4 * (cfg.d_model // cfg.n_heads))]
    elif cfg.block != "moe":     # dense blocks, mla_moe's first, MLPs
        sizes.append(("d_ff", cfg.d_ff))
    if cfg.block == "rglru_hybrid":
        sizes.append(("d_rnn", cfg.d_rnn))
    if cfg.block in ("moe", "mla_moe"):
        sizes.append(("shared experts' d_ff",
                      cfg.moe_d_ff * cfg.n_shared_experts))
        if cfg.n_experts % m and cfg.moe_d_ff % m:
            raise ValueError(
                f"{cfg.name}: neither its {cfg.n_experts} experts nor their "
                f"d_ff {cfg.moe_d_ff} split over a {m}-way model axis")
    for what, n in sizes:
        if n % m:
            raise ValueError(
                f"{cfg.name}: {n} {what} do not split over a {m}-way model "
                f"axis; the executor never replicates a weight the rules "
                f"would shard")


def local_cfg(cfg: ArchCfg, mesh) -> ArchCfg:
    """The config of one rank's part of the model axis: its heads, vocab
    rows and dense ``d_ff`` (the dense family's, mla_moe's first blocks'
    and MTP block's, RecurrentGemma's and the encoder-decoder's MLPs).  A
    MoE keeps E and F whole here: its layers are cut by ``MoE.split``, and
    route over all E.  MLA's low-rank projections and a VLM's are cut by
    ``MLAttention.split`` and ``VisionProj.split``; MLA has no KV heads to
    cut.  KV heads the axis cuts within stay whole (``kv_split``:
    ``Attention.split`` cuts their columns).  xLSTM keeps its heads
    (``MLSTM.split`` and ``SLSTM.split`` cut its mixers) and RG-LRU its
    d_rnn (``RGLRU.split``)."""
    m = model_size(mesh)
    if cfg.block == "xlstm":
        return dataclasses.replace(cfg, vocab=cfg.vocab // m)
    whole_kv = cfg.mla or kv_split(cfg, m)
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // m,
        n_kv_heads=cfg.n_kv_heads if whole_kv else cfg.n_kv_heads // m,
        d_ff=cfg.d_ff if cfg.block == "moe" else cfg.d_ff // m,
        vocab=cfg.vocab // m, head_dim=cfg.dh)


def model_class(cfg: ArchCfg):
    """The model of ``cfg``: ``EncDec`` for the encoder-decoder, else
    ``Transformer``."""
    if cfg.block == "encdec":
        from repro_torch.models.encdec import EncDec
        return EncDec
    from repro_torch.models.transformer import Transformer
    return Transformer


def _axis(mesh, axes, name) -> C.AxisGroup:
    """The axis group of ``axes`` on ``mesh``; on an abstract mesh, its
    size alone (no group, index 0)."""
    size = math.prod(mesh.shape[a] for a in axes) if axes else 1
    if mesh.is_abstract:
        return C.AxisGroup(name, None, size, 0)
    return C.AxisGroup(name, mesh.group(axes), size, mesh.index(axes))


@dataclasses.dataclass(frozen=True)
class Leaf:
    """Where one parameter lives: its global ``shape`` and ``spec``, the
    dim the data axes split (``dp_dim``) and the model axis splits
    (``model_dim``), each or None, and ``replicas``, the ranks that hold
    each of its elements."""
    shape: tuple
    spec: tuple
    dp_dim: int | None
    model_dim: int | None
    replicas: int


class Layout:
    """The parameters of ``cfg`` on ``mesh`` (a mesh of the running
    world): each one's ``Leaf`` by name, the data and model axes as this
    rank sees them (``dp``, ``model``, ``world``).  On an abstract mesh
    only the leaves and the axes' sizes are meaningful."""

    def __init__(self, cfg: ArchCfg, mesh):
        check_supported(cfg, mesh)
        self.cfg, self.mesh = cfg, mesh
        dp = dp_axes(mesh)
        # Every rank makes the groups in this order (a collective call).
        self.dp = _axis(mesh, dp, "data")
        self.model = _axis(mesh, ("model",) if "model" in mesh.axis_names
                           else (), "model")
        self.world = _axis(mesh, mesh.axis_names, "world")
        shapes = {n: tuple(p.shape) for n, p in
                  model_class(cfg)(cfg, device="meta").named_parameters()}
        self.leaves = {}
        for name, spec in rules.param_shardings(shapes, mesh, cfg).items():
            shape = shapes[name]
            dims = {"dp": None, "model": None}
            shards = 1
            for d, entry in enumerate(tuple(spec)):
                n = shard_count(shape[d], entry, mesh)
                if n == 1:
                    continue
                shards *= n
                axes = (entry,) if isinstance(entry, str) else tuple(entry)
                kind = "model" if "model" in axes else "dp"
                if kind == "model" and len(axes) > 1:
                    raise ValueError(
                        f"{name}: spec {spec} shards one dim over the model "
                        f"and data axes; the executor cuts a dim over one "
                        f"kind of axis")
                dims[kind] = d
            self.leaves[name] = Leaf(shape, tuple(spec), dims["dp"],
                                     dims["model"], mesh.size // shards)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of parameter ``name`` from its whole value."""
        leaf = self.leaves[name]
        return full[rules.local_slices(leaf.shape, leaf.spec, self.mesh)]

    def model_part(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``name`` along the model axis only (the
        working parameter's value)."""
        leaf = self.leaves[name]
        if leaf.model_dim is None:
            return full
        n = leaf.shape[leaf.model_dim] // self.model.size
        return full.narrow(leaf.model_dim, self.model.index * n, n)

    def gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The working parameter (the model-axis part) from a shard."""
        dim = self.leaves[name].dp_dim
        return shard if dim is None else C.all_gather(shard, self.dp, dim)

    def gather_whole(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole parameter from a shard (every rank gets it)."""
        leaf = self.leaves[name]
        part = self.gather(name, shard)
        if leaf.model_dim is None:
            return part
        return C.all_gather(part, self.model, leaf.model_dim)

    def reduce_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """The data axes' summed gradient of ``name``, as its shard."""
        dim = self.leaves[name].dp_dim
        if dim is None:
            return C.all_reduce(g.contiguous().clone(), self.dp)
        return C.reduce_scatter(g, self.dp, dim)

    def replicas(self) -> dict[str, int]:
        return {n: leaf.replicas for n, leaf in self.leaves.items()}

    def batch_rows(self, rows: int, seq: int) -> slice:
        """This rank's rows of a (rows, seq) global batch."""
        spec = rules.batch_spec((rows, seq), self.mesh)
        if spec[0] is not None:
            n = rows // self.dp.size
            return slice(self.dp.index * n, (self.dp.index + 1) * n)
        if len(spec) > 1 and spec[1] is not None:
            raise NotImplementedError(
                f"a batch of {rows} rows does not split over "
                f"{self.dp.size} data ranks, and sequence parallelism is "
                f"not ported yet ({SEQUENCE})")
        return slice(None)


def init_state(cfg: ArchCfg, ocfg: opt.AdamWCfg, mesh, generator=None,
               device="cuda") -> dict:
    """This rank's shard of the train state of random weights drawn as
    the meshless ``train_step.init_state`` draws them (every rank draws
    all of them on the host, from the same generator, and keeps its
    shard)."""
    from repro_torch.models import api
    layout = Layout(cfg, mesh)
    full = api.init_params(cfg, generator, device="cpu")
    with torch.no_grad():
        master = {n: layout.shard(n, p.detach()).float().to(device)
                  .contiguous() for n, p in full.named_parameters()}
    mdt = getattr(torch, ocfg.moment_dtype)
    return {"opt": {"step": 0,
                    "m": {n: torch.zeros_like(t, dtype=mdt)
                          for n, t in master.items()},
                    "v": {n: torch.zeros_like(t, dtype=mdt)
                          for n, t in master.items()},
                    "master": master}}


def shard_state(state: dict, cfg: ArchCfg, mesh, device=None) -> dict:
    """This rank's shard of a whole train state (``{"opt": ...}``, every
    leaf whole, as a checkpoint holds it)."""
    layout = Layout(cfg, mesh)

    def cut(tree):
        return {n: layout.shard(n, t).to(device or t.device).contiguous()
                for n, t in tree.items()}

    o = state["opt"]
    return {"opt": {"step": o["step"], "m": cut(o["m"]), "v": cut(o["v"]),
                    "master": cut(o["master"])}}


def gather_state(state: dict, cfg: ArchCfg, mesh) -> dict:
    """The whole train state from every rank's shard (a collective: every
    rank gets it)."""
    layout = Layout(cfg, mesh)

    def whole(tree):
        return {n: layout.gather_whole(n, t) for n, t in tree.items()}

    o = state["opt"]
    return {"opt": {"step": o["step"], "m": whole(o["m"]),
                    "v": whole(o["v"]), "master": whole(o["master"])}}


def xent_sum(logits, labels, mask, tp):
    """The sum over ``mask`` of -log p(label), from fp32 logits whose last
    dim is the vocab, or, on a model axis ``tp``, this rank's block of it
    (the max and the sum of exponentials reduced over the axis; a label
    outside the block contributes its logit from the rank that holds
    it)."""
    if tp is None or tp.size == 1:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        return -(ll * mask).sum()
    z = logits.float()
    top = C.all_reduce(z.detach().amax(-1).contiguous(), tp, "max")
    z = z - top[..., None]
    total = C.reduce_from_model(z.exp().sum(-1), tp)
    v = z.size(-1)
    local = labels - tp.index * v
    inside = (local >= 0) & (local < v)
    picked = torch.gather(z, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    picked = C.reduce_from_model(picked * inside.to(z.dtype), tp)
    ll = picked - total.log()
    return -(ll * mask).sum()


def make_train_step(cfg: ArchCfg, ocfg: opt.AdamWCfg, mesh, *,
                    microbatches: int = 1, grad_compression: str = "none",
                    backend=None, blocks_policy=None, accum_dtype=None,
                    axis_specs=None):
    """``train_step(state, batch) -> (state, metrics)`` on a rank of
    ``mesh``: ``state`` this rank's shard (:func:`init_state`), ``batch``
    the global batch (each rank takes its rows, a VLM's ``patch_embeds``
    and an encoder-decoder's ``src_embeds`` too).  Metrics: ``loss`` and ``ce_loss`` (the global mean), an MTP
    block's ``mtp_loss``, a MoE's ``load_balance_loss``, ``grad_norm``,
    ``lr``."""
    from repro_torch import interop
    from repro_torch.models.transformer import LB_WEIGHT, MTP_WEIGHT, \
        Z_WEIGHT
    layout = Layout(cfg, mesh)
    moe = cfg.block in ("moe", "mla_moe")
    encdec = cfg.block == "encdec"
    extra_key = "src_embeds" if encdec else "patch_embeds"
    groups = interop.stacked_leaves(cfg)
    work = {}     # the working model, built at the first step

    def build(device):
        model = model_class(cfg)(local_cfg(cfg, mesh), device="meta")
        wire(model, cfg, layout)
        model.to_empty(device=device)
        params = dict(model.named_parameters())
        for name, p in params.items():
            want = tuple(layout.model_part(
                name, torch.empty(layout.leaves[name].shape,
                                  device="meta")).shape)
            if tuple(p.shape) != want:
                raise AssertionError(f"{name}: working shape "
                                     f"{tuple(p.shape)} != {want}")
        fresh, gathers = set(), {}
        for mod_name, module in model.named_children():
            mods = ([(f"{mod_name}.{i}", b) for i, b in enumerate(module)]
                    if isinstance(module, torch.nn.ModuleList)
                    else [(mod_name, module)])
            for prefix, mod in mods:
                names = [f"{prefix}.{n}" for n, _ in mod.named_parameters()]
                gathers[prefix] = _gather_hook(prefix, names, params, layout,
                                               work, fresh, cfg)
                mod.register_forward_pre_hook(gathers[prefix])
        work.update(model=model, params=params, fresh=fresh, gathers=gathers)

    def forward_backward(tokens, labels, extra):
        """One (micro)batch's loss on this rank's rows (``extra``: their
        patch or frame embeddings, or None), backward; returns (this rank's
        parts of the global means: ``ce_loss``, an MTP block's
        ``mtp_loss``, and ``loss`` without a load-balance term; the
        load-balance loss or None)."""
        model = work["model"]
        tp = model.embed.tp
        with obs.span("train.forward"):
            if encdec:
                logits, aux = model.logits_and_aux(tokens, src_embeds=extra)
            else:
                logits, aux = model.logits_and_aux(
                    tokens, patch_embeds=extra, remat=cfg.remat)
            mask = (labels >= 0).float()
            labels = labels.clamp_min(0).long()
            count = C.all_reduce(mask.sum(), layout.dp)
            ce = xent_sum(logits, labels, mask, tp) / count.clamp_min(1.0)
            parts = {"ce_loss": ce}
            loss = ce
            if "mtp_logits" in aux:
                # The token two steps on from each position: its own count.
                count = C.all_reduce(mask[:, 1:].sum(), layout.dp)
                parts["mtp_loss"] = xent_sum(
                    aux["mtp_logits"][:, :-1], labels[:, 1:], mask[:, 1:],
                    tp) / count.clamp_min(1.0)
                loss = loss + MTP_WEIGHT * parts["mtp_loss"]
            lb = None
            if moe:
                # The load-balance loss is global on every data rank; its
                # reduction's identity backward counts it once.  The
                # z-loss is this rank's share of its global mean.
                loss = loss + Z_WEIGHT * aux["router_z_loss"]
                lb = aux["load_balance_loss"]
            parts["loss"] = loss
        (loss if lb is None else loss + LB_WEIGHT * lb).backward()
        return {k: v.detach() for k, v in parts.items()}, \
            None if lb is None else lb.detach()

    def train_step(state, batch):
        master = state["opt"]["master"]
        if not work:
            build(next(iter(master.values())).device)
        model, params = work["model"], work["params"]
        work["master"] = master
        work["fresh"].clear()
        # The table and an untied head are read as tensors, not called.
        for prefix in ("embed", "head"):
            if prefix in work["gathers"]:
                work["gathers"][prefix](None, None)
        tokens = torch.as_tensor(batch["tokens"])
        labels = torch.as_tensor(batch["labels"])
        extra = batch.get(extra_key)
        if extra is not None:
            extra = torch.as_tensor(extra)
        elif encdec:
            raise ValueError(f"{cfg.name}: the batch needs src_embeds")
        if len(tokens) % microbatches:
            raise ValueError(f"a batch of {len(tokens)} rows does not split "
                             f"into {microbatches} microbatches")
        size = len(tokens) // microbatches
        device = model.device
        acc = None
        with dispatch.use(backend=backend, blocks_policy=blocks_policy,
                          accum_dtype=accum_dtype, mesh=mesh,
                          axis_specs=axis_specs):
            for i in range(microbatches):
                mb = slice(i * size, (i + 1) * size)
                rows = layout.batch_rows(size, tokens.shape[1])
                for p in params.values():
                    p.grad = None
                parts, lb = forward_backward(
                    tokens[mb][rows].to(device), labels[mb][rows].to(device),
                    None if extra is None else extra[mb][rows].to(device))
                if microbatches > 1:
                    if acc is None:
                        acc = {n: p.grad.float() for n, p in params.items()}
                    else:
                        torch._foreach_add_(list(acc.values()),
                                            [params[n].grad.float()
                                             for n in acc])
            local = ({n: t / microbatches for n, t in acc.items()}
                     if acc is not None else
                     {n: p.grad for n, p in params.items()})
            grads = {n: layout.reduce_grad(n, g) for n, g in local.items()}
        if grad_compression != "none":
            grads = C.decompress_grads(*C.compress_grads(
                grads, kind=grad_compression, groups=groups,
                ax=layout.world), kind=grad_compression)
        # The last microbatch's metrics: the global means.
        sums = C.all_reduce(torch.stack(list(parts.values())), layout.dp)
        metrics = dict(zip(parts, sums))
        if lb is not None:
            metrics["loss"] = metrics["loss"] + LB_WEIGHT * lb
            metrics["load_balance_loss"] = lb
        lr_scale = warmup_cosine(state["opt"]["step"])
        new_opt, opt_metrics = opt.adamw_update(
            grads, state["opt"], ocfg, lr_scale,
            replicas=layout.replicas(), group=layout.world)
        return {"opt": new_opt}, {**metrics, **opt_metrics}

    return train_step


def wire(model, cfg: ArchCfg, layout: Layout) -> None:
    """``model`` (of ``local_cfg(cfg, ...)``, uninitialised) told the
    model axis of ``layout``'s mesh, each layer cut as the rules cut its
    leaves; a MoE layer told the data axes too."""
    tp = layout.model if layout.model.size > 1 else None
    kv_cut = kv_split(cfg, layout.model.size)
    model.embed.tp = tp
    if model.head is not None:
        model.head.tp = tp
    if cfg.block == "encdec":
        model.tp = tp
        layers = [("", b) for b in (*model.enc_blocks, *model.dec_blocks)]
    else:
        layers = [(f"blocks.{i}", b) for i, b in enumerate(model.blocks)]
        if model.mtp_block is not None:
            layers.append(("mtp_block", model.mtp_block))
        if model.vision_proj is not None and tp is not None:
            model.vision_proj.split(tp)
    for prefix, block in layers:
        wire_block(block, tp, kv_cut, layout, prefix)


def wire_block(block, tp, kv_cut: bool = False, layout: Layout | None = None,
               prefix: str = "") -> None:
    """One block told the model axis ``tp`` (None off one): its attention
    layers (``_wire_attn``; ``kv_cut``: the axis cuts within the KV
    heads), its recurrent mixer cut (``MLSTM.split``, ``SLSTM.split``,
    ``RGLRU.split``), its MLP on the local config's block of d_ff, and its
    MoE layer (``prefix``: the block's name in ``layout``) told the data
    axes and cut as the rules cut its expert stacks."""
    for name in ("attn", "self_attn", "cross_attn"):
        if hasattr(block, name):
            _wire_attn(getattr(block, name), tp, kv_cut)
    for name in ("mlstm", "slstm", "rglru"):
        if hasattr(block, name) and tp is not None:
            getattr(block, name).split(tp)
    if hasattr(block, "mlp"):
        block.mlp.tp = tp
    if hasattr(block, "moe"):
        _wire_moe(block.moe, f"{prefix}.moe", layout, tp)


def _wire_attn(attn, tp, kv_cut: bool = False) -> None:
    """An attention layer told the model axis: GQA's heads are the local
    config's already, with ``kv_cut`` its KV heads whole and a block of
    their columns kept (``Attention.split``); MLA also keeps its block of
    the low-rank projections' columns (``MLAttention.split``)."""
    from repro_torch.layers.attention import MLAttention
    if tp is not None and (kv_cut or isinstance(attn, MLAttention)):
        attn.split(tp)
    else:
        attn.tp = tp


def _wire_moe(moe, prefix: str, layout: Layout, tp) -> None:
    """A MoE layer told the data axes and, on a model axis, cut as the
    rules cut its expert stacks (E on the axis: expert parallelism; F:
    the few-experts fallback); its shared expert column / row parallel
    where the rules shard it."""
    moe.dp = layout.dp
    if tp is None:
        return
    dim = layout.leaves[f"{prefix}.w_gate"].model_dim
    moe.split(tp, experts=dim == 0)
    if moe.shared is not None and \
            layout.leaves[f"{prefix}.shared.w_up"].model_dim is not None:
        moe.shared.tp = tp


def _gather_hook(prefix, names, params, layout, work, fresh, cfg):
    """A forward pre-hook: the module's working parameters gathered from
    the master shards, once a step."""
    dtype = getattr(torch, cfg.dtype)

    def hook(module, args):
        if prefix in fresh:
            return
        fresh.add(prefix)
        with torch.no_grad():
            for name in names:
                shard = work["master"][name].to(dtype)
                params[name].copy_(layout.gather(name, shard))

    return hook

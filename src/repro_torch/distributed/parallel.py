"""Data x model parallel training of the dense family on a mesh of the
running world: what the reference gets from GSPMD, done by hand.

Each rank holds the shards that ``sharding.rules.param_shardings`` gives
its coordinate: the fp32 master copy and AdamW's moments split over the
data axes (ZeRO-3: a column-parallel weight's in dim, a row-parallel
weight's out dim, the table's embed dim, where they divide) and over the
model axis (tensor parallelism).  The working model is the dense
``Transformer`` of the rank's part of the model axis (``local_cfg``: its
heads, ``d_ff`` and vocab rows), its layers told the model axis
(``tp``, a ``collectives.AxisGroup``):

  * column-parallel ``wq``, ``wk``, ``wv``, ``w_gate`` and ``w_up`` run on
    the rank's heads and ``d_ff`` columns; their input's gradient is
    summed over the axis (``collectives.copy_to_model``);
  * row-parallel ``wo`` and ``w_down`` sum their partial outputs
    (``collectives.reduce_from_model``);
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

Other families on a mesh of more than one rank, sequence parallelism (a
batch the data axes do not divide), a VLM's patch projection, microbatches
and gradient compression on such a mesh raise ``NotImplementedError``
(ROADMAP queue 1, item 6).  A one-rank mesh runs the same code with every
collective a no-op, and matches the meshless step.
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

QUEUE = "ROADMAP.md queue 1, item 6 (Distributed)"


def check_supported(cfg: ArchCfg, mesh) -> None:
    """Raises where this executor cannot run ``cfg`` on ``mesh``: another
    family on more than one rank, or a model axis that would cut a head,
    ``d_ff`` or the vocab unevenly (it never replicates them silently)."""
    if mesh.size == 1:
        return
    if cfg.block != "dense" or cfg.mla or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: block={cfg.block!r}"
            f"{' with a patch projection' if cfg.n_patches else ''} on a "
            f"mesh of {mesh.size} ranks is not ported yet ({QUEUE}); the "
            f"dense family is")
    m = model_size(mesh)
    for what, n in (("q heads", cfg.n_heads), ("kv heads", cfg.n_kv_heads),
                    ("d_ff", cfg.d_ff), ("vocab", cfg.vocab)):
        if n % m:
            raise ValueError(
                f"{cfg.name}: {n} {what} do not split over a {m}-way model "
                f"axis; the executor shards heads whole and never "
                f"replicates a weight the rules would shard")


def local_cfg(cfg: ArchCfg, mesh) -> ArchCfg:
    """The dense config of one rank's part of the model axis."""
    m = model_size(mesh)
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
        d_ff=cfg.d_ff // m, vocab=cfg.vocab // m, head_dim=cfg.dh)


def _axis(mesh, axes, name) -> C.AxisGroup:
    size = math.prod(mesh.shape[a] for a in axes) if axes else 1
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
    rank sees them (``dp``, ``model``, ``world``)."""

    def __init__(self, cfg: ArchCfg, mesh):
        from repro_torch.models.transformer import Transformer
        check_supported(cfg, mesh)
        self.cfg, self.mesh = cfg, mesh
        dp = dp_axes(mesh)
        # Every rank makes the groups in this order (a collective call).
        self.dp = _axis(mesh, dp, "data")
        self.model = _axis(mesh, ("model",) if "model" in mesh.axis_names
                           else (), "model")
        self.world = _axis(mesh, mesh.axis_names, "world")
        shapes = {n: tuple(p.shape) for n, p in
                  Transformer(cfg, device="meta").named_parameters()}
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
                    raise NotImplementedError(
                        f"{name}: spec {spec} shards one dim over the model "
                        f"and data axes ({QUEUE})")
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
                f"not ported yet ({QUEUE})")
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
    the global batch (each rank takes its rows).  Metrics: ``loss`` and
    ``ce_loss`` (the global mean), ``grad_norm``, ``lr``."""
    if microbatches > 1 and mesh.size > 1:
        raise NotImplementedError(
            f"microbatches on a mesh of {mesh.size} ranks are not ported "
            f"yet ({QUEUE})")
    if grad_compression != "none" and mesh.size > 1:
        raise NotImplementedError(
            f"grad_compression={grad_compression!r} on a mesh of "
            f"{mesh.size} ranks is not ported yet ({QUEUE})")
    layout = Layout(cfg, mesh)
    work = {}     # the working model, built at the first step

    def build(device):
        from repro_torch.models.transformer import Transformer
        model = Transformer(local_cfg(cfg, mesh), device=device)
        tp = layout.model if layout.model.size > 1 else None
        model.embed.tp = tp
        if model.head is not None:
            model.head.tp = tp
        for block in model.blocks:
            block.attn.tp = tp
            block.mlp.tp = tp
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
        for p in params.values():
            p.grad = None
        tokens = torch.as_tensor(batch["tokens"])
        rows = layout.batch_rows(*tokens.shape[:2])
        device = model.device
        tokens = tokens[rows].to(device)
        labels = torch.as_tensor(batch["labels"])[rows].to(device)
        with dispatch.use(backend=backend, blocks_policy=blocks_policy,
                          accum_dtype=accum_dtype, mesh=mesh,
                          axis_specs=axis_specs):
            with obs.span("train.forward"):
                logits = model.logits_and_aux(tokens, remat=cfg.remat)[0]
                mask = (labels >= 0).float()
                count = C.all_reduce(mask.sum(), layout.dp)
                loss = xent_sum(logits, labels.clamp_min(0).long(), mask,
                                model.embed.tp) / count.clamp_min(1.0)
            loss.backward()
            grads = {n: layout.reduce_grad(n, p.grad)
                     for n, p in params.items()}
        loss = C.all_reduce(loss.detach().clone(), layout.dp)
        lr_scale = warmup_cosine(state["opt"]["step"])
        new_opt, opt_metrics = opt.adamw_update(
            grads, state["opt"], ocfg, lr_scale,
            replicas=layout.replicas(), group=layout.world)
        return {"opt": new_opt}, {"ce_loss": loss, "loss": loss,
                                  **opt_metrics}

    return train_step


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

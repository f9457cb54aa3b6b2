"""Mixture-of-Experts layer: top-k routing and capacity-based dispatch.

The port of ``repro/layers/moe.py``.  The experts' FFNs are three batched
GEMMs over the expert axis (``batched_matmul``, silu fused into the gate's
epilogue): the paper's "loops around the sole kernel".  Dispatch is
GShard's: each routing group gives every expert ``capacity`` slots, a
token's k choices take the next free slot of their expert in token-major
then k order, and a choice past the capacity is dropped (its weight is 0);
the combine gathers each choice's expert output back and sums the k of a
token weighted by its renormalised gates.  The aux outputs are the
load-balance loss, the router z-loss and the dropped fraction.

Groups, as the reference's: one a batch row at prefill and in training
(t > 1), one global group of all B tokens at decode (t == 1), and, where
``row_groups`` is set, one a row at decode too.  The reference's slot and
paged decodes ``vmap`` a batch-1 decode over the slots, so every slot
routes as a group of its own (capacity 4, no drops, a free slot's garbage
token competing with no one); the port's one batched decode over the
slots passes ``row_groups=True`` for that.

The reference runs the expert GEMMs per group (``vmap`` of
``batched_matmul``; its XLA branch is one ``einsum("gecd,edf->gecf")``);
here the groups are folded into the rows: the dispatch buffer is (E, G *
cap, D), so each GEMM is one launch that reads every expert's weights
once, whatever the number of groups.  The buffer holds one more row, the
discard slot of every dropped choice, sliced off before the GEMMs.

Under a quant tier (an ambient ``use(quant=...)`` or calibrated weights,
per-expert per-column scales (E, F)) the router, the shared expert and
the three expert GEMMs run quantized, the experts on
``batched_matmul_q``, as on the reference's kernel path; its XLA branch
computes the experts in full precision whatever the tier, and the port
does not follow it there.  Per-row activation scales are the same over
the folded rows as over one call a group; per-tensor ones are taken a
group (``a_groups``), as the reference's calls take them.

Top-k is a stable descending sort: equal probabilities keep the lower
expert first, as ``jax.lax.top_k`` does.  No ``shard_map`` and no
sharding constraints: under an abstract mesh the kernels' plans are
chosen for the shard (``dispatch.resolve_blocks``).

On a mesh of the running world (``distributed/parallel.py``) the layer is
told its axes.  ``dp`` (the data axes): a rank's batch rows are its
routing groups, so routing and capacity are the reference's
(``_shmap_over_dp``) with no collective; the aux losses are the
reference's global means: ``me``'s and ``ce``'s sums and the kept count
are summed over the data axes (forward all-reduce, identity backward, so
each rank's probabilities get their gradient once), and the z-loss is
this rank's share of the global mean (its sum over the global token
count; the ranks' shares add up to it).  ``tp`` (the model axis) with
:meth:`MoE.split`: a rank holds E/m whole experts (expert parallelism,
the reference's rule) or, where E does not divide, every expert's F/m
columns (its few-experts fallback), and routes over all E.  The experts'
input and the gates enter through ``copy_to_model`` (their gradients,
partial on each rank, are summed over the axis before they reach x and
the router, which the axis replicates); the router reads x before that
copy; the partial outputs are summed with ``reduce_from_model``.  Expert
parallelism keys its batched GEMMs with the axes ``(dp, None, None)``
(the model axis splits the entries, outside the triple), the fallback's
down projection as a row-parallel one, and a shared expert the rules
keep whole (DeepSeek-V3's, whose stack's layer dim the reference's rule
takes for experts) with ``(dp, None, None)`` too.  A routing group across data
ranks (decode's one global group, ``grouped=False``) and the engines on
such a mesh are not ported (ROADMAP queue 1, item 6.4).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core import brgemm
from repro_torch.distributed.collectives import (
    DP_ROWS, ROW_PARALLEL, axis_scope, copy_to_model, reduce_from_model)
from repro_torch.layers.mlp import MLP


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int                 # per-expert hidden size
    n_experts: int
    top_k: int
    n_shared: int = 0         # DeepSeek-style always-on shared experts
    capacity_factor: float = 1.25
    activation: str = "silu"
    renormalize: bool = True
    grouped: bool = True      # one routing group a batch row when t > 1


def capacity(cfg: MoECfg, n_tokens: int) -> int:
    """Slots an expert has in a group of ``n_tokens``: the capacity factor's
    share, at least 8, rounded up to 4s, and at most the group's tokens
    (rounded up to 4s): an expert takes a token once at most."""
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    c = max(8, ((c + 3) // 4) * 4)
    return min(c, ((n_tokens + 3) // 4) * 4)


def groups(cfg: MoECfg, b: int, t: int, row_groups: bool = False):
    """(G, N): routing groups and tokens a group for a (b, t) input."""
    if (cfg.grouped and t > 1) or row_groups:
        return b, t
    return 1, b * t


def route(router, xg, cfg: MoECfg, cap: int, *, backend=None):
    """The routing of xg (G, N, D): (logits, probs) fp32 (G, N, E); the
    gates (G, N, k) and expert ids (G, N * k) of each token's top k; which
    choices fit their expert's capacity (``keep``, (G, N * k)); and each
    choice's slot there (``cap`` where dropped)."""
    g, n, _ = xg.shape
    k = cfg.top_k
    logits = brgemm.matmul(xg, router, out_dtype=torch.float32,
                           backend=backend)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, ids = gate_vals[..., :k], ids[..., :k]
    if cfg.renormalize:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    flat_ids = ids.reshape(g, n * k)
    onehot = nn.functional.one_hot(flat_ids, cfg.n_experts)
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    keep = pos < cap
    return logits, probs, gate_vals, flat_ids, keep, torch.where(keep, pos,
                                                                 cap)


class MoE(nn.Module):
    """``router`` (D, E); ``w_gate``, ``w_up`` (E, D, F); ``w_down`` (E, F,
    D); ``shared``, a gated MLP of F * n_shared, where ``n_shared``.  On a
    mesh's model axis (:meth:`split`) the expert stacks hold this rank's
    part."""
    tp = None        # the model axis the experts are split over, else None
    dp = None        # the data axes (collectives.AxisGroup), else None
    experts = None   # (first, end): this rank's experts under EP

    def __init__(self, cfg: MoECfg, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

        def w(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))

        self.router = w(d, e)
        self.w_gate, self.w_up, self.w_down = w(e, d, f), w(e, d, f), \
            w(e, f, d)
        self.shared = (MLP(d, f * cfg.n_shared, activation=cfg.activation,
                           dtype=dtype, device=device)
                       if cfg.n_shared else None)

    def split(self, tp, *, experts: bool) -> None:
        """Keep this rank's part of the expert stacks on the model axis
        ``tp`` (new, uninitialised parameters of the part's shape):
        ``experts`` E/m whole experts, else every expert's F/m columns
        (``w_gate`` and ``w_up`` column-, ``w_down`` row-parallel)."""
        e, d, f = self.cfg.n_experts, self.cfg.d_model, self.cfg.d_ff
        m, r = tp.size, tp.index
        if experts:
            n = e // m
            self.experts = (r * n, (r + 1) * n)
            gate, down = (n, d, f), (n, f, d)
        else:
            gate, down = (e, d, f // m), (e, f // m, d)
        like = self.w_gate
        for name, shape in (("w_gate", gate), ("w_up", gate),
                            ("w_down", down)):
            setattr(self, name, nn.Parameter(torch.empty(
                shape, dtype=like.dtype, device=like.device)))
        self.tp = tp

    def forward(self, x, *, row_groups: bool = False,
                backend: str | None = None):
        """x: (B, T, D) -> (y (B, T, D), aux).  ``row_groups``: one routing
        group a row also at decode (a slot pool's)."""
        cfg = self.cfg
        b, t, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        g, n = groups(cfg, b, t, row_groups)
        dp = self.dp if self.dp is not None and self.dp.size > 1 else None
        if dp is not None and not ((cfg.grouped and t > 1) or row_groups):
            raise NotImplementedError(
                "one routing group across the data ranks (decode, or "
                "grouped=False) is not ported (ROADMAP queue 1, item 6.4)")
        xg = x.reshape(g, n, d)
        cap = capacity(cfg, n)
        tp = self.tp
        with axis_scope("matmul", DP_ROWS, tp):
            logits, probs, gate_vals, flat_ids, keep, pos = route(
                self.router, xg, cfg, cap, backend=backend)
        # The experts' input and the gates: their gradients are partial on
        # each rank of the model axis (its experts or its F columns).
        xe = copy_to_model(xg, tp)
        gate_vals = copy_to_model(gate_vals, tp)
        lo, hi = self.experts or (0, e)

        # Dispatch: choice (g, i) lands in row (expert, group, slot) of the
        # folded buffer (the rank's experts), a dropped one (or one of
        # another rank's expert) in the discard row at the end.
        rows = (hi - lo) * g * cap
        groups_of = torch.arange(g, device=x.device)[:, None]
        mine = keep & (flat_ids >= lo) & (flat_ids < hi) if self.experts \
            else keep
        slot = torch.where(mine, ((flat_ids - lo) * g + groups_of) * cap
                           + pos, rows)
        buf = x.new_zeros(rows + 1, d)
        buf[slot.reshape(-1)] = xe.repeat_interleave(k, dim=1).reshape(-1, d)
        expert_in = buf[:rows].view(hi - lo, g * cap, d)

        ep = self.experts is not None
        with axis_scope("batched_matmul", DP_ROWS if ep else None,
                        tp):
            gt = brgemm.batched_matmul(expert_in, self.w_gate,
                                       activation=cfg.activation,
                                       backend=backend, a_groups=g)
            u = brgemm.batched_matmul(expert_in, self.w_up, backend=backend,
                                      a_groups=g)
        with axis_scope("batched_matmul",
                        DP_ROWS if ep else ROW_PARALLEL, tp):
            out = brgemm.batched_matmul(gt * u, self.w_down, backend=backend,
                                        a_groups=g)

        # Combine: the discard row reads zeros, as the reference's padded
        # slot does, and its weight is 0.
        out = torch.cat([out.reshape(rows, d), out.new_zeros(1, d)])
        y_tok = out[slot]                                  # (G, N*k, D)
        w = (gate_vals.reshape(g, n * k) * keep).to(x.dtype)
        y = (y_tok * w[..., None]).reshape(g, n, k, d).sum(dim=2)
        y = reduce_from_model(y, tp)
        if self.shared is not None:
            # A shared expert the rules keep whole on the model axis (its
            # stack's layer dim took the axis) runs whole on every rank.
            with axis_scope("matmul", None if self.shared.tp else DP_ROWS,
                            tp):
                y = y + self.shared(xg, backend=backend)
        return y.reshape(b, t, d), _aux(logits, probs, flat_ids, keep, k,
                                        dp)


def _aux(logits, probs, flat_ids, keep, k, dp=None):
    """GShard's load-balance loss, the router z-loss and the dropped
    fraction: the reference's means over every token and choice of the
    layer's groups, on every data rank of ``dp`` (one all-reduce of
    ``me``'s and ``ce``'s sums and the kept count, whose backward is the
    identity, so each rank's probabilities get the gradient once); the
    z-loss there is this rank's share of its global mean."""
    e = probs.shape[-1]
    tokens = probs.numel() // e * (dp.size if dp is not None else 1)
    sums = reduce_from_model(torch.cat([
        probs.reshape(-1, e).sum(dim=0),
        torch.bincount(flat_ids.reshape(-1), minlength=e).float(),
        keep.float().sum().reshape(1)]), dp)
    me, ce = sums[:e] / tokens, sums[e:2 * e] / (tokens * k)
    return {"load_balance_loss": e * torch.sum(me * ce),
            "router_z_loss": (torch.logsumexp(logits, dim=-1) ** 2).sum()
            / tokens,
            "dropped_fraction": 1.0 - sums[-1].detach() / (tokens * k)}

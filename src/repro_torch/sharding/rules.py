"""Logical-axis -> mesh-axis sharding rules: the port of
``repro/sharding/rules.py``, its rules unchanged.

Parameter rules (FSDP x TP):
  * column-parallel weights (qkv/up/gate projections): last-2 dims ->
    (fsdp, model): the out dim (heads / mlp hidden) shards on the tensor-
    parallel axis, the in dim (embed) shards ZeRO-3-style on the DP axes,
  * row-parallel weights (wo / w_down / w_out): (model, fsdp),
  * embedding table (vocab, embed) -> (model, fsdp); LM head -> (fsdp, model),
  * MoE expert stacks (E, D, F) -> expert dim on the model axis (EP),
  * any extra leading dims (layer stacks / groups) are unsharded,
  * every assignment checks divisibility and falls back to replication.

Activation/cache rules are shape-kind based; when the global batch cannot
cover the DP axes (long_500k: batch=1) the sequence dim takes the DP axes
instead (sequence parallelism).

A spec is a :class:`P`, a tuple of per-dim entries (``None``, an axis
name, or a tuple of names, major to minor), equal to the reference's
``tuple(PartitionSpec(...))``.  A path is a dotted or slashed string, a
sequence of keys, or the reference's key objects.  The port's parameters
carry no layer-stack dim: :func:`port_param_spec` reaches the rules under
the reference's leaf name (``interop.stacked_leaves``) and drops the
stack's leading ``None``.  :func:`to_placements` gives a spec's
``torch.distributed.tensor`` placements and :func:`local_slices` the
slices of a tensor that one rank of a mesh holds (``NamedSharding``'s).
"""
from __future__ import annotations

from repro_torch.launch.mesh import dp_axes
from repro_torch.sharding.local import shard_count


def _entry(e):
    """An entry as ``PartitionSpec`` keeps it: a one-name tuple is the
    name, an empty one None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one entry per leading dim, missing trailing
    entries replicate (entries normalised as ``PartitionSpec``'s)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# leaf names -> column-parallel (in, out) = (fsdp, model)
_COL = {
    "wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wkv_b", "w_up", "w_gate",
    "w_gelu", "w_rnn_in", "w_rgate", "w_igate", "wi", "wf", "w", "w1", "w2",
    "wo_gate",
}
# leaf names -> row-parallel (in, out) = (model, fsdp)
_ROW = {"wo", "w_down", "w_out"}
_MOE_LEAVES = {"w_gate", "w_up", "w_down"}


def _div(n: int, axes, mesh) -> bool:
    """Dim shards over ``axes`` iff it divides; else replicate (never
    raise).  The same fallback ``sharding.local`` applies when computing
    per-device problem shapes, so dispatch always tunes for the local
    shape the executor actually runs."""
    return shard_count(n, axes, mesh) > 1


def _lead(ndim: int, trailing: tuple) -> P:
    return P(*((None,) * (ndim - len(trailing)) + trailing))


def _path_keys(path) -> list[str]:
    if isinstance(path, str):
        return [k for k in path.replace("/", ".").split(".") if k]
    keys = []
    for p in path:
        if hasattr(p, "key"):
            keys.append(str(p.key))
        elif hasattr(p, "idx"):
            keys.append(f"#{p.idx}")
        else:
            keys.append(str(p))
    return keys


def param_spec(path, shape, mesh, fsdp_enabled: bool = True,
               tp_enabled: bool = True) -> P:
    if len(shape) == 0:
        return P()
    keys = _path_keys(path)
    leaf = keys[-1] if keys else ""
    fsdp = dp_axes(mesh) if fsdp_enabled else ()
    model = "model" if tp_enabled and "model" in mesh.axis_names else None
    fs = fsdp if _div(shape[-2] if len(shape) >= 2 else 0, fsdp, mesh) \
        else None
    mdl_last = model if model and _div(shape[-1], model, mesh) else None

    in_moe = any(k == "moe" for k in keys)
    if in_moe and leaf in _MOE_LEAVES and len(shape) >= 3:
        if model and _div(shape[-3], model, mesh):
            # EP: expert dim on the model axis, D ZeRO-sharded on fsdp
            e_axis = model
            if leaf == "w_down":   # (E, F, D)
                d_fs = fsdp if _div(shape[-1], fsdp, mesh) else None
                return _lead(len(shape), (e_axis, None, d_fs))
            d_fs = fsdp if _div(shape[-2], fsdp, mesh) else None
            return _lead(len(shape), (e_axis, d_fs, None))
        # few-experts fallback (E % model != 0): TP the per-expert FFN dim
        if leaf == "w_down":       # (E, F, D)
            f_m = model if model and _div(shape[-2], model, mesh) else None
            d_fs = fsdp if _div(shape[-1], fsdp, mesh) else None
            return _lead(len(shape), (None, f_m, d_fs))
        d_fs = fsdp if _div(shape[-2], fsdp, mesh) else None
        f_m = model if model and _div(shape[-1], model, mesh) else None
        return _lead(len(shape), (None, d_fs, f_m))

    if leaf == "router" and len(shape) >= 2:
        return _lead(len(shape), (fs, None))

    if leaf == "table" and len(shape) >= 2:
        v_m = model if model and _div(shape[-2], model, mesh) else None
        e_fs = fsdp if _div(shape[-1], fsdp, mesh) else None
        return _lead(len(shape), (v_m, e_fs))

    if len(shape) >= 2 and leaf in _ROW:
        m_in = model if model and _div(shape[-2], model, mesh) else None
        o_fs = fsdp if _div(shape[-1], fsdp, mesh) else None
        return _lead(len(shape), (m_in, o_fs))

    if len(shape) >= 2 and (leaf in _COL or leaf == "r"):
        return _lead(len(shape), (fs, mdl_last))

    # 1-D leaves (biases, norm scales, lam): replicate
    return P()


def port_param_spec(name: str, shape, cfg, mesh, *, fsdp: bool = True,
                    tp: bool = True) -> P:
    """The spec of the port's parameter ``name`` (``blocks.3.attn.wq``):
    the reference's spec of its stacked leaf (``blocks.attn.wq``, its
    leading stack dims, ``interop.stack_dims``) with those dims dropped;
    an unstacked parameter's own.  Where the reference shards a stack dim
    (its MoE rule takes a shared expert's (L, D, F) stack for experts) the
    layer the port holds is whole along that axis."""
    from repro_torch import interop
    stacked = interop.stacked_leaves(cfg).get(name)
    if stacked is None:
        return param_spec(name, tuple(shape), mesh, fsdp, tp)
    lead = interop.stack_dims(cfg)[name]
    spec = param_spec(stacked, lead + tuple(shape), mesh, fsdp, tp)
    return P(*spec[len(lead):])


def param_shardings(named_shapes, mesh, cfg, *, fsdp: bool = True,
                    tp: bool = True) -> dict[str, P]:
    """``{name: spec}`` of the port's parameters (or any tree keyed by
    them: the optimizer's ``m``, ``v`` and ``master``), from ``{name:
    tensor or shape}``.  ``fsdp=False`` replicates over the dp axes
    (ZeRO-0), ``tp=False`` over the model axis."""
    return {name: port_param_spec(name, tuple(getattr(x, "shape", x)), cfg,
                                  mesh, fsdp=fsdp, tp=tp)
            for name, x in named_shapes.items()}


# --------------------------------------------------------------------------
# placements and a rank's slices
# --------------------------------------------------------------------------

def _entry_axes(entry, mesh) -> tuple[str, ...]:
    axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
    return tuple(a for a in axes if a is not None and a in mesh.axis_names)


def to_placements(spec, mesh) -> tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` on
    ``mesh``, one a mesh dim: ``Shard(d)`` where the dim's entry names
    the axis, else ``Replicate()``.  An entry of several axes must list
    them in the mesh's order (major to minor), as DTensor shards a dim
    over several mesh dims; an axis named twice raises."""
    from torch.distributed.tensor import Replicate, Shard
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry, mesh)
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {mesh.axis_names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {spec}: axis {a!r} shards dims "
                                 f"{owner[a]} and {d}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.axis_names)


def local_slices(shape, spec, mesh, coords=None) -> tuple[slice, ...]:
    """The slices of a ``shape`` tensor that the rank at ``coords``
    (default: this rank's, ``mesh.coords``) holds under ``spec``: along a
    dim sharded ``n`` ways (``shard_count``; one that does not divide
    stays whole) the rank's index over the entry's axes, major to minor,
    picks the n-th part."""
    coords = mesh.coords if coords is None else coords
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, entry in zip(shape, spec):
        n = shard_count(int(dim), entry, mesh)
        if n == 1:
            out.append(slice(None))
            continue
        idx = 0
        for a in _entry_axes(entry, mesh):
            idx = idx * mesh.shape[a] + coords[a]
        part = int(dim) // n
        out.append(slice(idx * part, (idx + 1) * part))
    return tuple(out)


# --------------------------------------------------------------------------
# batch / cache / activation rules
# --------------------------------------------------------------------------

def batch_spec(shape, mesh) -> P:
    """tokens/labels (B, S) or embeds (B, T, D)."""
    fsdp = dp_axes(mesh)
    if _div(shape[0], fsdp, mesh):
        return _lead(len(shape), ()) if len(shape) == 0 else P(
            fsdp, *([None] * (len(shape) - 1)))
    # sequence parallelism fallback (long-context, tiny batch)
    if len(shape) >= 2 and _div(shape[1], fsdp, mesh):
        return P(None, fsdp, *([None] * (len(shape) - 2)))
    return P(*([None] * len(shape)))


def cache_spec(path, shape, mesh) -> P:
    keys = _path_keys(path)
    leaf = keys[-1] if keys else ""
    fsdp = dp_axes(mesh)
    model = "model" if "model" in mesh.axis_names else None

    def bspec(b_dim_idx, rest: list):
        b = fsdp if _div(shape[b_dim_idx], fsdp, mesh) else None
        return _lead(len(shape), tuple([b] + rest))

    if leaf in ("k", "v") and len(shape) >= 4:
        h, s = shape[-3], shape[-2]
        if model and _div(h, model, mesh):
            return bspec(len(shape) - 4, [model, None, None])
        if model and _div(s, model, mesh):
            return bspec(len(shape) - 4, [None, model, None])
        return bspec(len(shape) - 4, [None, None, None])
    if leaf in ("c_kv", "k_rope") and len(shape) >= 3:
        s = shape[-2]
        s_ax = model if model and _div(s, model, mesh) else None
        return bspec(len(shape) - 3, [s_ax, None])
    if any(k == "mlstm" for k in keys) and len(shape) >= 4:
        # (.., B, H, dk, dv): shard dk on model when possible
        dk_ax = model if model and _div(shape[-2], model, mesh) else None
        return bspec(len(shape) - 4, [None, dk_ax, None])
    if leaf in ("h", "conv") or (len(shape) >= 2 and leaf in ("c", "n", "m")):
        d_ax = model if model and _div(shape[-1], model, mesh) else None
        return bspec(len(shape) - 2 if len(shape) >= 2 else 0,
                     [d_ax] if len(shape) >= 2 else [])
    # fallback: try batch on the first trailing-structure dim
    return P(*([None] * len(shape)))


def activation_rules(mesh):
    """Callable for ``sharding.annotate.use_rules``."""
    fsdp = dp_axes(mesh)
    model = "model" if "model" in mesh.axis_names else None

    def rules(x, kind: str):
        if x.ndim < 2:
            return None
        if kind == "moe_dispatch" and x.ndim == 4:
            # (G, E, cap, D): groups on DP, experts on model when divisible
            g_ax = fsdp if _div(x.shape[0], fsdp, mesh) else None
            e_ax = model if model and _div(x.shape[1], model, mesh) else None
            return P(g_ax, e_ax, None, None)
        b, s = x.shape[0], x.shape[1]
        if _div(b, fsdp, mesh):
            lead = (fsdp, None)
        elif _div(s, fsdp, mesh):
            lead = (None, fsdp)
        else:
            lead = (None, None)
        if kind == "logits" and model and _div(x.shape[-1], model, mesh):
            return P(*lead, *([None] * (x.ndim - 3)), model)
        return P(*lead, *([None] * (x.ndim - 2)))

    return rules

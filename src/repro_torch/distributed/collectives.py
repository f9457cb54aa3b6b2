"""Collectives over one mesh axis, and gradient compression with error
feedback: the port of ``repro/distributed/collectives.py``.

The executor of a mesh (``distributed/parallel.py``) moves tensors with
three collectives over an ``AxisGroup`` (a mesh axis's process group,
its size and this rank's index on it): :func:`all_reduce` (sum or max,
in place), :func:`all_gather` and :func:`reduce_scatter` along a dim.
Each counts its calls and the bytes of its payload by kind in ``COUNTS``
(``launch/train.py``'s record reads them; :func:`reset_counts` zeroes
them); a group of one rank moves nothing and counts nothing.  Under NCCL the gather and the scatter are
NCCL's own; otherwise (gloo, whose CUDA tensors take only broadcast and
all-reduce) :func:`gather_by_all_reduce` and the scatter's reduce-then-
slice build them from an all-reduce, on the CPU and on the card alike.
:func:`copy_to_model` (identity forward, all-reduce of the gradient),
:func:`reduce_from_model` (all-reduce forward, identity backward) and
:func:`gather_from_model` (all-gather forward, the rank's slice of the
gradient backward) are the tensor-parallel layers' autograd seams.

Compressing the fp32 gradients to int8 (one absmax scale a tensor) or to
bf16 before the optimizer models the wire format of a compressed
all-reduce.  Error feedback keeps convergence: the residual of one step's
compression is added to the next step's gradients, carried by the caller.
The functions are plain ones over ``{name: tensor}`` gradients, the
reference's arithmetic bit for bit: ``scale = max(absmax, 1e-30) / 127``,
``q = clip(round(g / scale), -127, 127)`` (round half to even), and
``q * scale`` back in fp32.  The reference takes one scale a leaf of its
tree, and its leaves stack the layers: ``groups`` ({name: group}) gives
the gradients that share one scale, the absmax over all of them
(``interop.stacked_leaves`` names the reference's stacks); a name it
does not list is a group of its own.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch

KINDS = ("bf16", "int8")
COUNTS: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis (or tuple of axes) seen from a rank: its process
    ``group``, its ``size`` and this rank's ``index`` on it."""
    name: str
    group: Any
    size: int
    index: int


def reset_counts() -> None:
    COUNTS.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    COUNTS[f"{kind}_bytes"] += t.numel() * t.element_size()
    COUNTS[f"{kind}_calls"] += 1


def _nccl(ax: AxisGroup) -> bool:
    import torch.distributed as dist
    return dist.get_backend(ax.group) == "nccl"


def all_reduce(t: torch.Tensor, ax: AxisGroup | None, op: str = "sum"):
    """``t`` reduced (``sum`` or ``max``) over ``ax``'s ranks, in place;
    returns ``t``."""
    if ax is None or ax.size == 1:
        return t
    import torch.distributed as dist
    _count("all_reduce", t)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=ax.group)
    return t


def gather_by_all_reduce(t: torch.Tensor, ax: AxisGroup, dim: int):
    """The all-gather of ``t`` along ``dim`` as a sum: each rank writes
    its part into zeros at its index, and the ranks all-reduce.  Exact
    (every element is one rank's value plus zeros)."""
    import torch.distributed as dist
    n = t.size(dim)
    shape = list(t.shape)
    shape[dim] = n * ax.size
    out = t.new_zeros(shape)
    out.narrow(dim, ax.index * n, n).copy_(t)
    dist.all_reduce(out, group=ax.group)
    return out


def all_gather(t: torch.Tensor, ax: AxisGroup | None, dim: int):
    """The ranks' ``t`` concatenated along ``dim`` in index order."""
    if ax is None or ax.size == 1:
        return t
    import torch.distributed as dist
    if _nccl(ax):
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.size(0) * ax.size,) + src.shape[1:])
        dist.all_gather_into_tensor(out, src, group=ax.group)
        out = out.movedim(0, dim)
    else:
        out = gather_by_all_reduce(t, ax, dim)
    _count("all_gather", out)
    return out


def reduce_scatter(t: torch.Tensor, ax: AxisGroup | None, dim: int):
    """The sum of the ranks' ``t``, each rank keeping its part along
    ``dim`` (index order); ``t`` is not modified."""
    if ax is None or ax.size == 1:
        return t
    import torch.distributed as dist
    _count("reduce_scatter", t)
    n = t.size(dim) // ax.size
    if _nccl(ax):
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((n,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, group=ax.group)
        return out.movedim(0, dim)
    full = t.contiguous().clone()
    dist.all_reduce(full, group=ax.group)
    return full.narrow(dim, ax.index * n, n).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.ax), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x.contiguous().clone(), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.n = ax, dim, x.size(dim)
        return all_gather(x.contiguous(), ax, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n), None, None


# A row-parallel GEMM's triple: rows on the data axes, k on the model axis
# (``sharding.local.local_problem``'s override, as the reference's
# ``launch/dryrun.py::cell_problems`` assigns attn_out and mlp_down).
ROW_PARALLEL = (("pod", "data"), None, "model")
# Rows on the data axes, n and k whole on the rank: a GEMM whose weight
# the model axis replicates (the MoE router), or splits outside the
# triple (the expert entries of a batched GEMM under expert parallelism).
DP_ROWS = (("pod", "data"), None, None)


def axis_scope(op: str, axes, ax: AxisGroup | None):
    """The dispatch scope of a call of ``op`` whose shard a model axis
    ``ax`` cuts along ``axes`` (a triple of ``sharding.local``): the op's
    axis spec is ``axes`` (an outer entry's backend pin kept), so that its
    ``resolve_blocks`` event names them; a null context off a model axis
    or for ``axes`` None (the default rule)."""
    import contextlib
    if ax is None or ax.size == 1 or axes is None:
        return contextlib.nullcontext()
    from repro_torch.core import dispatch
    specs = dict(dispatch.current_axis_specs() or {})
    pin = dispatch._axis_spec_backend(specs.get(op))
    specs[op] = {"axes": axes, "backend": pin} if pin else axes
    return dispatch.use(axis_specs=specs)


def row_parallel(ax: AxisGroup | None):
    """The dispatch scope of a row-parallel ``matmul`` on a model axis
    ``ax`` (:func:`axis_scope` with ``ROW_PARALLEL``)."""
    return axis_scope("matmul", ROW_PARALLEL, ax)


def copy_to_model(x: torch.Tensor, ax: AxisGroup | None):
    """``x`` entering column-parallel GEMMs: the same forward, its
    gradient summed over the model axis (each rank's is partial)."""
    if ax is None or ax.size == 1:
        return x
    return _CopyToModel.apply(x, ax)


def reduce_from_model(x: torch.Tensor, ax: AxisGroup | None):
    """The partial sums of a row-parallel GEMM (or a vocab-parallel
    lookup) summed over the model axis; the gradient passes as it is."""
    if ax is None or ax.size == 1:
        return x
    return _ReduceFromModel.apply(x, ax)


def gather_from_model(x: torch.Tensor, ax: AxisGroup | None, dim: int):
    """The ranks' parts of a column-parallel GEMM's output concatenated
    along ``dim`` (GSPMD's all-gather before a whole-width op); the
    backward keeps this rank's slice of the gradient.  Where the whole
    tensor feeds GEMMs split by rank, its gradient is partial on each:
    pass it through :func:`copy_to_model` after this gather, and the two
    backwards make the reduce-scatter."""
    if ax is None or ax.size == 1:
        return x
    return _GatherFromModel.apply(x, ax, dim)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"gradient compression kind {kind!r}; expected one "
                         f"of {', '.join(KINDS)}")


def compress_grads(grads: dict, *, kind: str = "int8", groups=None,
                   ax: AxisGroup | None = None):
    """``(compressed, scales)``: bf16 copies and None, or int8 tensors and
    their fp32 0-d scales (one a group), each by the gradient's name.  On
    a mesh each rank passes its shards and ``ax``, the ranks that hold a
    part of them: a group's absmax is the max over all of them (one
    all-reduce), so that each rank quantizes its part as the whole would
    be."""
    _check_kind(kind)
    if kind == "bf16":
        return {n: g.to(torch.bfloat16) for n, g in grads.items()}, None
    members = {}
    for n in grads:
        members.setdefault((groups or {}).get(n, n), []).append(n)
    amaxes = torch.stack([torch.stack([grads[n].float().abs().amax()
                                       for n in names]).amax()
                          for names in members.values()])
    all_reduce(amaxes, ax, "max")
    q, scales = {}, {}
    for names, amax in zip(members.values(), amaxes):
        scale = torch.clamp_min(amax, 1e-30) / 127.0
        for n in names:
            scales[n] = scale
            q[n] = torch.clamp(torch.round(grads[n].float() / scale), -127,
                               127).to(torch.int8)
    return q, scales


def decompress_grads(grads: dict, scales, *, kind: str = "int8") -> dict:
    """The fp32 gradients of :func:`compress_grads`' output."""
    _check_kind(kind)
    if kind == "bf16":
        return {n: g.float() for n, g in grads.items()}
    return {n: q.float() * scales[n] for n, q in grads.items()}


def compress_with_error_feedback(grads: dict, residual, *,
                                 kind: str = "int8"):
    """Error-feedback compression: ``d = D(C(g + r))``, ``r' = (g + r) -
    d``.  ``residual`` None starts from zeros.  Returns ``(d, r')``."""
    if residual is None:
        residual = {n: torch.zeros_like(g, dtype=torch.float32)
                    for n, g in grads.items()}
    biased = {n: g.float() + residual[n] for n, g in grads.items()}
    deq = decompress_grads(*compress_grads(biased, kind=kind), kind=kind)
    return deq, {n: biased[n] - deq[n] for n in biased}

"""Plans, the geometry a plan reads beyond (m, n, k), and the plan grids.

The port of ``repro/core/blocking.py``'s schema layer.  The reference's
block tuples are TPU tiles; here a call's geometry is a ``Plan`` (the
Hopper GEMM family's and the convolution's: mainloop, tile rows, k a
slice, split-K) or, for the flash kernels, the name of a mainloop.  Every
op maps onto a canonical (m, n, k) triple, as in the reference: GEMM
``m/n/k`` (one entry's, for ``brgemm`` and ``batched_matmul``), conv
``q/c/k`` (output pixels a row, channels in, channels out), attention
``tq/tk/d``.  What else a plan reads travels as a geometry:

  * ``GemmGeometry``: whether TMA can describe both operands, the entries
    of a stacked or batched call, and each operand's layout (the measured
    proxy lays its operands out so);
  * ``ConvGeometry``: batch, input size, window, stride, padding and
    alignment (the reference's carries stride and window only; the
    Hopper plan's split count reads the whole output);
  * ``AttnGeometry``: whether TMA can describe the views.

Each kernel module registers its op's ``PlanSchema`` (heuristic and
candidate grid; a quantized variant apart) with :func:`register_schema`;
``dispatch.resolve_blocks`` and the autotuner reach them through
:func:`default_plan` and :func:`candidate_grid`.  Plans and geometries
serialise field by field for the persisted tuning cache.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Plan:
    mainloop: str      # wgmma, wmma or simt
    bm: int            # tile rows
    bk: int            # k a slice
    splits: int        # runs of k, each its own blocks; 1: no split
    chunk: int         # slices a run
    tiles: int         # output tiles


@dataclasses.dataclass(frozen=True)
class GemmGeometry:
    """A GEMM-family call beyond (m, n, k) and its dtype: ``tma``, TMA can
    describe both operands; ``nb``, entries of a stacked or batched call
    (1 for ``matmul``); ``a_t`` / ``b_t``, the first / second operand is
    read column-major."""
    kind = "gemm"
    tma: bool
    nb: int = 1
    a_t: bool = False
    b_t: bool = False


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """A convolution beyond (q, c, k): batch ``n``, input ``h`` x ``w``,
    an ``r`` x ``s`` window, ``stride``, ``padding``, and ``aligned``
    (16-byte aligned bases)."""
    kind = "conv"
    n: int
    h: int
    w: int
    r: int
    s: int
    stride: int
    padding: int
    aligned: bool = True


@dataclasses.dataclass(frozen=True)
class AttnGeometry:
    """A flash call beyond (tq, tk, d): ``tma``, TMA can describe every
    view it reads."""
    kind = "attn"
    tma: bool


_GEOMETRIES = {g.kind: g for g in (GemmGeometry, ConvGeometry, AttnGeometry)}


@dataclasses.dataclass(frozen=True)
class PlanSchema:
    """An op's plans: ``heuristic(m, n, k, dtype, geometry)`` the static
    pick, ``candidates(m, n, k, dtype, geometry)`` the grid a search
    measures (deterministic, the heuristic first, only plans the kernel
    takes at run time), ``geometry(m, n, k, dtype)`` the geometry of
    plain contiguous row-major operands (a call that names none)."""
    heuristic: Callable
    candidates: Callable
    geometry: Callable


SCHEMAS: dict[tuple[str, bool], PlanSchema] = {}
# The modules that register the schemas, imported on first need.
_SCHEMA_MODULES = ("repro_torch.kernels.brgemm.kernel",
                   "repro_torch.kernels.brgemm.quant_kernel",
                   "repro_torch.kernels.conv2d.kernel",
                   "repro_torch.kernels.flash_attention.kernel",
                   "repro_torch.kernels.flash_attention.bwd")


def register_schema(op: str, schema: PlanSchema, *,
                    quant: bool = False) -> None:
    """Register ``op``'s plans (its quantized variant's with ``quant``)."""
    SCHEMAS[op, quant] = schema


def schema_for(op: str, quant=None) -> PlanSchema:
    key = (op, quant is not None)
    if key not in SCHEMAS:
        for name in _SCHEMA_MODULES:
            importlib.import_module(name)
    if key not in SCHEMAS:
        known = sorted(f"{o}{' (quant)' if q else ''}" for o, q in SCHEMAS)
        raise ValueError(f"no plan schema for op {op!r}"
                         f"{' (quant)' if quant is not None else ''}; "
                         f"known: {', '.join(known)}")
    return SCHEMAS[key]


def default_geometry(op: str, m: int, n: int, k: int, dtype, *,
                     quant=None):
    """The geometry of ``op`` on plain contiguous row-major operands."""
    return schema_for(op, quant).geometry(m, n, k, dtype)


def default_plan(op: str, m: int, n: int, k: int, dtype, *, geometry=None,
                 quant=None):
    """The static heuristic pick: the op's ``plan*`` function."""
    schema = schema_for(op, quant)
    geometry = geometry or schema.geometry(m, n, k, dtype)
    return schema.heuristic(m, n, k, dtype, geometry)


def candidate_grid(op: str, m: int, n: int, k: int, dtype, *, geometry=None,
                   quant=None) -> list:
    """The plans a search measures, the heuristic first."""
    schema = schema_for(op, quant)
    geometry = geometry or schema.geometry(m, n, k, dtype)
    return schema.candidates(m, n, k, dtype, geometry)


def fit_plan(plan, slices: int):
    """``plan`` run over a reduction of ``slices`` slices of its ``bk``.
    A plan is chosen for its problem's k, but under an abstract mesh
    (``dispatch.resolve_blocks``) for the shard's, while the call runs the
    whole: its split count is kept and its runs re-cut to cover the call's
    slices (at its own problem this changes nothing); the kernels fit
    their plans while ``dispatch.localising()``.  A flash plan (a
    mainloop's name) passes through."""
    if not isinstance(plan, Plan):
        return plan
    if plan.splits * plan.chunk >= slices > (plan.splits - 1) * plan.chunk:
        return plan
    chunk = max(1, -(-slices // plan.splits))
    return dataclasses.replace(plan, chunk=chunk,
                               splits=max(1, -(-slices // chunk)))


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the reference's dtype names);
    a string passes through."""
    return dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]


def as_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def plan_to_dict(plan) -> dict:
    """JSON form of a plan: a ``Plan``'s fields, or a flash mainloop."""
    if isinstance(plan, Plan):
        return {"kind": "plan", **dataclasses.asdict(plan)}
    if isinstance(plan, str):
        return {"kind": "mainloop", "mainloop": plan}
    raise TypeError(f"not a plan: {plan!r}")


def plan_from_dict(d: dict):
    """Inverse of :func:`plan_to_dict`."""
    d = dict(d)
    kind = d.pop("kind", None)
    if kind == "mainloop":
        return str(d["mainloop"])
    if kind != "plan":
        raise ValueError(f"unknown plan kind in {d!r}")
    return Plan(mainloop=str(d.pop("mainloop")),
                **{f: int(v) for f, v in d.items()})


def geometry_to_dict(geometry) -> dict:
    return {"kind": geometry.kind, **dataclasses.asdict(geometry)}


def geometry_from_dict(d: dict):
    """Inverse of :func:`geometry_to_dict`."""
    d = dict(d)
    cls = _GEOMETRIES.get(d.pop("kind", None))
    if cls is None:
        raise ValueError(f"unknown geometry kind in {d!r}")
    fields = {f.name: f.type for f in dataclasses.fields(cls)}
    return cls(**{f: (bool(v) if fields[f] == "bool" else int(v))
                  for f, v in d.items()})


# --------------------------------------------------------------------------
# bf16 accumulation: the reference's rounding blocks
# --------------------------------------------------------------------------
#
# Under ``use(accum_dtype=torch.bfloat16)`` each of the reference's Pallas
# kernels keeps its accumulator in bf16 and rounds it once a grid step of
# its reduction, so the rounding points are the ends of the reference's
# reduction blocks, whatever the port's own plan: its heuristic blocks
# (``repro/core/blocking.py``: ``choose_blocks``, ``choose_conv_blocks``,
# ``choose_attention_blocks``, ``choose_attention_bwd_blocks``).  The port
# rounds there and nowhere else.

LANE = 128
ACCUM_OPS = ("matmul", "brgemm", "batched_matmul", "conv2d",
             "flash_attention", "flash_attention_bwd")


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def accum_block(op: str, k: int) -> int:
    """Elements of the reduction between two of the reference's rounding
    points under bf16 accumulation, for ``op`` whose reduction is ``k``
    long (one entry's k; a tap's channels; the keys):

      * ``matmul``, ``brgemm``, ``batched_matmul``: k elements, the
        reference's bk = min(round_up(k, 128), 512) (its
        VMEM budget would halve bk, but never does at its default 128 x 128
        tile).  A stacked walk rounds at each (entry, k-block) end; every
        walk also rounds at the end of k;
      * ``conv2d``: 128 channels of one tap (the reference's ``bc``); a
        tap's last block ends at c;
      * ``flash_attention``: 128 keys (``block_k``), counted from key 0;
      * ``flash_attention_bwd``: 128 keys for dQ and 128 q rows
        for dK and dV (``block_q`` is min(round_up(tq, 8), 128): below 128
        rows one block, whose end is tq's).
    """
    if op in ("matmul", "brgemm", "batched_matmul"):
        return min(round_up(k, LANE), 512)
    if op in ("conv2d", "flash_attention", "flash_attention_bwd"):
        return LANE
    raise ValueError(f"no accumulation blocks for op {op!r}; known: "
                     f"{', '.join(ACCUM_OPS)}")

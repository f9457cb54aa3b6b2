"""FLOP / byte accounting from problem shapes: the roofline substrate.

The port of ``repro/obs/flops.py``, the same formulas.  Costs derive from
each op's canonical tuning triple, the same (m, n, k) ``resolve_blocks``
keys its cache with, so dispatch can stamp every ``resolve_blocks`` event
with the work it represents and a benchmark can report achieved FLOP/s
against arithmetic intensity without knowing op internals:

  matmul              2·m·n·k FLOPs over an (m,k)x(k,n) GEMM
  brgemm / batched    2·m·n·k per batch element (``batch=`` scales)
  conv2d              2·q·k·(c·r·s) per output row of q pixels
                      (geometry carries stride/r/s; 1x1 stride-1 without)
  flash_attention     4·tq·tk·d  (QK^T + PV, softmax folded out; d is q's
                      head size)
  flash_attention_bwd 10·tq·tk·d (recompute + dQ/dK/dV/dP GEMMs)

Bytes are the minimal stream: inputs once and outputs once at the given
storage dtypes (a torch dtype or its name); a ``quant`` spec prices int8 /
fp8 operand storage.  These are arithmetic costs (cache-resident reuse
makes real traffic lower), so the intensity is a lower bound on the
attainable one, the standard roofline x-axis.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OpCost:
    flops: float
    bytes: float

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, FLOPs per byte."""
        return self.flops / self.bytes if self.bytes else 0.0


def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype.itemsize


def _quant_itemsizes(quant, default: int) -> tuple[int, int]:
    """(weight, activation) storage itemsizes under a quant spec (a
    QuantConfig, tag string, or None)."""
    if quant is None:
        return default, default
    tag = quant if isinstance(quant, str) else quant.tag()
    # int8 and fp8 storage are both one byte; unknown tags keep the
    # full-precision pricing rather than guessing
    w = 1 if ("int8" in tag or "fp8" in tag) else default
    return w, w


def op_cost(op: str, m: int, n: int, k: int, dtype, *, geometry=None,
            batch: int = 1, quant=None) -> OpCost:
    """Arithmetic FLOPs and minimal bytes for one execution of ``op`` at
    its canonical triple; see the module docstring for the formulas."""
    isz = _itemsize(dtype)
    w_isz, a_isz = _quant_itemsizes(quant, isz)
    if op in ("matmul", "brgemm", "batched_matmul"):
        flops = 2.0 * m * n * k * batch
        bytes_ = batch * (m * k * a_isz + k * n * w_isz + m * n * 4)
        return OpCost(flops, float(bytes_))
    if op == "conv2d":
        q, c, kk = m, n, k
        stride, r, s = ((geometry.stride, geometry.r, geometry.s)
                        if geometry is not None else (1, 1, 1))
        flops = 2.0 * q * kk * (c * r * s) * batch
        in_row = r * ((q - 1) * stride + s) * c      # input pixels touched
        bytes_ = batch * (in_row * a_isz + r * s * c * kk * w_isz
                          + q * kk * 4)
        return OpCost(flops, float(bytes_))
    if op == "flash_attention":
        tq, tk, d = m, n, k
        flops = 4.0 * tq * tk * d * batch
        bytes_ = batch * ((tq + 2 * tk) * d * a_isz + tq * d * 4)
        return OpCost(flops, float(bytes_))
    if op == "flash_attention_bwd":
        tq, tk, d = m, n, k
        flops = 10.0 * tq * tk * d * batch
        # q/k/v/y/dy in, dq/dk/dv out (+ lse row)
        bytes_ = batch * ((3 * tq + 2 * tk) * d * a_isz
                          + (tq + 2 * tk) * d * 4 + tq * 4)
        return OpCost(flops, float(bytes_))
    raise ValueError(f"no cost model for op {op!r}")

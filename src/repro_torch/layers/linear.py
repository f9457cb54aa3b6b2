"""Fully-connected layer through the batch-reduce GEMM — the paper's
Algorithm 5, the activation fused on the accumulator.

Parameters are a dict, as in the reference (``repro/layers/linear.py``):
``{"w": (C, K), "b": (K,)}``.
"""
from __future__ import annotations

import torch

from repro_torch.core import brgemm
from repro_torch.layers.conv import _draw


def init(c: int, k: int, *, generator: torch.Generator | None = None,
         device="cuda"):
    """fp32 normal weights scaled by ``C ** -0.5``, as the reference's
    default; a zero bias."""
    return {"w": _draw((c, k), generator, device, c ** -0.5),
            "b": torch.zeros(k, device=device)}


def apply(params, x, *, activation: str = "none",
          backend: str | None = None):
    """``act(x @ W + b)``; x: (..., C) -> (..., K)."""
    return brgemm.matmul(x, params["w"], params.get("b"),
                         activation=activation, backend=backend)

"""Transformer MLPs through the batch-reduce GEMM: gated and plain.

The activation is fused into the first GEMM's epilogue (paper Sec. 3.3.2:
apply it while the output block is still hot): the gate GEMM's in the
gated (SwiGLU-style) MLP, where ``g * u`` is taken in the activations'
dtype, and the up GEMM's in the plain one (starcoder2's GELU FFN), as in
the reference (``repro/layers/mlp.py``).  On a mesh's model axis
(``tp``: ``distributed/parallel.py``) each rank holds a block of ``d_ff``:
the input's gradient is summed over the axis and the down projection's
partial outputs are (``distributed/collectives.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import brgemm
from repro_torch.distributed.collectives import (copy_to_model,
                                                 reduce_from_model,
                                                 row_parallel)


def apply(w_gate, w_up, w_down, x, *, activation: str = "silu",
          backend: str | None = None, tp=None):
    """``w_down(act(x w_gate) * (x w_up))``, or ``w_down(act(x w_up))``
    where ``w_gate`` is None."""
    x = copy_to_model(x, tp)
    if w_gate is None:
        h = brgemm.matmul(x, w_up, activation=activation, backend=backend)
    else:
        g = brgemm.matmul(x, w_gate, activation=activation, backend=backend)
        h = g * brgemm.matmul(x, w_up, backend=backend)
    with row_parallel(tp):
        y = brgemm.matmul(h, w_down, backend=backend)
    return reduce_from_model(y, tp)


class MLP(nn.Module):
    """Weights (k, n): ``w_up``, ``w_down``, and ``w_gate`` when gated."""
    tp = None     # a mesh's model axis (collectives.AxisGroup), else None

    def __init__(self, d: int, d_ff: int, *, gated: bool = True,
                 activation: str = "silu", dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        self.activation = activation

        def w(k, n):
            return nn.Parameter(torch.empty(k, n, dtype=dtype, device=device))

        self.w_gate = w(d, d_ff) if gated else None
        self.w_up, self.w_down = w(d, d_ff), w(d_ff, d)

    def forward(self, x, *, backend: str | None = None):
        return apply(self.w_gate, self.w_up, self.w_down, x,
                     activation=self.activation, backend=backend, tp=self.tp)

"""Gated MLP through the batch-reduce GEMM.

The activation is fused into the gate GEMM's epilogue (paper Sec. 3.3.2:
apply it while the output block is still hot); ``g * u`` is taken in the
activations' dtype, as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import brgemm


def apply(w_gate, w_up, w_down, x, *, activation: str = "silu",
          backend: str | None = None):
    g = brgemm.matmul(x, w_gate, activation=activation, backend=backend)
    u = brgemm.matmul(x, w_up, backend=backend)
    return brgemm.matmul(g * u, w_down, backend=backend)


class MLP(nn.Module):
    """SwiGLU-style: ``w_down(act(x w_gate) * (x w_up))``; weights (k, n)."""

    def __init__(self, d: int, d_ff: int, *, activation: str = "silu",
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.activation = activation

        def w(k, n):
            return nn.Parameter(torch.empty(k, n, dtype=dtype, device=device))

        self.w_gate, self.w_up, self.w_down = w(d, d_ff), w(d, d_ff), \
            w(d_ff, d)

    def forward(self, x, *, backend: str | None = None):
        return apply(self.w_gate, self.w_up, self.w_down, x,
                     activation=self.activation, backend=backend)

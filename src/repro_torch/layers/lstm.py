"""LSTM cell through the batch-reduce GEMM — the paper's Algorithm 2,
Equations 1-6.

For each gate g in (i, c, f, o), as the reference (``repro/layers/lstm.py``):

    pre_g = x_t @ W_g                        fp32 out
    g_t   = act(h_{t-1} @ R_g + pre_g + b_g) the second GEMM chained onto
                                             the first's output (c0, beta 1),
                                             bias and sigmoid / tanh fused in
                                             its epilogue

so a time step is 8 ``matmul`` launches; the gates are not fused into one
GEMM.  The reference's ``lax.scan`` over time is a Python loop here.
Parameters are the reference's dict: ``w`` (4, C, K), ``r`` (4, K, K) and
``b`` (4, K), gates stacked in (i, c, f, o) order.  Shapes follow the
paper: x (T, N, C), h and s (T, N, K).
"""
from __future__ import annotations

import torch

from repro_torch.core import brgemm
from repro_torch.layers.conv import _draw

GATES = ("i", "c", "f", "o")
_GATE_ACT = {"i": "sigmoid", "c": "tanh", "f": "sigmoid", "o": "sigmoid"}


def init(c: int, k: int, *, dtype=torch.float32, forget_bias: float = 1.0,
         generator: torch.Generator | None = None, device="cuda"):
    """Normal weights scaled by ``C ** -0.5`` (W) and ``K ** -0.5`` (R),
    drawn in fp32 from ``generator`` then cast to ``dtype``; a zero bias
    but the forget gate's, ``forget_bias``."""
    w = _draw((4, c, k), generator, device, c ** -0.5)
    r = _draw((4, k, k), generator, device, k ** -0.5)
    b = torch.zeros(4, k, device=w.device)
    b[GATES.index("f")] = forget_bias
    return {"w": w.to(dtype), "r": r.to(dtype), "b": b.to(dtype)}


def cell_step(params, x_t, h_prev, s_prev, *, backend: str | None = None):
    """One time step.  x_t: (N, C); h_prev, s_prev: (N, K); ``params[key]
    [g]`` gate g's weight, of the stacked tensor or of its per-gate
    views."""
    gates = []
    for gi, g in enumerate(GATES):
        pre = brgemm.matmul(x_t, params["w"][gi], out_dtype=torch.float32,
                            backend=backend)
        gates.append(brgemm.matmul(
            h_prev, params["r"][gi], params["b"][gi], c0=pre, beta=1.0,
            activation=_GATE_ACT[g], backend=backend))
    i_t, c_t, f_t, o_t = gates
    s_t = f_t * s_prev + i_t * c_t              # Eq. 5
    h_t = o_t * torch.tanh(s_t)                 # Eq. 6
    return h_t.to(x_t.dtype), s_t.to(x_t.dtype)


def forward(params, x, h0=None, s0=None, *, backend: str | None = None):
    """x: (T, N, C) -> h, s: (T, N, K).

    The stacked weights are split into per-gate views once a pass, so that
    autograd sums a gate's gradient over the steps in a buffer of that
    gate's shape and stacks the four once, where indexing the stacked
    tensor every step would zero-fill and add a (4, C, K) gradient per
    step and gate."""
    _, n, _ = x.shape
    k = params["r"].shape[-1]
    h = h0 if h0 is not None else x.new_zeros(n, k)
    s = s0 if s0 is not None else x.new_zeros(n, k)
    gates = {key: params[key].unbind(0) for key in ("w", "r", "b")}
    hs, ss = [], []
    for x_t in x:
        h, s = cell_step(gates, x_t, h, s, backend=backend)
        hs.append(h)
        ss.append(s)
    return torch.stack(hs), torch.stack(ss)

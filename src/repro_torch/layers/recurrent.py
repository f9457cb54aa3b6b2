"""Recurrent layers: RG-LRU (RecurrentGemma), mLSTM and sLSTM (xLSTM).

The paper's LSTM lineage carried to 2024 architectures, as in the
reference (``repro/layers/recurrent.py``): every projection is the
batch-reduce GEMM (``brgemm.matmul``), and the recurrences are elementwise
passes around it.  The reference has no Pallas kernel for the recurrences
themselves, so they are plain PyTorch here, in the reference's order of
operations, with every gate, decay and stabiliser in fp32 whatever the
model dtype:

  * RG-LRU: the diagonal linear recurrence ``h_t = a_t h_{t-1} + b_t`` runs
    as a doubling (Hillis-Steele) scan over T, log2(T) passes, in place of
    the reference's ``associative_scan``; decode is one step.  The scan
    never divides by a running product of ``a`` (which underflows: ``a``
    lies in [0.9, 0.999]).
  * mLSTM: matrix memory with exponential gating, stabilised by a running
    max ``m``.  Prefill and train run the chunkwise-parallel form
    (``mlstm_chunkwise``: an inter-chunk state recurrence, a Python loop
    over chunks, and attention-like intra-chunk products), decode one step
    (``mlstm_step``); ``mlstm_scan`` is the per-step oracle the tests hold
    both to.  The chunk length is ``l = min(chunk, T)`` and T must be a
    multiple of it: the reference's own rule, which raises here.
  * sLSTM: scalar memory with block-diagonal (per-head) recurrent weights,
    sequential by its semantics: one fp32 ``matmul`` for the input part of
    all four gates, then a loop over T of a few launches a step.

Every layer takes ``state=None`` (start from the initial state) or a state
dict, and returns ``(y, new state)``: mLSTM's ``{"c" (B, H, dk, dv), "n"
(B, H, dk), "m" (B, H)}``, sLSTM's ``{"h", "c", "n", "m"}`` each (B, D),
RG-LRU's ``{"h" (B, d_rnn) fp32, "conv" (B, W - 1, d_rnn)}`` in the model
dtype.  A new state is a new tensor: the caller writes it into a cache
(``models/blocks.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import brgemm
from repro_torch.distributed.collectives import (DP_ROWS, axis_scope,
                                                 copy_to_model,
                                                 gather_from_model,
                                                 reduce_from_model,
                                                 row_parallel)
from repro_torch.layers.norms import RMSNorm, rmsnorm

LOG_EPS = -1e30


def _w(*shape, dtype, device):
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device))


def _own(leaf, tp, dim=0):
    """This rank's block along ``dim`` of a leaf the rules replicate but
    the rank uses only in part (its heads' gate biases, its channels'
    decays), read through ``copy_to_model``: its gradient, nonzero on a
    rank only in the rank's block, is summed whole over the model axis
    ``tp``."""
    if tp is None or tp.size == 1:
        return leaf
    n = leaf.shape[dim] // tp.size
    return copy_to_model(leaf, tp).narrow(dim, tp.index * n, n)


# ==========================================================================
# RG-LRU
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class RGLRUCfg:
    d_model: int
    d_rnn: int
    conv_width: int = 4
    c: float = 8.0


def linear_scan(a, b):
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1 from ``h_{-1} = 0``: the
    reference's ``associative_scan`` combine ``(al ar, ar bl + br)`` as a
    doubling scan, log2(T) passes of products and adds."""
    t, s = a.shape[1], 1
    while s < t:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def causal_depthwise_conv(v, conv_w, prefix=None):
    """v: (B, T, d); conv_w: (W, d); prefix: (B, W - 1, d), the carried
    context (zeros when None).  Returns (out, the new prefix), in v's
    dtype."""
    w = conv_w.shape[0]
    if prefix is None:
        prefix = torch.zeros(v.shape[0], w - 1, v.shape[2], dtype=v.dtype,
                             device=v.device)
    vp = torch.cat([prefix, v], dim=1)
    out = sum(vp[:, i:i + v.shape[1]] * conv_w[i] for i in range(w))
    return out, vp[:, -(w - 1):]


class RGLRU(nn.Module):
    """Weights (k, n): ``w_gelu``, ``w_rnn_in`` (d, d_rnn); ``conv_w`` (W,
    d_rnn); ``w_rgate``, ``w_igate`` (d_rnn, d_rnn) with ``b_rgate``,
    ``b_igate``; ``lam`` (d_rnn,); ``w_out`` (d_rnn, d).

    On a mesh's model axis (``tp``, after :meth:`split`; train mode) a rank
    runs its block of the d_rnn channels: its columns of ``w_gelu``,
    ``w_rnn_in``, ``w_rgate`` and ``w_igate`` and its rows of ``w_out``
    (the rules' column- and row-parallel cuts).  The convolution, the
    scan, ``norm * i * v`` and ``u * h`` are per channel, so they run on
    the block as they are, their replicated leaves (``conv_w``, ``lam``,
    the gate biases) cut to it through ``copy_to_model``.  The gates read
    every channel of v: the rank's block of it is all-gathered
    (``gather_from_model``) and enters the gate GEMMs through
    ``copy_to_model``, which sums the gradient each rank's gate columns
    give it.  ``w_out``'s partial outputs are summed over the axis."""
    tp = None     # a mesh's model axis (collectives.AxisGroup), else None

    def __init__(self, cfg: RGLRUCfg, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        d, dr = cfg.d_model, cfg.d_rnn
        kw = dict(dtype=dtype, device=device)
        self.w_gelu, self.w_rnn_in = _w(d, dr, **kw), _w(d, dr, **kw)
        self.conv_w = _w(cfg.conv_width, dr, **kw)
        self.w_rgate, self.b_rgate = _w(dr, dr, **kw), _w(dr, **kw)
        self.w_igate, self.b_igate = _w(dr, dr, **kw), _w(dr, **kw)
        self.lam = _w(dr, **kw)
        self.w_out = _w(dr, d, **kw)

    def split(self, tp) -> None:
        """Keep this rank's block of the d_rnn channels on the model axis
        ``tp`` (new, uninitialised parameters)."""
        d, dr = self.cfg.d_model, self.cfg.d_rnn
        n = dr // tp.size
        kw = dict(dtype=self.w_out.dtype, device=self.w_out.device)
        self.w_gelu, self.w_rnn_in = _w(d, n, **kw), _w(d, n, **kw)
        self.w_rgate, self.w_igate = _w(dr, n, **kw), _w(dr, n, **kw)
        self.w_out = _w(n, d, **kw)
        self.tp = tp

    def _gates(self, v):
        """(a, b) in fp32.  The two gate GEMMs take no ``backend=``: the
        reference's ``_rglru_gates`` passes none, so they follow the
        context's or the default backend even when the caller names one."""
        tp = self.tp
        vin = copy_to_model(gather_from_model(v, tp, 2), tp)
        r = brgemm.matmul(vin, self.w_rgate, _own(self.b_rgate, tp),
                          activation="sigmoid")
        i = brgemm.matmul(vin, self.w_igate, _own(self.b_igate, tp),
                          activation="sigmoid")
        log_a = (-self.cfg.c * F.softplus(_own(self.lam, tp).float())
                 * r.float())
        a = torch.exp(log_a)
        # sqrt(1 - a^2) input normaliser (Griffin Eq. 4)
        norm = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                          1e-12))
        return a, norm * (i.float() * v.float())

    def forward(self, x, *, state=None, backend: str | None = None):
        """x: (B, T, D) -> (y, {"h", "conv"})."""
        tp = self.tp
        x = copy_to_model(x, tp)
        u = brgemm.matmul(x, self.w_gelu, activation="gelu", backend=backend)
        v = brgemm.matmul(x, self.w_rnn_in, backend=backend)
        v, conv = causal_depthwise_conv(
            v, _own(self.conv_w, tp, 1),
            state["conv"] if state is not None else None)
        a, b = self._gates(v)
        if x.shape[1] == 1 and state is not None:       # decode step
            h = a[:, 0] * state["h"] + b[:, 0]
            h_seq = h[:, None]
        else:
            if state is not None:                        # carried h0
                b = torch.cat([b[:, :1] + a[:, :1] * state["h"][:, None],
                               b[:, 1:]], dim=1)
            h_seq = linear_scan(a, b)
            h = h_seq[:, -1]
        with row_parallel(tp):
            y = brgemm.matmul((u.float() * h_seq).to(x.dtype), self.w_out,
                              backend=backend)
        return reduce_from_model(y, tp), {"h": h, "conv": conv}


# ==========================================================================
# mLSTM
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class MLSTMCfg:
    d_model: int
    n_heads: int
    dk: int
    dv: int
    chunk: int = 128


def mlstm_initial(b, h, dk, dv, device):
    """The reference's initial (c, n, m): zeros, zeros, LOG_EPS."""
    return (torch.zeros(b, h, dk, dv, device=device),
            torch.zeros(b, h, dk, device=device),
            torch.full((b, h), LOG_EPS, device=device))


def mlstm_scan(q, k, v, logi, logf, state=None):
    """The stabilised per-step scan, the oracle of the two forms below.

    q, k: (B, H, T, dk); v: (B, H, T, dv); logi, logf: (B, H, T).
    Returns (h (B, H, T, dv), (c, n, m)), all fp32."""
    b, h, t, dk = q.shape
    state = state or mlstm_initial(b, h, dk, v.shape[-1], q.device)
    hs = []
    for i in range(t):
        y, state = mlstm_step(q[:, :, i].float(), k[:, :, i].float(),
                              v[:, :, i].float(), logi[:, :, i],
                              logf[:, :, i], state)
        hs.append(y)
    return torch.stack(hs, dim=2), state


def chunk_len(chunk: int, t: int) -> int:
    """mLSTM's chunk over T steps: ``min(chunk, t)``, which must divide T
    (the reference's rule: prompts of at most ``chunk`` tokens, or a
    multiple of it)."""
    length = min(chunk, t)
    if t % length:
        raise ValueError(
            f"mLSTM's chunkwise form takes T <= chunk or a multiple of the "
            f"chunk: T = {t}, chunk = {chunk} (the reference's rule)")
    return length


def mlstm_chunkwise(q, k, v, logi, logf, *, chunk: int = 128, state=None):
    """Chunkwise-parallel stabilised mLSTM (prefill and train).

    T splits into chunks of ``chunk_len(chunk, T)``; the (c, n, m) state
    runs from chunk to chunk, and within a chunk the outputs are an
    attention-like (L x L) product plus the state path, as the
    reference's ``mlstm_chunkwise``.  Shapes as ``mlstm_scan``'s."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    length = chunk_len(chunk, t)
    nc = t // length

    def chunks(x):
        return x.reshape(b, h, nc, length, *x.shape[3:]).float().unbind(2)

    qc, kc, vc, lic, lfc = (chunks(x) for x in (q, k, v, logi, logf))
    c, n, m = state or mlstm_initial(b, h, dk, dv, q.device)
    tri = torch.tril(torch.ones(length, length, dtype=torch.bool,
                                device=q.device))
    outs = []
    for q_t, k_t, v_t, li, lf in zip(qc, kc, vc, lic, lfc):
        bcum = torch.cumsum(lf, dim=-1)        # inclusive cumsum of log f
        g_tot = bcum[..., -1:]                 # (B, H, 1)
        # intra-chunk log-decay scores s[t, tau] = b_t - b_tau + li_tau
        s = bcum[..., :, None] - bcum[..., None, :] + li[..., None, :]
        s = torch.where(tri, s, LOG_EPS)
        a_state = bcum + m[..., None]          # state-path log weight
        m_t = torch.maximum(a_state, s.amax(dim=-1))
        p = torch.exp(s - m_t[..., None])
        state_w = torch.exp(a_state - m_t)
        qk = torch.einsum("bhtd,bhsd->bhts", q_t, k_t)
        num = (state_w[..., None] * torch.einsum("bhtd,bhdv->bhtv", q_t, c)
               + torch.einsum("bhts,bhsv->bhtv", p * qk, v_t))
        den = (state_w * torch.einsum("bhtd,bhd->bht", q_t, n)
               + (p * qk).sum(dim=-1))
        den = torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
        outs.append(num / den)
        # end-of-chunk state
        w_tok = g_tot - bcum + li
        m_new = torch.maximum(g_tot[..., 0] + m, w_tok.amax(dim=-1))
        carry_w = torch.exp(g_tot[..., 0] + m - m_new)
        tok_w = torch.exp(w_tok - m_new[..., None])
        c = (carry_w[..., None, None] * c
             + torch.einsum("bhsd,bhsv->bhdv", tok_w[..., None] * k_t, v_t))
        n = carry_w[..., None] * n + torch.einsum("bhs,bhsd->bhd", tok_w,
                                                  k_t)
        m = m_new
    return torch.stack(outs, dim=2).reshape(b, h, t, dv), (c, n, m)


def mlstm_step(q1, k1, v1, li1, lf1, state):
    """One decode step.  q1, k1: (B, H, dk); v1: (B, H, dv); li1, lf1: (B,
    H); fp32.  Returns (h (B, H, dv), (c, n, m))."""
    c, n, m = state
    m_new = torch.maximum(lf1 + m, li1)
    i_p = torch.exp(li1 - m_new)[..., None]
    f_p = torch.exp(lf1 + m - m_new)[..., None]
    n_new = f_p * n + i_p * k1
    c_new = f_p[..., None] * c + i_p[..., None] * (k1[..., :, None]
                                                   * v1[..., None, :])
    num = torch.einsum("bhk,bhkv->bhv", q1, c_new)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q1, n_new).abs(),
                        torch.exp(-m_new))[..., None]
    return num / den, (c_new, n_new, m_new)


class MLSTM(nn.Module):
    """Weights (k, n): ``wq``, ``wk`` (d, H dk); ``wv``, ``wo`` (d, H dv);
    ``wi``, ``wf`` (d, H) with ``bi``, ``bf``; ``head_norm`` (dv); ``w_out``
    (H dv, d).  Seven ``matmul`` launches a forward.

    On a mesh's model axis (``tp``, after :meth:`split`; train mode) a rank
    runs its heads: its columns of ``wq``, ``wk``, ``wv``, ``wi`` and
    ``wf`` (n = H / m for the gates), its rows of ``w_out`` (the partial
    outputs summed over the axis), and its heads' entries of ``bi`` and
    ``bf`` and the whole ``head_norm`` scale, which the rules replicate,
    read through ``copy_to_model``.  The rules put ``wo``'s *rows* on the
    axis (its name is in their row-parallel set), so a rank holds d / m
    rows of every head's output-gate columns: it all-gathers them
    (``gather_from_model``) and reads the whole ``wo`` through
    ``copy_to_model`` before taking its heads' columns, so that the
    gradient, partial on each rank, is summed before the gather's backward
    keeps the rank's rows."""
    tp = None     # a mesh's model axis (collectives.AxisGroup), else None

    def __init__(self, cfg: MLSTMCfg, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        kw = dict(dtype=dtype, device=device)
        self.wq, self.wk = _w(d, h * cfg.dk, **kw), _w(d, h * cfg.dk, **kw)
        self.wv = _w(d, h * cfg.dv, **kw)
        self.wi, self.bi = _w(d, h, **kw), _w(h, **kw)
        self.wf, self.bf = _w(d, h, **kw), _w(h, **kw)
        self.wo = _w(d, h * cfg.dv, **kw)
        self.head_norm = RMSNorm(cfg.dv, **kw)
        self.w_out = _w(h * cfg.dv, d, **kw)

    def split(self, tp) -> None:
        """Keep this rank's heads on the model axis ``tp`` and its block of
        ``wo``'s rows (new, uninitialised parameters); ``cfg`` counts the
        rank's heads."""
        cfg = self.cfg
        d, h = cfg.d_model, cfg.n_heads // tp.size
        kw = dict(dtype=self.wo.dtype, device=self.wo.device)
        self.wq, self.wk = _w(d, h * cfg.dk, **kw), _w(d, h * cfg.dk, **kw)
        self.wv = _w(d, h * cfg.dv, **kw)
        self.wi, self.wf = _w(d, h, **kw), _w(d, h, **kw)
        self.wo = _w(d // tp.size, cfg.n_heads * cfg.dv, **kw)
        self.w_out = _w(h * cfg.dv, d, **kw)
        self.cfg = dataclasses.replace(cfg, n_heads=h)
        self.tp = tp

    def _out_gate(self):
        """``wo``'s columns of this rank's heads (the whole ``wo`` off a
        model axis)."""
        tp = self.tp
        if tp is None or tp.size == 1:
            return self.wo
        wo = copy_to_model(gather_from_model(self.wo, tp, 0), tp)
        n = self.cfg.n_heads * self.cfg.dv
        return wo.narrow(1, tp.index * n, n)

    def forward(self, x, *, state=None, backend: str | None = None):
        """x: (B, T, D) -> (y, {"c", "n", "m"})."""
        cfg, tp = self.cfg, self.tp
        b, t, _ = x.shape
        h = cfg.n_heads
        x = copy_to_model(x, tp)

        def heads(y, dh):
            return y.reshape(b, t, h, dh).transpose(1, 2)

        q = heads(brgemm.matmul(x, self.wq, backend=backend), cfg.dk)
        k = heads(brgemm.matmul(x, self.wk, backend=backend), cfg.dk)
        k = k * cfg.dk ** -0.5
        v = heads(brgemm.matmul(x, self.wv, backend=backend), cfg.dv)
        logi = brgemm.matmul(x, self.wi, _own(self.bi, tp),
                             out_dtype=torch.float32,
                             backend=backend).transpose(1, 2)   # (B, H, T)
        logf = F.logsigmoid(brgemm.matmul(
            x, self.wf, _own(self.bf, tp), out_dtype=torch.float32,
            backend=backend)).transpose(1, 2)
        carried = (None if state is None else
                   (state["c"], state["n"], state["m"]))
        if t == 1 and state is not None:
            hv, (c, n, m) = mlstm_step(
                q[:, :, 0].float(), k[:, :, 0].float(), v[:, :, 0].float(),
                logi[:, :, 0], logf[:, :, 0], carried)
            hv = hv[:, :, None]
        else:
            hv, (c, n, m) = mlstm_chunkwise(q, k, v, logi, logf,
                                            chunk=cfg.chunk, state=carried)
        hv = rmsnorm(hv.to(x.dtype), copy_to_model(self.head_norm.scale, tp))
        o = torch.sigmoid(brgemm.matmul(x, self._out_gate(), backend=backend))
        y = (hv * heads(o, cfg.dv)).transpose(1, 2).reshape(b, t,
                                                            h * cfg.dv)
        with row_parallel(tp):
            y = brgemm.matmul(y, self.w_out, backend=backend)
        return reduce_from_model(y, tp), {"c": c, "n": n, "m": m}


# ==========================================================================
# sLSTM
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class SLSTMCfg:
    d_model: int
    n_heads: int

    @property
    def dh(self) -> int:
        return self.d_model // self.n_heads


def slstm_initial(b, d, device):
    """The reference's initial state: h, c zeros; n ones; m LOG_EPS."""
    return {"h": torch.zeros(b, d, device=device),
            "c": torch.zeros(b, d, device=device),
            "n": torch.ones(b, d, device=device),
            "m": torch.full((b, d), LOG_EPS, device=device)}


class SLSTM(nn.Module):
    """Weights: ``w`` (d, 4d), the input part of the gates z, i, f, o;
    ``r`` (H, dh, 4 dh), the per-head recurrent part; ``b`` (4d,).  One
    ``matmul`` launch a forward, then T steps of plain ops.

    On a mesh's model axis (``tp``, after :meth:`split`; train mode) a rank
    holds a block of ``w``'s and ``r``'s columns, as the rules cut them.
    Their layout is gate-major, so a block holds whole gates, not whole
    channels, and the recurrence needs all four gates of a channel at
    every step: the rank all-gathers the two weights once a forward
    (``gather_from_model``) and runs the layer whole, as every rank does.
    Its input and output gradients are then whole on every rank, so the
    input takes no ``copy_to_model`` and the output no reduction, and the
    gather's backward keeps the rank's block of a whole gradient."""
    tp = None     # a mesh's model axis (collectives.AxisGroup), else None

    def __init__(self, cfg: SLSTMCfg, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.dh
        kw = dict(dtype=dtype, device=device)
        self.w = _w(d, 4 * d, **kw)
        self.r = _w(h, dh, 4 * dh, **kw)
        self.b = _w(4 * d, **kw)

    def split(self, tp) -> None:
        """Keep this rank's block of ``w``'s and ``r``'s columns on the
        model axis ``tp`` (new, uninitialised parameters)."""
        d, h, dh = self.cfg.d_model, self.cfg.n_heads, self.cfg.dh
        kw = dict(dtype=self.w.dtype, device=self.w.device)
        self.w = _w(d, 4 * d // tp.size, **kw)
        self.r = _w(h, dh, 4 * dh // tp.size, **kw)
        self.tp = tp

    def forward(self, x, *, state=None, backend: str | None = None):
        """x: (B, T, D) -> (y in x's dtype, {"h", "c", "n", "m"})."""
        b, t, d = x.shape
        h, dh = self.cfg.n_heads, self.cfg.dh
        tp = self.tp
        w = gather_from_model(self.w, tp, 1)
        with axis_scope("matmul", DP_ROWS, tp):
            x_part = brgemm.matmul(x, w, out_dtype=torch.float32,
                                   backend=backend)           # (B, T, 4D)
        bias = self.b.float()
        r_w = gather_from_model(self.r, tp, 2).float()
        st = state if state is not None else slstm_initial(b, d, x.device)
        h_prev, c, n, m = st["h"], st["c"], st["n"], st["m"]
        hs = []
        for i in range(t):
            rec = torch.einsum("bhd,hde->bhe", h_prev.reshape(b, h, dh),
                               r_w).reshape(b, 4 * d)
            pre = x_part[:, i] + rec + bias
            z_t = torch.tanh(pre[:, :d])
            li = pre[:, d:2 * d]
            lf = F.logsigmoid(pre[:, 2 * d:3 * d])
            o_t = torch.sigmoid(pre[:, 3 * d:])
            m_new = torch.maximum(lf + m, li)
            i_p = torch.exp(li - m_new)
            f_p = torch.exp(lf + m - m_new)
            c = f_p * c + i_p * z_t
            n = f_p * n + i_p
            h_prev = o_t * c / torch.maximum(n, torch.exp(-m_new))
            m = m_new
            hs.append(h_prev)
        y = torch.stack(hs, dim=1).to(x.dtype)
        return y, {"h": h_prev, "c": c, "n": n, "m": m}

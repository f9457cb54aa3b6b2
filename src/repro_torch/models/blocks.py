"""The decoder block: ``x += attn(ln1(x)); x += ffn(ln2(x))``.

The attention is GQA or MLA (``cfg.mla``); the FFN a gated or plain MLP
(``cfg.gated_mlp``) or, with ``use_moe``, the MoE layer
(``layers/moe.py``), whose aux losses the block returns beside its output
(zeros for an MLP, as the reference's fixed aux structure).  A
sliding-window GQA config serves from a ring cache of ``min(max_len,
window)`` positions (``layers/attention.py``).

The recurrent families run blocks of their own (``repro/models/
blocks.py``): xLSTM's ``MLSTMBlock`` and ``SLSTMBlock`` (``x += mixer(ln(
x))``), RecurrentGemma's ``RecBlock`` (RG-LRU, then a gated MLP) and
``LocalAttnBlock`` (windowed GQA over a ring cache, then a gated MLP).
``recurrent_layout`` lists their layers in the order the reference's
stacks run them.  A recurrent block's cache is its state, which it reads
as the initial state in every mode but train (train starts from the
initial state, as the reference's ``_train_states``) and overwrites in
place with the new one, so that a pool's views see the update.  The
encoder-decoder's blocks live in ``models/encdec.py``, as in the
reference.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchCfg
from repro_torch.layers import attention, moe, recurrent
from repro_torch.layers.mlp import MLP
from repro_torch.layers.norms import RMSNorm

ZERO_AUX = {"load_balance_loss": 0.0, "router_z_loss": 0.0,
            "dropped_fraction": 0.0}
UNPORTED = ()
RECURRENT = ("xlstm", "rglru_hybrid")


def dtype_of(cfg: ArchCfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def attn_cfg(cfg: ArchCfg) -> attention.AttnCfg:
    return attention.AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, window=cfg.window,
        mla=cfg.mla, q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank, qk_nope_dim=cfg.qk_nope_dim,
        qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim)


def moe_cfg(cfg: ArchCfg) -> moe.MoECfg:
    return moe.MoECfg(
        d_model=cfg.d_model, d_ff=cfg.moe_d_ff, n_experts=cfg.n_experts,
        top_k=cfg.top_k, n_shared=cfg.n_shared_experts,
        capacity_factor=cfg.moe_capacity_factor)


def check_ported(cfg: ArchCfg) -> None:
    """The families the port serves: dense (a VLM's patch prefix among
    them), moe, mla_moe (DeepSeek-V3), the recurrent xlstm and
    rglru_hybrid, and the encoder-decoder (encdec).  MLA (``mla=True``)
    runs in the dense family and in mla_moe.  It is refused in the
    encoder-decoder, where the reference itself fails (its decoder block
    reads ``wq``, which an MLA attention does not have: ``KeyError:
    'wq'`` in ``loss_fn`` and ``prefill``)."""
    if cfg.block in UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: block={cfg.block!r} is not ported yet")
    if cfg.block not in ("dense", "moe", "mla_moe", "encdec") + RECURRENT:
        raise ValueError(f"unknown block {cfg.block!r}")
    if cfg.mla and cfg.block not in ("dense", "mla_moe"):
        raise NotImplementedError(
            f"{cfg.name}: mla=True runs in the dense and mla_moe families; "
            f"block={cfg.block!r} with MLA is refused, as the reference "
            f"fails on it (its {cfg.block} layers read the GQA weights: "
            f"KeyError: 'wq')")


def cache_len(cfg: ArchCfg, max_len: int) -> int:
    """A layer's cache positions: a windowed GQA config's ring holds at
    most ``window``."""
    return min(max_len, cfg.window) if cfg.window and not cfg.mla \
        else max_len


class DecoderBlock(nn.Module):
    """``ln1``, ``attn`` (GQA or MLA), ``ln2``, and ``mlp`` or ``moe``."""

    def __init__(self, cfg: ArchCfg, *, use_moe: bool = False, device="cpu"):
        super().__init__()
        check_ported(cfg)
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        acfg = attn_cfg(cfg)
        self.attn = (attention.MLAttention if cfg.mla else
                     attention.Attention)(acfg, dtype=dt, device=device)
        self.ln2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        if use_moe:
            self.moe = moe.MoE(moe_cfg(cfg), dtype=dt, device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                           activation=cfg.mlp_activation, dtype=dt,
                           device=device)

    def forward(self, x, *, mode: str = "train", cache=None, pos=0,
                row_groups: bool = False, backend: str | None = None):
        """Returns ``(x, cache, aux)``; the cache is the one given, written
        in place (``None`` in train mode).  ``pos``: the chunk's first
        position (prefill_chunk), the token's positions (decode; a (B,)
        tensor, one a row).  ``row_groups``: the MoE routes each row as a
        group of its own (a slot pool's decode)."""
        if self.cfg.window and not self.cfg.mla and mode == "prefill_chunk":
            raise ValueError(
                "chunked prefill is not supported for sliding-window archs "
                "(ring cache holds only the trailing window)")
        h = self.ln1(x)
        if mode == "train":
            x = x + self.attn(h, mode="train", backend=backend)
        else:
            y, cache = self.attn(h, mode=mode, cache=cache, pos=pos,
                                 backend=backend)
            x = x + y
        h = self.ln2(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(h, row_groups=row_groups, backend=backend)
        else:
            y, aux = self.mlp(h, backend=backend), ZERO_AUX
        return x + y, cache, aux


def decoder_block_cache(cfg: ArchCfg, batch: int, max_len: int, *,
                        device="cpu"):
    return attention.init_cache(attn_cfg(cfg), batch, cache_len(cfg, max_len),
                                dtype=dtype_of(cfg), device=device)


# --------------------------------------------------------------------------
# the recurrent families: xLSTM and RecurrentGemma
# --------------------------------------------------------------------------

def mlstm_cfg(cfg: ArchCfg) -> recurrent.MLSTMCfg:
    dh = cfg.d_model // cfg.n_heads
    return recurrent.MLSTMCfg(d_model=cfg.d_model, n_heads=cfg.n_heads,
                              dk=dh, dv=dh, chunk=cfg.mlstm_chunk)


def slstm_cfg(cfg: ArchCfg) -> recurrent.SLSTMCfg:
    return recurrent.SLSTMCfg(d_model=cfg.d_model, n_heads=cfg.n_heads)


def rglru_cfg(cfg: ArchCfg) -> recurrent.RGLRUCfg:
    return recurrent.RGLRUCfg(d_model=cfg.d_model, d_rnn=cfg.d_rnn)


def recurrent_layout(cfg: ArchCfg) -> list[tuple[str, str, tuple]]:
    """(kind, the reference's stack, index in it) of each layer, in the
    order the reference's stacks run them.  xlstm: ``n_layers /
    slstm_every`` groups of ``slstm_every - 1`` mLSTMs (``mlstm_groups``
    (g, per, ...)) then one sLSTM (``slstm_groups`` (g, ...)), or, where
    ``n_layers`` is no multiple of ``slstm_every``, one group of mLSTMs
    only.  rglru_hybrid: ``n_layers / len(pattern)`` groups, each its
    ``pattern.count("rec")`` rec blocks (``groups.rec`` (g, n_rec, ...))
    and *then* its attention block (``groups.attn`` (g, ...)), whatever
    the pattern's order, then the trailing rec blocks (``tail_rec``)."""
    if cfg.block == "xlstm":
        se = cfg.slstm_every or cfg.n_layers + 1
        if cfg.n_layers % se:
            return [("mlstm", "mlstm_groups", (0, j))
                    for j in range(cfg.n_layers)]
        out = []
        for g in range(cfg.n_layers // se):
            out += [("mlstm", "mlstm_groups", (g, j)) for j in range(se - 1)]
            out.append(("slstm", "slstm_groups", (g,)))
        return out
    if cfg.block == "rglru_hybrid":
        n_pat = len(cfg.pattern)
        n_groups, n_rec = cfg.n_layers // n_pat, cfg.pattern.count("rec")
        out = []
        for g in range(n_groups):
            out += [("rec", "groups.rec", (g, j)) for j in range(n_rec)]
            out.append(("attn", "groups.attn", (g,)))
        return out + [("rec", "tail_rec", (j,))
                      for j in range(cfg.n_layers - n_groups * n_pat)]
    raise ValueError(f"block={cfg.block!r} is not recurrent")


def _carry(cache, mode, new):
    """A recurrent block's cache after a forward: in train mode none; else
    ``cache`` with the new state written into it in place."""
    if mode == "train":
        return None
    for key, value in new.items():
        cache[key].copy_(value)
    return cache


class _Mixer(nn.Module):
    """xLSTM's block: ``x + mixer(ln(x))``, the mixer mLSTM or sLSTM."""

    def __init__(self, cfg: ArchCfg, device):
        super().__init__()
        self.cfg = cfg
        self.ln = RMSNorm(cfg.d_model, dtype=dtype_of(cfg), device=device)

    def forward(self, x, *, mode: str = "train", cache=None, pos=0,
                row_groups: bool = False, backend: str | None = None):
        """Returns ``(x, cache, ZERO_AUX)`` as ``DecoderBlock`` does; the
        cache is the block's state, read (but in train mode) and written in
        place."""
        state = None if mode == "train" else cache
        y, new = getattr(self, self.kind)(self.ln(x), state=state,
                                          backend=backend)
        return x + y, _carry(cache, mode, new), ZERO_AUX


class MLSTMBlock(_Mixer):
    kind = "mlstm"
    leaves = ("c", "n", "m")

    def __init__(self, cfg: ArchCfg, *, device="cpu"):
        super().__init__(cfg, device)
        self.mlstm = recurrent.MLSTM(mlstm_cfg(cfg), dtype=dtype_of(cfg),
                                     device=device)

    @staticmethod
    def init_cache(cfg: ArchCfg, batch: int, max_len: int, *,
                   device="cpu"):
        m = mlstm_cfg(cfg)
        return dict(zip(MLSTMBlock.leaves, recurrent.mlstm_initial(
            batch, m.n_heads, m.dk, m.dv, device)))


class SLSTMBlock(_Mixer):
    kind = "slstm"
    leaves = ("h", "c", "n", "m")

    def __init__(self, cfg: ArchCfg, *, device="cpu"):
        super().__init__(cfg, device)
        self.slstm = recurrent.SLSTM(slstm_cfg(cfg), dtype=dtype_of(cfg),
                                     device=device)

    @staticmethod
    def init_cache(cfg: ArchCfg, batch: int, max_len: int, *,
                   device="cpu"):
        return recurrent.slstm_initial(batch, cfg.d_model, device)


class RecBlock(nn.Module):
    """RecurrentGemma's recurrent block: ``x += rglru(ln1(x)); x +=
    mlp(ln2(x))``."""
    kind = "rec"
    leaves = ("h", "conv")

    def __init__(self, cfg: ArchCfg, *, device="cpu"):
        super().__init__()
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.rglru = recurrent.RGLRU(rglru_cfg(cfg), dtype=dt, device=device)
        self.ln2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                       activation=cfg.mlp_activation, dtype=dt,
                       device=device)

    def forward(self, x, *, mode: str = "train", cache=None, pos=0,
                row_groups: bool = False, backend: str | None = None):
        state = None if mode == "train" else cache
        y, new = self.rglru(self.ln1(x), state=state, backend=backend)
        x = x + y
        x = x + self.mlp(self.ln2(x), backend=backend)
        return x, _carry(cache, mode, new), ZERO_AUX

    @staticmethod
    def init_cache(cfg: ArchCfg, batch: int, max_len: int, *,
                   device="cpu"):
        r = rglru_cfg(cfg)
        return {"h": torch.zeros(batch, r.d_rnn, device=device),
                "conv": torch.zeros(batch, r.conv_width - 1, r.d_rnn,
                                    dtype=dtype_of(cfg), device=device)}


class LocalAttnBlock(nn.Module):
    """RecurrentGemma's attention block: ``x += attn(ln1(x)); x +=
    mlp(ln2(x))``, the attention windowed GQA served from a ring of
    ``min(max_len, window)`` positions (``layers/attention.py``: prefill's
    windowed flash and its last window kept at ``p % w``, decode's write at
    ``pos % w``), the values of the reference's ``_ring_from_prefill`` and
    ``_ring_decode``."""
    kind = "attn"
    leaves = ("k", "v")

    def __init__(self, cfg: ArchCfg, *, device="cpu"):
        super().__init__()
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.attn = attention.Attention(attn_cfg(cfg), dtype=dt,
                                        device=device)
        self.ln2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                       activation=cfg.mlp_activation, dtype=dt,
                       device=device)

    def forward(self, x, *, mode: str = "train", cache=None, pos=0,
                row_groups: bool = False, backend: str | None = None):
        h = self.ln1(x)
        if mode == "train":
            x = x + self.attn(h, mode="train", backend=backend)
        else:
            y, cache = self.attn(h, mode=mode, cache=cache, pos=pos,
                                 backend=backend)
            x = x + y
        x = x + self.mlp(self.ln2(x), backend=backend)
        return x, cache, ZERO_AUX

    @staticmethod
    def init_cache(cfg: ArchCfg, batch: int, max_len: int, *,
                   device="cpu"):
        return decoder_block_cache(cfg, batch, max_len, device=device)


RECURRENT_BLOCKS = {cls.kind: cls for cls in (MLSTMBlock, SLSTMBlock,
                                              RecBlock, LocalAttnBlock)}

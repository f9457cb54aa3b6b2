"""The decoder block: ``x += attn(ln1(x)); x += ffn(ln2(x))``.

The attention is GQA or MLA (``cfg.mla``); the FFN a gated or plain MLP
(``cfg.gated_mlp``) or, with ``use_moe``, the MoE layer
(``layers/moe.py``), whose aux losses the block returns beside its output
(zeros for an MLP, as the reference's fixed aux structure).  A
sliding-window GQA config serves from a ring cache of ``min(max_len,
window)`` positions (``layers/attention.py``).  The xLSTM, RG-LRU and
encoder-decoder families wait for later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchCfg
from repro_torch.layers import attention, moe
from repro_torch.layers.mlp import MLP
from repro_torch.layers.norms import RMSNorm

ZERO_AUX = {"load_balance_loss": 0.0, "router_z_loss": 0.0,
            "dropped_fraction": 0.0}
UNPORTED = ("xlstm", "rglru_hybrid", "encdec")


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
    """The decoder families the port serves: dense (a VLM's patch prefix
    among them), moe, and mla_moe, where MLA is used (DeepSeek-V3)."""
    if cfg.block in UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: block={cfg.block!r} is not ported yet")
    if cfg.block not in ("dense", "moe", "mla_moe"):
        raise ValueError(f"unknown block {cfg.block!r}")
    if cfg.mla and cfg.block != "mla_moe":
        raise NotImplementedError(
            f"{cfg.name}: the port serves mla=True in the mla_moe family "
            f"only (block={cfg.block!r})")


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

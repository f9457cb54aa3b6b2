"""The dense decoder block: ``x += attn(ln1(x)); x += mlp(ln2(x))``.

The MLP is gated or plain (``cfg.gated_mlp``); a sliding-window config
serves from a ring cache of ``min(max_len, window)`` positions
(``layers/attention.py``).  Other block families (MoE, MLA, xLSTM,
RG-LRU, encoder-decoder) wait for later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchCfg
from repro_torch.layers import attention
from repro_torch.layers.mlp import MLP
from repro_torch.layers.norms import RMSNorm


def dtype_of(cfg: ArchCfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def attn_cfg(cfg: ArchCfg) -> attention.AttnCfg:
    return attention.AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, window=cfg.window)


def check_dense(cfg: ArchCfg) -> None:
    """Dense GQA decoders, a VLM's patch prefix (``n_patches``) among
    them."""
    if cfg.block != "dense" or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense GQA decoders only "
            f"(block={cfg.block!r}, mla={cfg.mla})")


def cache_len(cfg: ArchCfg, max_len: int) -> int:
    """A layer's cache positions: a windowed config's ring holds at most
    ``window``."""
    return min(max_len, cfg.window) if cfg.window else max_len


class DecoderBlock(nn.Module):
    def __init__(self, cfg: ArchCfg, *, device="cpu"):
        super().__init__()
        check_dense(cfg)
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
                backend: str | None = None):
        """Returns ``(x, cache)``; the cache is the one given, written in
        place (``None`` in train mode).  ``pos``: the chunk's first
        position (prefill_chunk), the token's positions (decode; a (B,)
        tensor, one a row)."""
        if self.cfg.window and mode == "prefill_chunk":
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
        x = x + self.mlp(self.ln2(x), backend=backend)
        return x, cache


def decoder_block_cache(cfg: ArchCfg, batch: int, max_len: int, *,
                        device="cpu"):
    return attention.init_cache(attn_cfg(cfg), batch, cache_len(cfg, max_len),
                                dtype=dtype_of(cfg), device=device)

"""GQA attention: the train, prefill, prefill_chunk and decode modes.

Every projection routes through the batch-reduce GEMM; prefill and train
run the flash kernel; decode runs the plain ``mha_ref`` of one query
against the padded cache, and a prompt chunk ``mha_ref`` of its queries
against the cache with ``q_offset`` (as in the reference, where neither is
a kernel: the flash kernel has no ``q_offset``).  Decode attention reads
the whole cache under a ``kv_len = pos + 1`` mask every step, so its cost
grows with the cache's length, not with the tokens written.

The KV cache of a layer is ``{"k", "v"}``, each (B, Hkv, max_len, dh),
preallocated by ``init_cache``.  Every mode but train writes into it **in
place** (slice or indexed assignment, where the reference's
``dynamic_update_slice`` makes a new array) and returns the same dict.
Decode takes a (B,) tensor of positions, one per row: a static batch
passes one position for every row, a slot pool each slot's own length
(the reference ``vmap``s a batch-1 decode over the slots; here one
batched call applies RoPE, writes K and V and masks attention per row).

With a sliding window the cache is a ring of ``w = min(max_len, window)``
positions (``repro/models/blocks.py``, ``_ring_from_prefill`` and
``_ring_decode``): prefill runs windowed flash attention over the whole
prompt and keeps its last ``w`` keys and values, position ``p`` at slot
``p % w``; decode writes each row's token at ``pos % w`` and attends,
unmasked by position, over its ``min(pos + 1, w)`` entries.  The reference
projects K and V a second time for the ring; here the prefill's own are
kept.  A ring holds no stable position range, so chunked prefill (and
paging) refuse windowed configs.  MLA waits for a later slice.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core import brgemm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.layers.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int | None = None
    rope_theta: float = 10000.0
    window: int | None = None          # sliding-window size (None = full)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def init_cache(cfg: AttnCfg, batch: int, max_len: int, *,
               dtype=torch.float32, device="cpu"):
    shape = (batch, cfg.n_kv_heads, max_len, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _split_heads(x, n_heads):
    b, t, _ = x.shape
    return x.reshape(b, t, n_heads, -1).transpose(1, 2)  # (B,H,T,dh) view


def _merge_heads(x):
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


class Attention(nn.Module):
    """Weights ``wq, wk, wv`` (d_model, H*dh) and ``wo`` (Hq*dh, d_model)."""

    def __init__(self, cfg: AttnCfg, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        dh = cfg.dh

        def w(k, n):
            return nn.Parameter(torch.empty(k, n, dtype=dtype, device=device))

        self.wq = w(cfg.d_model, cfg.n_heads * dh)
        self.wk = w(cfg.d_model, cfg.n_kv_heads * dh)
        self.wv = w(cfg.d_model, cfg.n_kv_heads * dh)
        self.wo = w(cfg.n_heads * dh, cfg.d_model)

    def _qkv(self, x, positions, backend):
        cfg = self.cfg
        q = _split_heads(brgemm.matmul(x, self.wq, backend=backend),
                         cfg.n_heads)
        k = _split_heads(brgemm.matmul(x, self.wk, backend=backend),
                         cfg.n_kv_heads)
        v = _split_heads(brgemm.matmul(x, self.wv, backend=backend),
                         cfg.n_kv_heads)
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
        return q, k, v

    def _out(self, o, backend):
        return brgemm.matmul(_merge_heads(o), self.wo, backend=backend)

    def forward(self, x, *, mode: str = "train", cache=None, pos=0,
                backend: str | None = None):
        """x: (B, T, D).  Returns y for train, (y, cache) for the others.

        prefill_chunk: the T queries sit at absolute positions ``pos ..
        pos+T-1`` (``pos`` an int), see everything already in the cache
        causally, and write their K and V at ``pos``.  decode: T = 1 token
        a row, at the row's position in ``pos``, a (B,) tensor."""
        cfg = self.cfg
        t = x.shape[1]
        if mode in ("train", "prefill"):
            q, k, v = self._qkv(x, torch.arange(t, device=x.device), backend)
            o = flash_attention(q, k, v, causal=True, window=cfg.window,
                                backend=backend)
            if mode == "train":
                return self._out(o, backend)
            w = cache["k"].shape[2]
            for key, new in (("k", k), ("v", v)):
                if cfg.window and t >= w:     # the last w, at p % w
                    cache[key][:] = torch.roll(new[:, :, t - w:],
                                               (t - w) % w, dims=2)
                else:
                    cache[key][:, :, :t] = new
            return self._out(o, backend), cache
        if mode == "prefill_chunk":
            q, k, v = self._qkv(x, pos + torch.arange(t, device=x.device),
                                backend)
            cache["k"][:, :, pos:pos + t] = k
            cache["v"][:, :, pos:pos + t] = v
            o = mha_ref(q, cache["k"], cache["v"], causal=True,
                        window=cfg.window, q_offset=pos, kv_len=pos + t)
            return self._out(o, backend), cache
        if mode == "decode":
            if t != 1:
                raise ValueError(f"decode takes one token a row, got {t}")
            q, k, v = self._qkv(x, pos[:, None], backend)
            rows = torch.arange(x.shape[0], device=x.device)
            w = cache["k"].shape[2]
            slot = pos % w if cfg.window else pos
            cache["k"][rows, :, slot] = k[:, :, 0]
            cache["v"][rows, :, slot] = v[:, :, 0]
            kv_len = torch.clamp(pos + 1, max=w) if cfg.window else pos + 1
            o = mha_ref(q, cache["k"], cache["v"], causal=False,
                        kv_len=kv_len)
            return self._out(o, backend), cache
        raise ValueError(f"unknown attention mode {mode!r}")

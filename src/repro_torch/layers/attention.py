"""Attention: GQA and MLA (DeepSeek-V3), in the train, prefill,
prefill_chunk and decode modes.

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
paging) refuse windowed configs.

MLA (``MLAttention``, ``cfg.mla``) caches the *compressed* KV: ``{"c_kv"
(B, max_len, kv_lora_rank), "k_rope" (B, max_len, qk_rope_dim)}``, no
head axis.  Train and prefill expand it to per-head K (nope + rope) and V
and run the flash kernel with q and k of ``qk_nope_dim + qk_rope_dim`` and
v of ``v_head_dim`` (192 and 128 at full width) under the explicit scale
``(nope + rope) ** -0.5``.  A prompt chunk and decode use the absorbed
form against the compressed cache (``wkv_b``'s K half folded into the
queries, its V half applied to the attended latents): plain PyTorch
einsums, as the reference's are outside any kernel; decode takes each
row's position, as GQA's does.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core import brgemm
from repro_torch.distributed.collectives import (copy_to_model,
                                                 gather_from_model,
                                                 reduce_from_model,
                                                 row_parallel)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, mha_ref
from repro_torch.layers.norms import RMSNorm
from repro_torch.layers.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int | None = None
    rope_theta: float = 10000.0
    window: int | None = None          # sliding-window size (None = full)
    # --- MLA (used when mla=True) ---
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def init_cache(cfg: AttnCfg, batch: int, max_len: int, *,
               dtype=torch.float32, device="cpu"):
    if cfg.mla:
        return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                      dtype=dtype, device=device)}
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
    """Weights ``wq, wk, wv`` (d_model, H*dh) and ``wo`` (Hq*dh, d_model).
    On a mesh's model axis (``tp``) a rank holds its heads' columns of
    ``wq``, ``wk``, ``wv`` and rows of ``wo`` (``cfg`` counts its own
    heads): the input's gradient and ``wo``'s partial outputs are summed
    over the axis (``distributed/collectives.py``).  Where the axis cuts
    within the KV heads (:meth:`split`: recurrentgemma's one KV head over
    two ranks) ``cfg`` keeps them whole and the rank holds a block of
    ``wk``'s and ``wv``'s columns: its blocks of K and V are all-gathered
    before RoPE, which pairs a head's columns by their place in it, and
    enter the rank's q heads through ``copy_to_model``, which sums the
    gradient each rank's heads give them."""
    tp = None     # a mesh's model axis (collectives.AxisGroup), else None
    kv_split = False    # wk's and wv's columns cut within the KV heads

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

    def split(self, tp) -> None:
        """Keep this rank's block of ``wk``'s and ``wv``'s columns on the
        model axis ``tp``, which cuts within the KV heads (new,
        uninitialised parameters); the q heads are the local config's
        already (train and prefill modes)."""
        cfg = self.cfg
        for name in ("wk", "wv"):
            like = getattr(self, name)
            setattr(self, name, nn.Parameter(torch.empty(
                cfg.d_model, cfg.n_kv_heads * cfg.dh // tp.size,
                dtype=like.dtype, device=like.device)))
        self.tp, self.kv_split = tp, True

    def _kv(self, x, w, backend):
        """K or V of ``w``'s heads, (B, Hkv, T, dh): gathered whole where
        the rank holds a block of a head's columns."""
        y = brgemm.matmul(x, w, backend=backend)
        if self.kv_split:
            y = copy_to_model(gather_from_model(y, self.tp, 2), self.tp)
        return _split_heads(y, self.cfg.n_kv_heads)

    def _qkv(self, x, positions, backend):
        cfg = self.cfg
        x = copy_to_model(x, self.tp)
        q = _split_heads(brgemm.matmul(x, self.wq, backend=backend),
                         cfg.n_heads)
        k = self._kv(x, self.wk, backend)
        v = self._kv(x, self.wv, backend)
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
        return q, k, v

    def _out(self, o, backend):
        with row_parallel(self.tp):
            y = brgemm.matmul(_merge_heads(o), self.wo, backend=backend)
        return reduce_from_model(y, self.tp)

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


class MLAttention(nn.Module):
    """Multi-head latent attention.  Weights (k, n): ``wq_a`` (D, q_lora),
    ``q_norm``, ``wq_b`` (q_lora, H * (nope + rope)), ``wkv_a`` (D, kv_lora
    + rope), ``kv_norm``, ``wkv_b`` (kv_lora, H * (nope + v)), ``wo`` (H *
    v, D).

    On a mesh's model axis (``tp``, after :meth:`split`; train and prefill
    modes) a rank holds the columns the rules give it: a block of
    ``wq_a``'s and ``wkv_a``'s, its heads' of ``wq_b`` and ``wkv_b``
    (head-major, so whole heads), and its heads' rows of ``wo``.
    ``q_norm`` and ``kv_norm`` take the whole low-rank outputs and every
    head reads ``k_rope``, so the rank's blocks of ``x @ wq_a`` and ``x @
    wkv_a`` are all-gathered over the axis (``gather_from_model``) and
    normed whole.  Gathering these activations, not the weights, keeps a
    rank's working copy its shard (the rules shard ``wq_a`` and
    ``wkv_a``), and moves B T (q_lora + kv_lora + rope) values a layer
    against the weights' D (q_lora + kv_lora + rope): less while a rank
    holds fewer than D tokens (7168 at full width).  The normed ``c_q``
    and ``c_kv`` and the roped ``k_rope`` enter the rank's heads through
    ``copy_to_model``: their gradients, partial on each rank, are summed
    there, so the norms' scales get their whole gradient on every rank
    (the rules replicate them) and the gather's backward keeps its slice
    of a whole one (the two make the reduce-scatter).  ``x``'s gradient is summed likewise and
    ``wo``'s partial outputs with ``reduce_from_model``.  A prompt chunk
    and decode on a model axis raise (ROADMAP queue 1, item 6.4)."""
    tp = None     # a mesh's model axis (collectives.AxisGroup), else None

    def __init__(self, cfg: AttnCfg, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.cfg = cfg
        h, qk = cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim

        def w(k, n):
            return nn.Parameter(torch.empty(k, n, dtype=dtype, device=device))

        self.wq_a = w(cfg.d_model, cfg.q_lora_rank)
        self.q_norm = RMSNorm(cfg.q_lora_rank, dtype=dtype, device=device)
        self.wq_b = w(cfg.q_lora_rank, h * qk)
        self.wkv_a = w(cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, dtype=dtype, device=device)
        self.wkv_b = w(cfg.kv_lora_rank,
                       h * (cfg.qk_nope_dim + cfg.v_head_dim))
        self.wo = w(h * cfg.v_head_dim, cfg.d_model)

    def split(self, tp) -> None:
        """Keep this rank's block of ``wq_a``'s and ``wkv_a``'s columns on
        the model axis ``tp`` (new, uninitialised parameters); the heads'
        weights are the local config's already."""
        cfg, m = self.cfg, tp.size
        for name, n in (("wq_a", cfg.q_lora_rank),
                        ("wkv_a", cfg.kv_lora_rank + cfg.qk_rope_dim)):
            like = getattr(self, name)
            setattr(self, name, nn.Parameter(torch.empty(
                cfg.d_model, n // m, dtype=like.dtype, device=like.device)))
        self.tp = tp

    @property
    def scale(self) -> float:
        return (self.cfg.qk_nope_dim + self.cfg.qk_rope_dim) ** -0.5

    def _q(self, x, positions, backend):
        """(q_nope, q_rope with RoPE), each (B, H, T, ...)."""
        cfg = self.cfg
        b, t, _ = x.shape
        cq = self.q_norm(gather_from_model(
            brgemm.matmul(x, self.wq_a, backend=backend), self.tp, -1))
        cq = copy_to_model(cq, self.tp)
        q = brgemm.matmul(cq, self.wq_b, backend=backend).reshape(
            b, t, cfg.n_heads, -1).transpose(1, 2)
        return q[..., :cfg.qk_nope_dim], apply_rope(
            q[..., cfg.qk_nope_dim:], positions, theta=cfg.rope_theta)

    def _compressed_kv(self, x, positions, backend):
        """(c_kv (B, T, kv_lora) normed, k_rope (B, T, rope) with RoPE)."""
        cfg = self.cfg
        full = gather_from_model(brgemm.matmul(x, self.wkv_a,
                                               backend=backend), self.tp, -1)
        c_kv = self.kv_norm(full[..., :cfg.kv_lora_rank])
        k_rope = apply_rope(full[..., cfg.kv_lora_rank:][:, None], positions,
                            theta=cfg.rope_theta)[:, 0]
        return c_kv, k_rope

    def _out(self, o, backend):
        with row_parallel(self.tp):
            y = brgemm.matmul(_merge_heads(o), self.wo, backend=backend)
        return reduce_from_model(y, self.tp)

    def _full(self, x, backend):
        """Train and prefill: the compressed KV expanded to per-head K and
        V, flash attention at head sizes (nope + rope, v)."""
        cfg = self.cfg
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device)
        x = copy_to_model(x, self.tp)
        q_nope, q_rope = self._q(x, positions, backend)
        c_kv, k_rope = self._compressed_kv(x, positions, backend)
        kv = brgemm.matmul(copy_to_model(c_kv, self.tp), self.wkv_b,
                           backend=backend).reshape(
            b, t, cfg.n_heads, -1).transpose(1, 2)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([kv[..., :cfg.qk_nope_dim],
                       copy_to_model(k_rope, self.tp)[:, None].expand(
                           b, cfg.n_heads, t, cfg.qk_rope_dim)], dim=-1)
        o = flash_attention(q, k, kv[..., cfg.qk_nope_dim:], causal=True,
                            scale=self.scale, backend=backend)
        return self._out(o, backend), c_kv, k_rope

    def _absorbed(self, q_nope, q_rope, cache, mask, dtype, backend):
        """Attention of the queries against the whole compressed cache
        under ``mask`` (broadcast to (B, H, Tq, S)), with ``wkv_b``
        absorbed: scores in fp32, probabilities in ``dtype``."""
        cfg = self.cfg
        wkv_b = self.wkv_b.reshape(cfg.kv_lora_rank, cfg.n_heads, -1)
        w_uk, w_uv = wkv_b[..., :cfg.qk_nope_dim], wkv_b[..., cfg.qk_nope_dim:]
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        q_eff = torch.einsum("bhqn,lhn->bhql", q_nope, w_uk)
        s = (torch.einsum("bhql,bsl->bhqs", q_eff.float(), c_kv.float())
             + torch.einsum("bhqr,bsr->bhqs", q_rope.float(), k_rope.float()))
        s = torch.where(mask, s * self.scale, NEG_INF)
        p = torch.softmax(s, dim=-1).to(dtype)
        o_c = torch.einsum("bhqs,bsl->bhql", p, c_kv)
        o = torch.einsum("bhql,lhv->bhqv", o_c, w_uv)
        return self._out(o, backend)

    def forward(self, x, *, mode: str = "train", cache=None, pos=0,
                backend: str | None = None):
        """As ``Attention.forward``: y for train, (y, cache) for the others,
        the cache ``{"c_kv", "k_rope"}`` written in place."""
        t = x.shape[1]
        if mode in ("train", "prefill"):
            y, c_kv, k_rope = self._full(x, backend)
            if mode == "train":
                return y
            cache["c_kv"][:, :t] = c_kv
            cache["k_rope"][:, :t] = k_rope
            return y, cache
        if self.tp is not None and self.tp.size > 1 and mode in (
                "prefill_chunk", "decode"):
            raise NotImplementedError(
                f"MLA's {mode} on a model axis is not ported (ROADMAP "
                f"queue 1, item 6.4)")
        if mode == "prefill_chunk":
            positions = pos + torch.arange(t, device=x.device)
            q_nope, q_rope = self._q(x, positions, backend)
            c_kv, k_rope = self._compressed_kv(x, positions, backend)
            cache["c_kv"][:, pos:pos + t] = c_kv
            cache["k_rope"][:, pos:pos + t] = k_rope
            s_pos = torch.arange(cache["c_kv"].shape[1], device=x.device)
            mask = s_pos[None, :] <= positions[:, None]           # causal
            return self._absorbed(q_nope, q_rope, cache, mask, x.dtype,
                                  backend), cache
        if mode == "decode":
            if t != 1:
                raise ValueError(f"decode takes one token a row, got {t}")
            q_nope, q_rope = self._q(x, pos[:, None], backend)
            c_kv, k_rope = self._compressed_kv(x, pos[:, None], backend)
            rows = torch.arange(x.shape[0], device=x.device)
            cache["c_kv"][rows, pos] = c_kv[:, 0]
            cache["k_rope"][rows, pos] = k_rope[:, 0]
            s_pos = torch.arange(cache["c_kv"].shape[1], device=x.device)
            mask = (s_pos[None, :] < (pos + 1)[:, None])[:, None, None]
            return self._absorbed(q_nope, q_rope, cache, mask, x.dtype,
                                  backend), cache
        raise ValueError(f"unknown attention mode {mode!r}")

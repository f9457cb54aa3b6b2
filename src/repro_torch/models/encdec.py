"""The encoder-decoder transformer (seamless-m4t's backbone), the port of
``repro/models/encdec.py``.

The encoder runs bidirectional self-attention blocks over stub frame
embeddings (``src_embeds`` (B, src_len, d_model): the audio frontend is a
stub, as in the reference); its self-attention takes no RoPE, so it runs
the projections and a non-causal flash call itself rather than
``Attention.forward``.  The decoder runs causal self-attention (with RoPE,
``Attention.forward`` in every mode), then cross-attention over the
encoder memory (no RoPE, no mask: the plain ``mha_ref`` where the queries
are one token, the flash kernel otherwise, as the reference splits it),
then a plain ReLU FFN.  The head is untied (``head.w`` (d_model, vocab)).

The serve cache is ``{"blocks": [a dict per decoder layer]}`` of the
self-attention's ``{"k", "v"}``, each (B, Hkv, max_len, dh), and the
cross-attention's ``{"cross.k", "cross.v"}``, each (B, Hkv, src_len, dh):
K and V of the memory, computed once by ``prefill`` (or the first chunk of
``prefill_chunk``) and written in place; later chunks and decode read
them from there.  Their size does not depend on ``max_len``, so a paged
pool keeps them slot-resident (``models/api.py``).  Dtypes follow the
reference: the embeddings are cast to ``cfg.dtype``, GEMMs return their
input dtype and the logits are fp32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchCfg
from repro_torch.core import brgemm
from repro_torch.core.dispatch import check_device
from repro_torch.distributed.collectives import copy_to_model
from repro_torch.layers import attention
from repro_torch.layers.embeddings import Embedding
from repro_torch.layers.mlp import MLP
from repro_torch.layers.norms import RMSNorm
from repro_torch.models import blocks
from repro_torch.models.transformer import Head, _xent, fill_params
from repro_torch.sharding.annotate import constrain

SELF_KEYS = ("k", "v")
CROSS_KEYS = ("cross.k", "cross.v")


def _mlp(cfg: ArchCfg, dt, device) -> MLP:
    return MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
               activation=cfg.mlp_activation, dtype=dt, device=device)


def _heads(x, w, n_heads, backend):
    return attention._split_heads(brgemm.matmul(x, w, backend=backend),
                                  n_heads)


def cross_kv(attn: attention.Attention, memory, backend=None):
    """(K, V) of the memory, each (B, Hkv, src_len, dh), no RoPE."""
    n = attn.cfg.n_kv_heads
    return (_heads(memory, attn.wk, n, backend),
            _heads(memory, attn.wv, n, backend))


def cross_apply(attn: attention.Attention, x, k, v, backend=None):
    """Cross-attention of ``x`` over (K, V): ``mha_ref`` for one query a
    row, the non-causal flash kernel otherwise."""
    q = _heads(x, attn.wq, attn.cfg.n_heads, backend)
    if x.shape[1] == 1:
        o = attention.mha_ref(q, k, v, causal=False)
    else:
        o = attention.flash_attention(q, k, v, causal=False, backend=backend)
    return attn._out(o, backend)


class EncoderBlock(nn.Module):
    """``x += attn(ln1(x))`` (bidirectional, no RoPE); ``x +=
    mlp(ln2(x))``."""

    def __init__(self, cfg: ArchCfg, *, device="cpu"):
        super().__init__()
        dt = blocks.dtype_of(cfg)
        self.ln1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.attn = attention.Attention(blocks.attn_cfg(cfg), dtype=dt,
                                        device=device)
        self.ln2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.mlp = _mlp(cfg, dt, device)

    def forward(self, x, *, backend=None):
        a = self.attn
        h = copy_to_model(self.ln1(x), a.tp)
        q = _heads(h, a.wq, a.cfg.n_heads, backend)
        k, v = cross_kv(a, h, backend)
        o = attention.flash_attention(q, k, v, causal=False, backend=backend)
        x = x + a._out(o, backend)
        return x + self.mlp(self.ln2(x), backend=backend)


class DecoderBlock(nn.Module):
    """``x += self_attn(ln1(x))`` (causal, RoPE); ``x += cross_attn(ln_x(x),
    memory)``; ``x += mlp(ln2(x))``."""

    def __init__(self, cfg: ArchCfg, *, device="cpu"):
        super().__init__()
        dt = blocks.dtype_of(cfg)
        acfg = blocks.attn_cfg(cfg)
        self.ln1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.self_attn = attention.Attention(acfg, dtype=dt, device=device)
        self.ln_x = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.cross_attn = attention.Attention(acfg, dtype=dt, device=device)
        self.ln2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.mlp = _mlp(cfg, dt, device)

    def forward(self, x, memory, *, mode="train", cache=None, pos=0,
                backend=None):
        """Train mode attends over ``memory``.  The others write their
        self-attention K and V into ``cache`` at ``pos``; with ``memory``
        given (prefill, a first chunk) they write the cross K and V of it
        into ``cache``, else (later chunks, decode) read them from
        there."""
        h = self.ln1(x)
        if mode == "train":
            x = x + self.self_attn(h, mode="train", backend=backend)
        else:
            y, _ = self.self_attn(h, mode=mode, cache=cache, pos=pos,
                                  backend=backend)
            x = x + y
        if memory is not None:
            k, v = cross_kv(self.cross_attn, memory, backend)
            if cache is not None:
                cache["cross.k"].copy_(k)
                cache["cross.v"].copy_(v)
        else:
            k, v = cache["cross.k"], cache["cross.v"]
        x = x + cross_apply(self.cross_attn, copy_to_model(
            self.ln_x(x), self.cross_attn.tp), k, v, backend)
        return x + self.mlp(self.ln2(x), backend=backend)


class EncDec(nn.Module):
    """Parameters of the encoder-decoder, uninitialised (``init_params``
    fills them from a generator, ``interop`` from the reference's tree):
    ``embed``, ``enc_blocks``, ``dec_blocks``, ``enc_ln``, ``final_ln``
    and, untied, ``head.w``.  ``device`` defaults to the card.

    On a mesh's model axis (``tp``, train mode: ``distributed/
    parallel.py``) each attention runs the rank's heads and each MLP its
    block of d_ff.  The encoder's and cross-attention's projections are
    run here, not by ``Attention.forward``, so their inputs (``ln1(x)``
    of an encoder block, ``ln_x(x)`` of a decoder block) and the memory
    enter them through ``copy_to_model``: the memory is whole on every
    rank after ``enc_ln``, and each rank's cross K and V give it a partial
    gradient, summed over the axis once for all the decoder's layers.
    The untied head gives the rank's block of the vocab's logits."""
    tp = None     # a mesh's model axis (collectives.AxisGroup), else None

    def __init__(self, cfg: ArchCfg, *, device="cuda"):
        super().__init__()
        blocks.check_ported(cfg)
        device = check_device(device)
        dt = blocks.dtype_of(cfg)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype=dt,
                               device=device)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(cfg, device=device)
            for _ in range(cfg.n_enc_layers))
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(cfg, device=device) for _ in range(cfg.n_layers))
        self.enc_ln = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.final_ln = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.head = (None if cfg.tie_embeddings else
                     Head(cfg.d_model, cfg.vocab, dtype=dt, device=device))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def encode(self, src_embeds, *, backend=None):
        """(B, src_len, d_model) frames -> the memory, ``enc_ln``-normed."""
        x = constrain(torch.as_tensor(src_embeds, device=self.device).to(
            blocks.dtype_of(self.cfg)), "activation")
        for block in self.enc_blocks:
            x = block(x, backend=backend)
        return self.enc_ln(x)

    def _head(self, h, backend):
        h = self.final_ln(h)
        if self.head is None:
            return self.embed.decode(h, backend=backend)
        return brgemm.matmul(copy_to_model(h, self.head.tp), self.head.w,
                             out_dtype=torch.float32, backend=backend)

    def logits_and_aux(self, tokens, *, src_embeds, backend=None):
        """Train forward of ``tokens`` over the frames ``src_embeds``:
        (fp32 logits (B, T, V), {})."""
        memory = copy_to_model(self.encode(src_embeds, backend=backend),
                               self.tp)
        x = self._decoder(tokens, memory, mode="train", cache=None, pos=0,
                          backend=backend)
        return self._head(x, backend), {}

    def _decoder(self, tokens, memory, *, mode, cache, pos, backend):
        x = constrain(self.embed.encode(tokens).to(
            blocks.dtype_of(self.cfg)), "activation")
        for i, block in enumerate(self.dec_blocks):
            x = block(x, memory, mode=mode,
                      cache=None if cache is None else cache["blocks"][i],
                      pos=pos, backend=backend)
        return x


def init_params(cfg: ArchCfg, generator: torch.Generator | None = None,
                device="cuda") -> EncDec:
    """Random weights with the reference's distributions (normal scaled by
    ``fan_in ** -0.5``, the norms' scales ones), drawn as
    ``transformer.init_params`` draws them."""
    return fill_params(EncDec(cfg, device=device), generator)


def _src(batch):
    if batch.get("src_embeds") is None:
        raise ValueError("request requires src_embeds for this architecture")
    return batch["src_embeds"]


def encode(params: EncDec, src_embeds, cfg: ArchCfg, *, backend=None):
    return params.encode(src_embeds, backend=backend)


def forward(params: EncDec, batch, cfg: ArchCfg, *, backend=None):
    """Train forward of ``{"src_embeds", "tokens"}``: (fp32 logits (B, T,
    V), {})."""
    return params.logits_and_aux(batch["tokens"], src_embeds=_src(batch),
                                 backend=backend)


def loss_fn(params: EncDec, batch, cfg: ArchCfg, *, backend=None):
    """Mean next-token cross-entropy over labels >= 0 (the reference's):
    ``(loss, {"loss", "ce_loss"})``."""
    logits, _ = forward(params, batch, cfg, backend=backend)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    loss = _xent(logits, labels.clamp_min(0).long(), mask)
    return loss, {"loss": loss, "ce_loss": loss}


def init_cache(cfg: ArchCfg, batch: int, max_len: int, src_len: int, *,
               device="cuda"):
    """``{"blocks": [a dict per decoder layer]}``: ``{"k", "v"}`` (B, Hkv,
    max_len, dh) and ``{"cross.k", "cross.v"}`` (B, Hkv, src_len, dh),
    zeros of ``cfg.dtype``."""
    device = check_device(device)
    acfg, dt = blocks.attn_cfg(cfg), blocks.dtype_of(cfg)
    shapes = {**dict.fromkeys(SELF_KEYS, max_len),
              **dict.fromkeys(CROSS_KEYS, src_len)}
    return {"blocks": [
        {key: torch.zeros(batch, acfg.n_kv_heads, t, acfg.dh, dtype=dt,
                          device=device) for key, t in shapes.items()}
        for _ in range(cfg.n_layers)]}


def prefill(params: EncDec, batch, cfg: ArchCfg, cache, *, backend=None,
            logit_pos=None):
    """Encodes ``src_embeds``, writes the cross K and V and the decoder
    prompt's self K and V into ``cache`` in place; returns (logits (B, V)
    at ``logit_pos``, default the last token, cache)."""
    memory = params.encode(_src(batch), backend=backend)
    x = params._decoder(batch["tokens"], memory, mode="prefill", cache=cache,
                        pos=0, backend=backend)
    idx = x.shape[1] - 1 if logit_pos is None else int(logit_pos)
    return params._head(x[:, idx:idx + 1], backend)[:, 0], cache


def prefill_chunk(params: EncDec, batch, cfg: ArchCfg, cache, pos, *,
                  length=None, first_chunk: bool = True, backend=None):
    """One decoder-prompt chunk at positions ``pos..pos+C-1``.  The first
    chunk encodes ``src_embeds`` and writes the cross K and V into
    ``cache``; later ones read them there and need no ``src_embeds``.
    ``length`` (<= C) marks the valid prefix of a right-padded chunk."""
    memory = (params.encode(_src(batch), backend=backend) if first_chunk
              else None)
    x = params._decoder(batch["tokens"], memory, mode="prefill_chunk",
                        cache=cache, pos=int(pos), backend=backend)
    idx = x.shape[1] - 1 if length is None else int(length) - 1
    return params._head(x[:, idx:idx + 1], backend)[:, 0], cache


def decode_step(params: EncDec, tokens, cfg: ArchCfg, cache, pos, *,
                backend=None, row_groups=False):
    """tokens: (B, 1); pos: an int, or a (B,) tensor of per-row positions
    (``row_groups`` is the decoder-only families' and changes nothing
    here).  Returns (logits (B, V), cache), the self K and V written in
    place."""
    if not (isinstance(pos, torch.Tensor) and pos.dim() == 1):
        pos = torch.full((tokens.shape[0],), int(pos), device=tokens.device)
    x = params._decoder(tokens, None, mode="decode", cache=cache, pos=pos,
                        backend=backend)
    return params._head(x, backend)[:, 0], cache

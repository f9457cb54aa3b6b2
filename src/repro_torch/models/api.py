"""Uniform model API, as in the reference: the decoder-only families
(dense, a VLM's patch prefix included: its prefill and train batches carry
``patch_embeds``, and ``token_len`` deducts the prefix from a shape's
sequence; moe; mla_moe; the recurrent xlstm and rglru_hybrid) run
``models/transformer.py``, the encoder-decoder (encdec) ``models/
encdec.py``, whose batches carry ``src_embeds`` (B, src_len, d_model).

Besides the reference's entry points (init, forward, loss, prefill,
prefill_chunk, decode_step) it holds the two decode steps of continuous
batching (``repro/models/api.py``):

  * ``decode_step_slots`` — one decode over a slot pool, each slot at its
    own position.  The reference ``vmap``s a batch-1 decode over the
    slots; here it is one batched ``decode_step`` with a (S,) tensor of
    positions (``layers/attention.py``), in which an MoE routes each slot
    as a group of its own, as the ``vmap`` does (``layers/moe.py``).
  * ``decode_step_paged`` — one decode over a paged pool: each slot's
    pages gathered into a contiguous view, the ordinary decode on the
    views, the result written back.  Optionally int8 pages with one fp32
    scale a page, for each stack of layers the reference's tree keeps
    (``scale_stacks``: MLA's dense and MoE layers apart).

The layouts are explicit, not discovered (the reference diffs abstract
cache shapes for its batch and time axes): the model's cache is
``{"blocks": [a dict per layer]}`` of the leaves ``cache_keys(cfg)``
names: GQA's ``{"k", "v"}``, each (B, Hkv, T, dh), or MLA's compressed
``{"c_kv" (B, T, kv_lora), "k_rope" (B, T, rope)}``, no head axis.  A
pool stacks the layers, each leaf (L, N, ...) with N slots of T = max_len
positions or N pages of T = page_size (the reference's stacked leaves,
batch axis 1, time axis the second to last; its mla_moe tree stacks the
dense and the MoE layers apart, the port's pool all L together), and
``layer_views`` hands the model per-layer views of it.  A recurrent
config's layers hold different leaves (``models/blocks.py``): its pool
stacks each by layer kind and leaf, ``"<kind>.<leaf>"`` (``cache_keys``,
``kv_shape``), over the layers of that kind, and ``layer_views`` /
``stack_layers`` take ``cfg`` to hand each layer its own (the reference
stacks its groups alike).  The encoder-decoder's layers hold the decoder's
self-attention ``{"k", "v"}`` and the cross-attention's ``{"cross.k",
"cross.v"}``, each (L, N, Hkv, src_len, dh) in a pool: K and V of the
encoder memory, whose size does not depend on ``max_len``.  They are
*slot-resident* (``resident_keys``): a paged pool keeps them by slot
beside its pages, as the reference's time axis -1 marks them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchCfg
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.core.quantize import quantize
from repro_torch.models import blocks, encdec, transformer

KEYS = ("k", "v")                 # GQA's cache leaves
MLA_KEYS = ("c_kv", "k_rope")     # MLA's compressed ones


def is_encdec(cfg: ArchCfg) -> bool:
    return cfg.block == "encdec"


def _module(cfg: ArchCfg):
    return encdec if is_encdec(cfg) else transformer


def cache_keys(cfg: ArchCfg) -> tuple[str, ...]:
    """A pool's leaves: GQA's or MLA's, a recurrent config's
    ``"<kind>.<leaf>"`` for each layer kind it runs (``mlstm.c``,
    ``slstm.h``, ``rec.conv``, ``attn.k``, ...), or the encoder-decoder's
    self and cross K and V."""
    if is_encdec(cfg):
        return encdec.SELF_KEYS + encdec.CROSS_KEYS
    if cfg.block in blocks.RECURRENT:
        kinds = dict.fromkeys(k for k, _, _ in blocks.recurrent_layout(cfg))
        return tuple(f"{kind}.{leaf}" for kind in kinds
                     for leaf in blocks.RECURRENT_BLOCKS[kind].leaves)
    return MLA_KEYS if cfg.mla else KEYS


def resident_keys(cfg: ArchCfg) -> tuple[str, ...]:
    """The leaves a paged pool keeps by slot, not in pages: the
    encoder-decoder's cross K and V."""
    return encdec.CROSS_KEYS if is_encdec(cfg) else ()


def encdec_src_len(cfg: ArchCfg, shape: ShapeCfg) -> int:
    """Encoder frames of an encoder-decoder's shape (the reference's)."""
    if shape.kind == "train":
        return shape.seq_len // 2
    return min(4096, shape.seq_len // 8)


def token_len(cfg: ArchCfg, shape: ShapeCfg) -> int:
    """Decoder-token length of the shape (a stub patch prefix, where a
    config has one, deducted in train and prefill; an encoder-decoder's
    frames likewise)."""
    if is_encdec(cfg):
        if shape.kind in ("train", "prefill"):
            return shape.seq_len - encdec_src_len(cfg, shape)
        return shape.seq_len
    if cfg.n_patches and shape.kind in ("train", "prefill"):
        return shape.seq_len - cfg.n_patches
    return shape.seq_len


def init_params(cfg: ArchCfg, generator: torch.Generator | None = None,
                device="cuda"):
    return _module(cfg).init_params(cfg, generator, device=device)


def init_cache(cfg: ArchCfg, batch: int, max_len: int, src_len: int = 0, *,
               device="cuda"):
    """The serve cache of either module (``src_len``: the encoder-decoder's
    memory length, unused by the others)."""
    if is_encdec(cfg):
        return encdec.init_cache(cfg, batch, max_len, src_len, device=device)
    return transformer.init_cache(cfg, batch, max_len, device=device)


def forward(params, batch, cfg: ArchCfg, **kw):
    return _module(cfg).forward(params, batch, cfg, **kw)


def loss_fn(params, batch, cfg: ArchCfg, **kw):
    return _module(cfg).loss_fn(params, batch, cfg, **kw)


def prefill(params, batch, cfg: ArchCfg, cache, **kw):
    return _module(cfg).prefill(params, batch, cfg, cache, **kw)


def decode_step(params, tokens, cfg: ArchCfg, cache, pos, **kw):
    return _module(cfg).decode_step(params, tokens, cfg, cache, pos, **kw)


def check_prompt_len(cfg: ArchCfg, t: int) -> None:
    """Raises where an xLSTM prefill of ``t`` tokens breaks mLSTM's chunk
    rule (the reference's ``mlstm_chunkwise``)."""
    transformer.check_prompt_len(cfg, t)


def prefill_chunk(params, batch, cfg: ArchCfg, cache, pos, *, length=None,
                  first_chunk: bool = True, **kw):
    """One chunk of a longer prompt against a batch-1 cache view.

    ``first_chunk`` is the encoder-decoder's only (it runs the encoder
    and caches the cross K and V); the decoder-only models ignore it."""
    if is_encdec(cfg):
        return encdec.prefill_chunk(params, batch, cfg, cache, pos,
                                    length=length, first_chunk=first_chunk,
                                    **kw)
    return transformer.prefill_chunk(params, batch, cfg, cache, pos,
                                     length=length, **kw)


# --------------------------------------------------------------------------
# pooled caches
# --------------------------------------------------------------------------

def _kind_layers(cfg: ArchCfg) -> list[tuple[str, int]]:
    """(kind, index among the layers of its kind) of each layer of a
    recurrent config, in run order."""
    seen: dict[str, int] = {}
    out = []
    for kind, _, _ in blocks.recurrent_layout(cfg):
        out.append((kind, seen.get(kind, 0)))
        seen[kind] = seen.get(kind, 0) + 1
    return out


def kv_shape(cfg: ArchCfg, n: int, length: int, key: str = "k",
             src_len: int = 0) -> tuple:
    """One stacked pool leaf: (L, n, Hkv, length, dh) of GQA's, (L, n,
    length, kv_lora or rope) of MLA's ``c_kv`` or ``k_rope``; a recurrent
    config's ``"<kind>.<leaf>"`` (layers of that kind, n, the leaf's shape
    a row); the encoder-decoder's ``cross.k`` / ``cross.v`` (L, n, Hkv,
    src_len, dh), whatever ``length``."""
    if key in resident_keys(cfg):
        length = src_len
    if cfg.block in blocks.RECURRENT:
        kind, leaf = key.split(".")
        count = sum(k == kind for k, _ in _kind_layers(cfg))
        one = blocks.RECURRENT_BLOCKS[kind].init_cache(cfg, n, length,
                                                       device="meta")
        return (count, *one[leaf].shape)
    if cfg.mla:
        return (cfg.n_layers, n, length,
                cfg.kv_lora_rank if key == "c_kv" else cfg.qk_rope_dim)
    return (cfg.n_layers, n, cfg.n_kv_heads, length, blocks.attn_cfg(cfg).dh)


def layer_views(leaves, cfg: ArchCfg | None = None) -> dict:
    """The model's cache as per-layer views of stacked leaves (L, B, ...):
    a write through the model lands in them.  A recurrent config's leaves
    are stacked by kind (``cache_keys``): pass ``cfg``, and each layer
    gets the views of its kind's leaves at its index among them."""
    if cfg is not None and cfg.block in blocks.RECURRENT:
        return {"blocks": [
            {key.split(".")[1]: leaf[i] for key, leaf in leaves.items()
             if key.split(".")[0] == kind}
            for kind, i in _kind_layers(cfg)]}
    n_layers = next(iter(leaves.values())).shape[0]
    return {"blocks": [{key: leaf[i] for key, leaf in leaves.items()}
                       for i in range(n_layers)]}


def stack_layers(cache, cfg: ArchCfg | None = None) -> dict:
    """The model's cache as stacked leaves (L, B, ...) (a copy); a
    recurrent config's (``cfg`` given) by kind, as ``layer_views``
    takes them."""
    if cfg is not None and cfg.block in blocks.RECURRENT:
        layers = list(zip(_kind_layers(cfg), cache["blocks"]))
        return {key: torch.stack([c[key.split(".")[1]]
                                  for (kind, _), c in layers
                                  if kind == key.split(".")[0]])
                for key in cache_keys(cfg)}
    return {key: torch.stack([b[key] for b in cache["blocks"]])
            for key in cache["blocks"][0]}


def decode_step_slots(params, tokens, cfg: ArchCfg, cache, positions,
                      **kw):
    """One decode step over a slot pool with per-slot positions.

    ``tokens``: (S, 1) — the last sampled token a slot; ``positions``: (S,)
    — the absolute position each slot's token is written at; ``cache``: the
    pool (batch = S), written in place, each slot's K and V in its own
    row.  Returns (logits (S, V), cache).  Free slots decode garbage that
    lands in their own rows, where a later prefill overwrites it before
    any mask exposes it; an MoE routes each slot as a group of its own,
    so that garbage competes with no slot for capacity.  A recurrent
    config's states step each row alone (only its ring layers read the
    positions); a free slot's garbage state is overwritten whole when a
    request is admitted there (``SlotKVCache.insert``).
    """
    positions = torch.as_tensor(positions, device=tokens.device,
                                dtype=torch.long)
    return decode_step(params, tokens, cfg, cache, positions,
                       row_groups=True, **kw)


# --------------------------------------------------------------------------
# paged decode (page-gather as batch-reduce over page lists)
# --------------------------------------------------------------------------

def supports_paging(cfg: ArchCfg) -> bool:
    """Whether the serve cache can be paged (the reference's rule).

    Paging needs every growing cache leaf to be a position-indexed KV
    tensor whose reads are masked by ``kv_len``: full-attention decoders
    and the enc-dec decoder.  Sliding-window ring buffers index ``pos %
    window`` (a page holds no stable position range), recurrent states
    have no time axis, and a VLM prefix is not paged.
    """
    return (cfg.block in ("dense", "moe", "mla_moe", "encdec")
            and not cfg.window and not cfg.n_patches)


def pages_to_view(pages):
    """(N, P, Hkv, page_size, dh) pages -> (N, Hkv, P * page_size, dh),
    the contiguous cache view of each of N page lists.  MLA's leaves have
    no head axis: (N, P, page_size, c) -> (N, P * page_size, c)."""
    if pages.dim() == 4:
        n, n_pages, ps, c = pages.shape
        return pages.reshape(n, n_pages * ps, c)
    n, n_pages, h, ps, dh = pages.shape
    return pages.transpose(1, 2).reshape(n, h, n_pages * ps, dh)


def view_to_pages(view, page_size: int):
    """Inverse of :func:`pages_to_view`: (N, Hkv, T, dh) -> (N, T /
    page_size, Hkv, page_size, dh), or MLA's (N, T, c) -> (N, T /
    page_size, page_size, c)."""
    if view.dim() == 3:
        n, t, c = view.shape
        return view.reshape(n, t // page_size, page_size, c)
    n, h, t, dh = view.shape
    return view.reshape(n, h, t // page_size, page_size,
                        dh).transpose(1, 2)


def scale_stacks(cfg: ArchCfg, key: str):
    """The per-page scale arrays of the paged leaf ``key`` under int8
    pages: ``(scale key, first layer, end layer)`` each.  One scale a page
    covers every layer of one of the reference's stacked leaves: all L
    layers, named ``key``, but for ``mla_moe``, whose reference tree
    stacks its ``n_dense_layers`` dense blocks and its MoE blocks apart
    (``"dense_blocks.c_kv"``, ``"moe_blocks.c_kv"``, ...), where the
    port's pool stacks all L together."""
    n = cfg.n_layers
    if cfg.block != "mla_moe":
        return ((key, 0, n),)
    nd = cfg.n_dense_layers
    return tuple((f"{stack}.{key}", lo, hi) for stack, lo, hi in (
        ("dense_blocks", 0, nd), ("moe_blocks", nd, n)) if hi > lo)


def _dequant_pages(pages, scales, stacks, ids, dtype):
    """int8 pages (L, S, P, ...) times their stack's per-page scale
    (``scales[scale key][ids]``, (S, P)) -> ``dtype``."""
    per_layer = torch.cat([scales[skey][ids].expand(hi - lo, *ids.shape)
                           for skey, lo, hi in stacks])       # (L, S, P)
    trail = (1,) * (pages.dim() - per_layer.dim())
    return (pages.float() * per_layer.reshape(*per_layer.shape, *trail)
            ).to(dtype)


def _quant_pages(pages, stacks):
    """Per-page absmax int8 of (L, P, ...) pages: one scale a page and a
    stack (over its layers and every other axis, as the reference's
    stacked leaf gives).  Returns (q, {scale key: (P,) fp32 scales})."""
    axes = tuple(i for i in range(pages.dim()) if i != 1)
    qs, scales = [], {}
    for skey, lo, hi in stacks:
        q, scales[skey] = quantize(pages[lo:hi], "int8", axis=axes)
        qs.append(q)
    return (qs[0] if len(qs) == 1 else torch.cat(qs)), scales


def decode_step_paged(params, tokens, cfg: ArchCfg, data, page_tables,
                      positions, *, page_size: int, scales=None,
                      view_dtype=None, **kw):
    """One decode step over a paged pool.

    ``data``: ``{"k", "v"}``, each (L, n_pages, Hkv, page_size, dh), or
    MLA's ``{"c_kv", "k_rope"}``, each (L, n_pages, page_size, c); the
    encoder-decoder's slot-resident ``{"cross.k", "cross.v"}`` (L, S,
    Hkv, src_len, dh) beside them (``resident_keys``), handed to the
    decode as they are: never paged, quantized or written.
    ``page_tables``: (S, P) page ids, the sentinel ``n_pages`` past each
    slot's allocation; ``positions``: (S,) the position each slot's token
    is written at.  Both are host integer arrays: the writes' masks are
    made on the host, so no write waits on the card.  ``scales``: with int8
    pages, (n_pages,) fp32 per-page scales keyed as ``scale_stacks`` says
    (``{"k", "v"}``; MLA's by stack and key), and ``view_dtype`` the dtype
    the pages are dequantized to.

    Each slot's pages are gathered (sentinels clipped to the last page:
    garbage that the ``kv_len`` mask never exposes) into a contiguous
    view of ``P * page_size`` positions, dequantized with int8 pages, and
    the ordinary decode runs on the views (an MoE routing each slot as a
    group of its own, as the reference's ``vmap`` does).  Then, as the
    reference's
    scatter with ``mode="drop"`` does, only real page ids are written:
    full-precision pages take the new token's K and V at its position
    (every other position of a view is the page it was gathered from);
    int8 pages are all quantized again from the views, with fresh scales,
    as the reference re-quantizes every page of a slot each step.
    Returns (logits (S, V), data, scales), the pool written in place.
    """
    resident = resident_keys(cfg)
    keys = tuple(k for k in data if k not in resident)
    n_layers, n_pages = data[keys[0]].shape[:2]
    dev = tokens.device
    view_dtype = view_dtype or blocks.dtype_of(cfg)
    pt = np.asarray(page_tables, np.int64)
    pos = np.asarray(positions, np.int64)
    ids = torch.as_tensor(np.minimum(pt, n_pages - 1), device=dev)
    views = {key: data[key] for key in resident}
    for key in keys:
        pages = data[key][:, ids]                 # (L, S, P, Hkv, ps, dh)
        if scales is not None:
            pages = _dequant_pages(pages, scales, scale_stacks(cfg, key),
                                   ids, view_dtype)
        views[key] = pages_to_view(pages.flatten(0, 1)).unflatten(
            0, (n_layers, len(pos)))              # (L, S, Hkv, T, dh)
    logits, _ = decode_step(params, tokens, cfg, layer_views(views),
                            torch.as_tensor(pos, device=dev),
                            row_groups=True, **kw)
    if scales is None:
        rows = np.arange(len(pos))
        page = pt[rows, pos // page_size]
        live = np.nonzero(page < n_pages)[0]
        at = torch.as_tensor(pos[live], device=dev)
        dst = torch.as_tensor(page[live], device=dev)
        off = torch.as_tensor(pos[live] % page_size, device=dev)
        src = torch.as_tensor(live, device=dev)
        for key in keys:
            data[key][:, dst, ..., off, :] = views[key][:, src, ..., at, :]
        return logits, data, scales
    flat = pt.reshape(-1)
    live = np.nonzero(flat < n_pages)[0]
    src = torch.as_tensor(live, device=dev)
    dst = torch.as_tensor(flat[live], device=dev)
    for key in keys:
        pages = view_to_pages(views[key].flatten(0, 1), page_size)
        pages = pages.reshape(n_layers, -1, *pages.shape[2:])
        q, sc = _quant_pages(pages[:, src], scale_stacks(cfg, key))
        data[key][:, dst] = q
        for skey, page_scales in sc.items():
            scales[skey][dst] = page_scales
    return logits, data, scales

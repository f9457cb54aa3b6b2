"""The decoder-only LM: init, forward, loss, prefill, prefill_chunk and
decode_step, for the dense, moe, mla_moe and recurrent (xlstm,
rglru_hybrid) families.  The head is the tied
embedding table or, where ``cfg.tie_embeddings`` is false, its own
``head.w`` (d_model, vocab).
A VLM config (``cfg.n_patches``, llava-next-34b) has a ``vision_proj``:
its batches carry ``patch_embeds`` (B, n_patches, d_model), projected by
``gelu(v @ w1 + b1) @ w2 + b2`` (two ``matmul`` calls, the first with its
bias and GELU in the kernel's epilogue, as the reference's) and prepended
to the tokens' embeddings; the train forward drops the patch rows before
the head, and prefill's logits are the last token's, past the prefix.
With ``cfg.remat`` the train forward runs each decoder block under
``torch.utils.checkpoint`` (the reference checkpoints each layer of its
scan): its activations are recomputed in the backward, which changes
memory and not one bit of the result.

The moe family (grok-1) stacks MoE blocks as dense stacks MLP blocks;
mla_moe (DeepSeek-V3) runs ``n_dense_layers`` dense MLA blocks, then MoE
MLA blocks, and holds an MTP block (``mtp_block``, a dense block whose
head predicts the token two steps ahead, train only).  The train forward
sums the MoE blocks' aux losses and ``loss_fn`` adds them, and the MTP
loss, with the reference's weights; serving computes the aux and drops
it.  ``decode_step(row_groups=True)`` routes each row as a group of its
own (``layers/moe.py``).

The recurrent families (xlstm-1.3b, recurrentgemma-9b) run their layers
in the reference's stack order (``blocks.recurrent_layout``: a group's
mLSTMs then its sLSTM; a group's rec blocks then its attention block,
then the trailing rec blocks).  Their serve cache holds each layer's
state at the reference's initial values (``init_cache``), read as the
initial state by prefill and decode and overwritten in place; train mode
starts every layer from the initial state, as the reference's
``_train_states``.  ``prefill_chunk`` raises for them, and an xLSTM
prefill raises where T breaks mLSTM's chunk rule (``check_prompt_len``).

The reference scans one traced block over layer parameters stacked on a
leading axis; here the layers are an ``nn.ModuleList`` run by a Python
loop, and the serve cache is a list with one dict per layer, ``{"k",
"v"}`` or MLA's ``{"c_kv", "k_rope"}`` (``interop.py`` maps the stacked
layouts across: the reference's ``blocks``, or its ``dense_blocks`` then
``moe_blocks``, are the port's ``blocks.0 ..``).  Dtypes follow the
reference step by step: the embedding is cast to ``cfg.dtype``, every GEMM
returns its input dtype, the residual adds stay in that dtype, and the
logits are fp32.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.configs.base import ArchCfg
from repro_torch.core import brgemm, dispatch
from repro_torch.core.dispatch import check_device
from repro_torch.distributed import collectives
from repro_torch.layers import recurrent
from repro_torch.layers.embeddings import Embedding
from repro_torch.layers.norms import RMSNorm
from repro_torch.models import blocks
from repro_torch.sharding.annotate import constrain

ZERO_AUX = blocks.ZERO_AUX
MTP_WEIGHT = 0.3
LB_WEIGHT = 0.01
Z_WEIGHT = 1e-4


def _acc(a, b):
    return {k: a[k] + b[k] for k in a}


class Head(nn.Module):
    """The untied output head: ``w`` (d_model, vocab).  ``tp``: the model
    axis of a mesh whose ranks each hold a block of the vocab's columns
    (``distributed/parallel.py``), else None."""
    tp = None

    def __init__(self, d: int, vocab: int, *, dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d, vocab, dtype=dtype,
                                          device=device))


class VisionProj(nn.Module):
    """The patch projection: ``w1``, ``w2`` (d, d), ``b1``, ``b2`` (d,).

    On a mesh's model axis (``tp``, after :meth:`split`) a rank holds a
    block of ``w1``'s and ``w2``'s columns (the rules take both for
    column-parallel) and ``b1`` and ``b2`` whole (they replicate them).
    It computes its block of ``gelu(v @ w1 + b1)``, all-gathers it over the
    axis (``gather_from_model``) into ``w2``'s input, whose gradient,
    partial on each rank, ``copy_to_model`` sums, and all-gathers its
    block of the output before the concatenation with the tokens.  A rank
    adds its block of each bias, read through ``copy_to_model``: the
    gradient of ``b1`` and ``b2``, nonzero on a rank only in its block, is
    summed whole over the axis."""
    tp = None     # a mesh's model axis (collectives.AxisGroup), else None

    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        for name, shape in (("w1", (d, d)), ("b1", (d,)), ("w2", (d, d)),
                            ("b2", (d,))):
            setattr(self, name, nn.Parameter(torch.empty(
                shape, dtype=dtype, device=device)))

    def split(self, tp) -> None:
        """Keep this rank's block of ``w1``'s and ``w2``'s columns on the
        model axis ``tp`` (new, uninitialised parameters)."""
        for name in ("w1", "w2"):
            like = getattr(self, name)
            d = like.shape[0]
            setattr(self, name, nn.Parameter(torch.empty(
                d, d // tp.size, dtype=like.dtype, device=like.device)))
        self.tp = tp

    def _bias(self, b):
        tp = self.tp
        if tp is None or tp.size == 1:
            return b
        n = b.shape[0] // tp.size
        return collectives.copy_to_model(b, tp).narrow(0, tp.index * n, n)

    def forward(self, v, *, backend=None):
        tp = self.tp
        v = brgemm.matmul(v, self.w1, self._bias(self.b1), activation="gelu",
                          backend=backend)
        v = collectives.copy_to_model(
            collectives.gather_from_model(v, tp, -1), tp)
        return collectives.gather_from_model(
            brgemm.matmul(v, self.w2, self._bias(self.b2), backend=backend),
            tp, -1)


class Transformer(nn.Module):
    """Parameters of a decoder LM, uninitialised (``init_params`` fills
    them from a generator, ``interop`` from the reference's tree).
    ``device`` defaults to the card."""

    def __init__(self, cfg: ArchCfg, *, device="cuda"):
        super().__init__()
        blocks.check_ported(cfg)
        if cfg.block == "encdec":
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             f"with models/encdec.py (api.init_params)")
        device = check_device(device)
        dt = blocks.dtype_of(cfg)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype=dt,
                               device=device)
        self.final_ln = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.head = (None if cfg.tie_embeddings else
                     Head(cfg.d_model, cfg.vocab, dtype=dt, device=device))
        if cfg.block in blocks.RECURRENT:
            self.blocks = nn.ModuleList(
                blocks.RECURRENT_BLOCKS[kind](cfg, device=device)
                for kind, _, _ in blocks.recurrent_layout(cfg))
        else:
            n_dense = {"dense": cfg.n_layers, "moe": 0,
                       "mla_moe": cfg.n_dense_layers}[cfg.block]
            self.blocks = nn.ModuleList(
                blocks.DecoderBlock(cfg, use_moe=i >= n_dense, device=device)
                for i in range(cfg.n_layers))
        self.mtp_block = (blocks.DecoderBlock(cfg, device=device)
                          if cfg.block == "mla_moe" and cfg.mtp else None)
        self.vision_proj = (VisionProj(cfg.d_model, dtype=dt, device=device)
                            if cfg.n_patches else None)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _embed_tokens(self, tokens):
        return self.embed.encode(tokens).to(blocks.dtype_of(self.cfg))

    def _embed(self, tokens, patch_embeds=None, backend=None):
        """The tokens' embeddings, a VLM's projected patches before them."""
        dt = blocks.dtype_of(self.cfg)
        h = self._embed_tokens(tokens)
        if self.vision_proj is None:
            return constrain(h, "activation")
        if patch_embeds is None:
            raise ValueError(f"{self.cfg.name}: the batch needs "
                             f"patch_embeds (B, {self.cfg.n_patches}, "
                             f"{self.cfg.d_model})")
        v = self.vision_proj(torch.as_tensor(patch_embeds, device=h.device)
                             .to(dt), backend=backend)
        return constrain(torch.cat([v, h], dim=1), "activation")

    def _head(self, h, backend):
        h = self.final_ln(h)
        if self.head is None:
            return constrain(self.embed.decode(h, backend=backend), "logits")
        h = collectives.copy_to_model(h, self.head.tp)
        return constrain(brgemm.matmul(h, self.head.w,
                                       out_dtype=torch.float32,
                                       backend=backend), "logits")

    def _run(self, h, *, mode, cache, pos, backend, remat=False,
             row_groups=False):
        """(h, the blocks' aux losses summed: train mode only, else
        ZERO_AUX)."""
        remat = remat and mode == "train" and torch.is_grad_enabled()
        aux = ZERO_AUX
        for i, block in enumerate(self.blocks):
            layer_cache = None if cache is None else cache["blocks"][i]
            if remat:
                h, a = _checkpointed(block, h, backend)
            else:
                h, _, a = block(h, mode=mode, cache=layer_cache, pos=pos,
                                row_groups=row_groups, backend=backend)
            if mode == "train" and a is not ZERO_AUX:
                aux = _acc(aux, a)
        return h, aux

    def forward(self, tokens, *, backend: str | None = None,
                patch_embeds=None, remat: bool | None = None):
        """Train-mode forward: (B, T) tokens -> fp32 logits (B, T, V) (the
        patch rows of a VLM dropped before the head).  ``remat`` (default
        ``cfg.remat``) checkpoints each block."""
        return self.logits_and_aux(tokens, backend=backend,
                                   patch_embeds=patch_embeds, remat=remat)[0]

    def logits_and_aux(self, tokens, *, backend: str | None = None,
                       patch_embeds=None, remat: bool | None = None):
        """``forward``'s logits and the aux: the MoE blocks' losses summed,
        and with an MTP block its fp32 logits (``mtp_logits``)."""
        remat = self.cfg.remat if remat is None else remat
        h, aux = self._run(self._embed(tokens, patch_embeds, backend),
                           mode="train", cache=None, pos=0, backend=backend,
                           remat=remat)
        if self.cfg.n_patches:
            h = h[:, self.cfg.n_patches:]
        aux = dict(aux)
        if self.mtp_block is not None:
            h2, _, _ = self.mtp_block(h, mode="train", backend=backend)
            aux["mtp_logits"] = self._head(h2, backend)
        return self._head(h, backend), aux

    def prefill(self, tokens, cache, *, backend: str | None = None,
                logit_pos: int | None = None, patch_embeds=None):
        """Fills ``cache`` in place; returns (logits (B, V), cache).

        The logits are the last position's, or ``logit_pos``'s (an index
        into the sequence, a VLM's patch prefix included): bucketed
        prefill right-pads a prompt, and its true last token sits before
        the pad."""
        check_prompt_len(self.cfg, tokens.shape[1])
        h, _ = self._run(self._embed(tokens, patch_embeds, backend),
                         mode="prefill", cache=cache, pos=0, backend=backend)
        idx = h.shape[1] - 1 if logit_pos is None else int(logit_pos)
        return self._head(h[:, idx:idx + 1], backend)[:, 0], cache

    def prefill_chunk(self, tokens, cache, pos: int, *,
                      length: int | None = None,
                      backend: str | None = None, patch_embeds=None):
        """One chunk of a longer prompt, tokens at positions ``pos ..
        pos+C-1``: it attends causally to everything already written into
        ``cache`` (earlier chunks) and itself, and appends its K and V at
        ``pos``, in place.  ``length`` (<= C) marks the valid prefix of a
        right-padded chunk, whose logits are returned (the last token's by
        default).  Chaining chunks reproduces one-shot ``prefill``.  The
        recurrent families raise, as the reference's engine refuses them
        chunks."""
        if self.cfg.block in blocks.RECURRENT:
            raise ValueError(
                f"chunked prefill is not supported for block="
                f"{self.cfg.block!r} (recurrent state has no position "
                f"range)")
        h, _ = self._run(self._embed(tokens, patch_embeds, backend),
                         mode="prefill_chunk", cache=cache, pos=int(pos),
                         backend=backend)
        idx = h.shape[1] - 1 if length is None else int(length) - 1
        return self._head(h[:, idx:idx + 1], backend)[:, 0], cache

    def decode_step(self, tokens, cache, pos, *,
                    backend: str | None = None, row_groups: bool = False):
        """tokens: (B, 1), row b at position ``pos[b]`` (a (B,) tensor).
        Returns (logits (B, V), cache), the cache written in place.
        ``row_groups``: MoE routes each row as a group of its own."""
        h, _ = self._run(constrain(self._embed_tokens(tokens), "activation"),
                         mode="decode",
                         cache=cache, pos=pos, backend=backend,
                         row_groups=row_groups)
        return self._head(h, backend)[:, 0], cache


def _checkpointed(block, h, backend):
    """A train-mode block under ``torch.utils.checkpoint``: its forward is
    rerun in the backward, in the dispatch state of the forward (autograd
    may rerun it on a thread of its own).  Returns (h, aux)."""
    state = dispatch.snapshot()
    return checkpoint.checkpoint(
        lambda x: block(x, mode="train", backend=backend)[::2], h,
        use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            dispatch.restored(state)))


_ZERO_BIASES = ("vision_proj.b1", "vision_proj.b2", "rglru.b_rgate",
                "rglru.b_igate", "mlstm.bi")


def _recurrent_init(name: str, p, generator) -> bool:
    """The recurrent layers' leaves that are not fan-in scaled normals, as
    the reference's inits draw them: RG-LRU's ``lam`` = log(u / (1 - u)),
    u uniform in [0.9, 0.999] (so that a = sigmoid(lam) lies there), its
    ``conv_w`` normal scaled by ``d_rnn ** -0.5``; mLSTM's forget bias
    ``bf`` 3.0; sLSTM's ``b`` zeros but its forget gate's quarter, 3.0.
    Returns whether ``p`` was one of them (and is now filled)."""
    if name.endswith("rglru.lam"):
        u = 0.9 + 0.099 * torch.rand(p.shape, generator=generator,
                                     device=generator.device)
        p.copy_(torch.log(u / (1 - u)))
    elif name.endswith("rglru.conv_w"):
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=generator.device) * p.shape[1] ** -0.5)
    elif name.endswith("mlstm.bf"):
        p.fill_(3.0)
    elif name.endswith("slstm.b"):
        d = p.shape[0] // 4
        p.zero_()
        p[2 * d:3 * d] = 3.0
    else:
        return False
    return True


def init_params(cfg: ArchCfg, generator: torch.Generator | None = None,
                device="cuda") -> Transformer:
    """Random weights with the reference's distributions: each weight is
    normal scaled by ``fan_in ** -0.5`` (its second-to-last dimension: an
    expert weight's (E, k, n) and sLSTM's per-head (H, dh, 4 dh) too; the
    embedding table by ``d_model ** -0.5``), each norm scale ones, the
    biases zeros (a VLM projection's, the RG-LRU gates', mLSTM's input
    gate's), and the recurrent layers' own leaves as ``_recurrent_init``
    draws them.  Draws come from ``generator`` (default: a CPU generator
    seeded 0), in fp32, then are cast to ``cfg.dtype``."""
    return fill_params(Transformer(cfg, device=device), generator)


def fill_params(model: nn.Module, generator: torch.Generator | None = None):
    """``model``'s parameters drawn in place as ``init_params`` says (the
    encoder-decoder's too); returns ``model``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            if name.endswith(_ZERO_BIASES):
                p.zero_()
                continue
            if _recurrent_init(name, p, generator):
                continue
            fan_in = p.shape[1] if name == "embed.table" else p.shape[-2]
            draw = torch.randn(p.shape, generator=generator,
                               device=generator.device)
            p.copy_(draw.mul_(fan_in ** -0.5))     # one fp32 copy, not two
    return model


def init_cache(cfg: ArchCfg, batch: int, max_len: int, *, device="cuda"):
    """``{"blocks": [a dict per layer]}``: ``{"k", "v"}``, each (B, Hkv,
    max_len, dh), or MLA's ``{"c_kv" (B, max_len, kv_lora), "k_rope" (B,
    max_len, rope)}``; a recurrent layer's state at the reference's
    initial values (``models/blocks.py``: mLSTM's ``{"c", "n", "m"}``,
    sLSTM's ``{"h", "c", "n", "m"}``, RG-LRU's ``{"h", "conv"}``) and a
    local attention layer's ring ``{"k", "v"}`` of ``min(max_len,
    window)`` positions."""
    device = check_device(device)
    if cfg.block in blocks.RECURRENT:
        return {"blocks": [
            blocks.RECURRENT_BLOCKS[kind].init_cache(cfg, batch, max_len,
                                                     device=device)
            for kind, _, _ in blocks.recurrent_layout(cfg)]}
    return {"blocks": [
        blocks.decoder_block_cache(cfg, batch, max_len, device=device)
        for _ in range(cfg.n_layers)]}


def check_prompt_len(cfg: ArchCfg, t: int) -> None:
    """Raises where a prefill of ``t`` tokens breaks mLSTM's chunk rule
    (``layers/recurrent.py::chunk_len``): xlstm only."""
    if cfg.block == "xlstm" and t > 1:
        recurrent.chunk_len(cfg.mlstm_chunk, t)


def forward(params: Transformer, batch, cfg: ArchCfg, *, backend=None):
    """Train-mode forward, ``cfg.remat`` deciding the checkpointing.
    Returns (fp32 logits, aux)."""
    return params.logits_and_aux(batch["tokens"], backend=backend,
                                 patch_embeds=batch.get("patch_embeds"),
                                 remat=cfg.remat)


def _xent(logits, labels, mask):
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(params: Transformer, batch, cfg: ArchCfg, *, backend=None):
    """Mean next-token cross-entropy over labels >= 0, from fp32 logits.

    Labels < 0 are masked out (and clamped to 0 for the gather), as in the
    reference.  With an MTP block, ``MTP_WEIGHT`` times its cross-entropy
    against the labels one step further on; in the MoE families,
    ``LB_WEIGHT`` times the load-balance loss and ``Z_WEIGHT`` times the
    router z-loss.  Returns ``(loss, {"ce_loss", ["mtp_loss",]
    ["load_balance_loss",] "loss"})``.
    """
    logits, aux = forward(params, batch, cfg, backend=backend)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels = labels.clamp_min(0).long()
    loss = _xent(logits, labels, mask)
    metrics = {"ce_loss": loss}
    if "mtp_logits" in aux:
        mtp_loss = _xent(aux["mtp_logits"][:, :-1], labels[:, 1:],
                         mask[:, 1:])
        loss = loss + MTP_WEIGHT * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    if cfg.block in ("moe", "mla_moe"):
        loss = (loss + LB_WEIGHT * aux["load_balance_loss"]
                + Z_WEIGHT * aux["router_z_loss"])
        metrics["load_balance_loss"] = aux["load_balance_loss"]
    metrics["loss"] = loss
    return loss, metrics


def prefill(params: Transformer, batch, cfg: ArchCfg, cache, *,
            backend=None, logit_pos=None):
    """Returns (logits at ``logit_pos``, default the last token, cache)."""
    return params.prefill(batch["tokens"], cache, backend=backend,
                          logit_pos=logit_pos,
                          patch_embeds=batch.get("patch_embeds"))


def prefill_chunk(params: Transformer, batch, cfg: ArchCfg, cache, pos, *,
                  length=None, backend=None):
    """One chunk of a longer prompt at positions ``pos..pos+C-1``; returns
    (logits (B, V), cache)."""
    return params.prefill_chunk(batch["tokens"], cache, pos, length=length,
                                backend=backend,
                                patch_embeds=batch.get("patch_embeds"))


def decode_step(params: Transformer, tokens, cfg: ArchCfg, cache, pos, *,
                backend=None, row_groups=False):
    """tokens: (B, 1); pos: an int, or a (B,) tensor of per-row positions.
    ``row_groups``: MoE routes each row as a group of its own, as a slot
    pool's decode does.  Returns (logits (B, V), cache)."""
    if not (isinstance(pos, torch.Tensor) and pos.dim() == 1):
        pos = torch.full((tokens.shape[0],), int(pos),
                         device=tokens.device)
    return params.decode_step(tokens, cache, pos, backend=backend,
                              row_groups=row_groups)

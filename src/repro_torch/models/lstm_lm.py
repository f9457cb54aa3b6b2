"""GNMT-style stacked-LSTM language model (the paper's Sec. 4.2.1 workload).

As the reference's ``repro/models/lstm_lm.py``: an embedding, ``n_layers``
LSTMs of width ``d_model`` in a residual stack (``h = h + lstm(h)``, run in
(T, B, D)), and the tied decode through ``matmul``; every GEMM inside the
cells is the batch-reduce building block (``layers/lstm.py``).  Parameters
are the reference's tree, ``{"embed": {"table"}, "layers": [{"w", "r",
"b"}, ...]}``, and ``loss_and_grads`` plays the part of the reference's
``jax.value_and_grad`` of ``loss_fn``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.layers import embeddings, lstm
from repro_torch.layers.conv import _draw
from repro_torch.models.resnet import map_params, named_leaves


@dataclasses.dataclass(frozen=True)
class LSTMLMCfg:
    vocab: int = 1024
    d_model: int = 256
    n_layers: int = 4
    dtype: str = "float32"


def init_params(cfg: LSTMLMCfg, generator: torch.Generator | None = None,
                device="cuda"):
    """The embedding table normal scaled by ``d_model ** -0.5`` and the
    LSTMs as ``lstm.init``, drawn in fp32 from ``generator`` (default: a CPU
    generator seeded 0), then cast to ``cfg.dtype``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dt = getattr(torch, cfg.dtype)
    table = _draw((cfg.vocab, cfg.d_model), generator, device,
                  cfg.d_model ** -0.5)
    return {"embed": {"table": table.to(dt)},
            "layers": [lstm.init(cfg.d_model, cfg.d_model, dtype=dt,
                                 generator=generator, device=device)
                       for _ in range(cfg.n_layers)]}


def forward(params, tokens, cfg: LSTMLMCfg, *, backend=None):
    """tokens: (B, T) -> fp32 logits (B, T, vocab)."""
    x = embeddings.encode(params["embed"]["table"], tokens)   # (B, T, D)
    h = x.transpose(0, 1)                                     # (T, B, D)
    for lp in params["layers"]:
        out, _ = lstm.forward(lp, h, backend=backend)
        h = h + out                                           # residual
    return embeddings.decode(params["embed"]["table"], h.transpose(0, 1),
                             backend=backend)


def loss_fn(params, batch, cfg: LSTMLMCfg, *, backend=None):
    """Mean next-token NLL over every position (no mask).  Returns
    ``(loss, {"loss": loss})``."""
    logits = forward(params, batch["tokens"], cfg, backend=backend)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    loss = -ll.mean()
    return loss, {"loss": loss}


def loss_and_grads(params, batch, cfg: LSTMLMCfg, *, backend=None):
    """``((loss, metrics), grads)``, the grads a tree shaped like
    ``params`` in the parameters' dtypes: the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)``."""
    leaves = [t.detach().requires_grad_() for _, t in named_leaves(params)]
    it = iter(leaves)
    loss, metrics = loss_fn(map_params(lambda _: next(it), params), batch,
                            cfg, backend=backend)
    grads = iter(torch.autograd.grad(loss, leaves))
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            map_params(lambda _: next(grads), params))

"""Uniform model API, as in the reference; the dense decoder only."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchCfg
from repro_torch.models import transformer


def init_params(cfg: ArchCfg, generator: torch.Generator | None = None,
                device="cuda"):
    return transformer.init_params(cfg, generator, device=device)


def init_cache(cfg: ArchCfg, batch: int, max_len: int, *, device="cuda"):
    return transformer.init_cache(cfg, batch, max_len, device=device)


def forward(params, batch, cfg: ArchCfg, **kw):
    return transformer.forward(params, batch, cfg, **kw)


def loss_fn(params, batch, cfg: ArchCfg, **kw):
    return transformer.loss_fn(params, batch, cfg, **kw)


def prefill(params, batch, cfg: ArchCfg, cache, **kw):
    return transformer.prefill(params, batch, cfg, cache, **kw)


def decode_step(params, tokens, cfg: ArchCfg, cache, pos, **kw):
    return transformer.decode_step(params, tokens, cfg, cache, pos, **kw)

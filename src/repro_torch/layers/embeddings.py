"""Token embedding table and the tied output head.

On a mesh's model axis (``tp``: ``distributed/parallel.py``) each rank
holds ``vocab / size`` rows of the table, from ``index * rows``: a token
outside them looks up zeros, and the ranks' lookups are summed (a masked
lookup and an all-reduce); the tied head's logits are the rank's block of
the vocab's columns (``models/transformer.py`` takes the loss over them
without gathering them).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import brgemm
from repro_torch.distributed.collectives import (copy_to_model,
                                                 reduce_from_model)


def encode(table, tokens):
    return table[tokens]


def decode(table, x, *, backend: str | None = None):
    """fp32 logits = x @ table^T through the building block.  ``table.T`` is
    a column-major view; the kernel reads it in place, with no copy."""
    return brgemm.matmul(x, table.T, out_dtype=torch.float32,
                         backend=backend)


class Embedding(nn.Module):
    tp = None     # a mesh's model axis (collectives.AxisGroup), else None

    def __init__(self, vocab: int, d: int, *, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        self.table = nn.Parameter(
            torch.empty(vocab, d, dtype=dtype, device=device))

    def encode(self, tokens):
        if self.tp is None or self.tp.size == 1:
            return encode(self.table, tokens)
        rows = self.table.size(0)
        local = tokens - self.tp.index * rows
        inside = (local >= 0) & (local < rows)
        h = encode(self.table, torch.where(inside, local, 0))
        return reduce_from_model(h * inside[..., None].to(h.dtype), self.tp)

    def decode(self, x, *, backend: str | None = None):
        return decode(self.table, copy_to_model(x, self.tp),
                      backend=backend)

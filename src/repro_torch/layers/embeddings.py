"""Token embedding table and the tied output head."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import brgemm


def encode(table, tokens):
    return table[tokens]


def decode(table, x, *, backend: str | None = None):
    """fp32 logits = x @ table^T through the building block.  ``table.T`` is
    a column-major view; the kernel reads it in place, with no copy."""
    return brgemm.matmul(x, table.T, out_dtype=torch.float32,
                         backend=backend)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        self.table = nn.Parameter(
            torch.empty(vocab, d, dtype=dtype, device=device))

    def encode(self, tokens):
        return encode(self.table, tokens)

    def decode(self, x, *, backend: str | None = None):
        return decode(self.table, x, backend=backend)

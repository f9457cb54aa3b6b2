"""RMSNorm with fp32 statistics, whatever the parameter dtype."""
from __future__ import annotations

import torch
from torch import nn


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """fp32 mean of squares, then the result cast back to ``x.dtype``."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * (1.0 / torch.sqrt(var + eps))
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x):
        return rmsnorm(x, self.scale)

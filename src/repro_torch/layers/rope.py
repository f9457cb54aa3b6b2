"""Rotary position embeddings over interleaved pairs (with position offsets).

The pairs are ``x[..., 0::2], x[..., 1::2]``, rotated and restacked in
place: the reference's convention, not the ``rotate_half`` one.  Angles are
fp32.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, *, theta: float = 10000.0, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim // 2,)


def apply_rope(x, positions, *, theta: float = 10000.0):
    """x: (..., T, d) with d even; positions: (T,) or (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta=theta, device=x.device)
    angles = positions[..., :, None].float() * freqs  # (..., T, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    # Broadcast over any head dims between batch and T.
    while cos.dim() < x.dim():
        cos, sin = cos.unsqueeze(-3), sin.unsqueeze(-3)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)

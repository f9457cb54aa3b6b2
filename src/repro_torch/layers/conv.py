"""Convolution layer — the paper's Algorithm 4 as a parametrized layer.

Parameters are a dict, as in the reference (``repro/layers/conv.py``):
``{"w": (R, S, C, K)}`` plus ``"b": (K,)`` when the layer has a bias.
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch import check_device
from repro_torch.kernels.conv2d import conv2d


def _draw(shape, generator, device, scale):
    """fp32 normal draws from ``generator`` (default: a CPU generator
    seeded 0) on the generator's device, scaled, then moved to
    ``device``."""
    device = check_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    draw = torch.randn(shape, generator=generator, device=generator.device)
    return (draw * scale).to(device)


def init(c: int, k: int, r: int, s: int, *, use_bias: bool = True,
         generator: torch.Generator | None = None, device="cuda"):
    """He-normal fp32 weights, ``(2 / (C R S)) ** 0.5``; a zero bias."""
    params = {"w": _draw((r, s, c, k), generator, device,
                         (2.0 / (c * r * s)) ** 0.5)}
    if use_bias:
        params["b"] = torch.zeros(k, device=device)
    return params


def apply(params, x, *, stride: int = 1, padding: int = 0,
          activation: str = "none", backend: str | None = None):
    return conv2d(x, params["w"], params.get("b"), stride=stride,
                  padding=padding, activation=activation, backend=backend)

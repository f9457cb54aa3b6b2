"""Epilogue activations of the batch-reduce GEMM.

The paper's fusion claim (Sec. 3.1.2, 3.3.2): element-wise operators are
applied on the just-computed output block while it is hot.  On Hopper that
is the fp32 accumulator in registers, before the single store.  Every
activation is defined in fp32; the plain path (``ACTIVATIONS``) and the CUDA
epilogue (``kernels/brgemm/csrc/matmul.cu``, ``apply_act``) implement the
same formulas, and ``CODES`` is the integer each one is known by on both
sides of the ``ctypes`` boundary.  The gradient tables come with training.
"""
from __future__ import annotations

import math

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _gelu_tanh(x):
    # tanh approximation (jax.nn.gelu(approximate=True))
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                       * (x + 0.044715 * x * x * x)))


ACTIVATIONS = {
    "none": lambda x: x,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": _gelu_tanh,
    "silu": lambda x: x * torch.sigmoid(x),
    "exp": torch.exp,
    "square": lambda x: x * x,
}

# Kept in the order of the ``Act`` enum in csrc/matmul.cu.
CODES = {name: i for i, name in enumerate(ACTIVATIONS)}


def code(activation: str) -> int:
    try:
        return CODES[activation]
    except KeyError:
        raise ValueError(
            f"unknown activation {activation!r}; known: {sorted(ACTIVATIONS)}"
        ) from None


def apply(activation: str, x):
    code(activation)
    return ACTIVATIONS[activation](x)

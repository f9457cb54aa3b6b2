"""Epilogue activations of the batch-reduce GEMM.

The paper's fusion claim (Sec. 3.1.2, 3.3.2): element-wise operators are
applied on the just-computed output block while it is hot.  On Hopper that
is the fp32 accumulator in registers, before the single store.  Every
activation is defined in fp32; the plain path (``ACTIVATIONS``) and the CUDA
epilogue (``kernels/brgemm/csrc/matmul.cu``, ``apply_act``) implement the
same formulas, and ``CODES`` is the integer each one is known by on both
sides of the ``ctypes`` boundary.  ``GRAD_FROM_OUTPUT`` and
``GRAD_FROM_PREACT`` are each activation's derivative, from the output
``y = act(pre)`` where that is enough and from the pre-activation where it
is not; the GEMM's backward (``kernels/brgemm/ops.py``) reads them.
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


# Derivatives expressible from the output y = act(pre): the backward needs
# neither the pre-activation nor a recompute.
GRAD_FROM_OUTPUT = {
    "none": lambda y: torch.ones_like(y),
    "relu": lambda y: (y > 0).to(y.dtype),
    "sigmoid": lambda y: y * (1.0 - y),
    "tanh": lambda y: 1.0 - y * y,
    "exp": lambda y: y,
}


def _gelu_grad_pre(pre):
    t = torch.tanh(_SQRT_2_OVER_PI * (pre + 0.044715 * pre ** 3))
    return (0.5 * (1.0 + t) + 0.5 * pre * (1.0 - t * t) * _SQRT_2_OVER_PI
            * (1.0 + 3 * 0.044715 * pre * pre))


def _silu_grad_pre(pre):
    s = torch.sigmoid(pre)
    return s * (1.0 + pre * (1.0 - s))


# Derivatives that need the pre-activation (the backward recomputes it).
GRAD_FROM_PREACT = {
    "gelu": _gelu_grad_pre,
    "silu": _silu_grad_pre,
    "square": lambda pre: 2.0 * pre,
}


def needs_preact(activation: str) -> bool:
    """True if the activation's derivative cannot be taken from its output."""
    if activation in GRAD_FROM_OUTPUT:
        return False
    if activation in GRAD_FROM_PREACT:
        return True
    raise ValueError(f"unknown activation {activation!r}")


def output_grad(dy, y, activation: str, recompute):
    """``dy * act'(pre)`` in fp32, the gradient a GEMM's or a convolution's
    backward starts from: act' read from the output ``y`` where that is
    enough, else from the fp32 pre-activation that ``recompute()``
    returns."""
    g = dy.float()
    if needs_preact(activation):
        return g * GRAD_FROM_PREACT[activation](recompute())
    if activation != "none":
        return g * GRAD_FROM_OUTPUT[activation](y.float())
    return g


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

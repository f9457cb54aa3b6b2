"""A lean op registry: one plain PyTorch backend and one kernel backend per op.

Backends:
  * ``"torch"`` — the plain PyTorch version.  It runs anywhere; it is the CPU
    path, and on the card it is the version a kernel is held against.
  * ``"cuda"``  — the hand-written Hopper kernel.  CUDA tensors only.

Precedence, highest first: the explicit ``backend=`` argument of a call, the
innermost active ``use(backend=...)`` context, then the device of the tensor
the op was given (a CUDA tensor resolves to ``"cuda"``, a CPU tensor to
``"torch"``).  Nothing falls back: a backend that cannot run the call raises.

``use(quant=...)`` switches the GEMM family to quantized execution (a
``QuantConfig``, dict, or shorthand such as ``"int8"`` / ``"fp8"``; see
``core/quantize.py``); ``resolve_quant`` gives the explicit argument, else the
innermost context's config, else None (full precision), as the reference's
``repro/core/dispatch.py`` does.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import torch

from repro_torch.core.quantize import QuantConfig, as_quant_config

BACKENDS = ("torch", "cuda")

_REGISTRY: dict[str, dict[str, Callable]] = {}
_BACKEND: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "repro_torch_backend", default=None)
_QUANT: contextvars.ContextVar[QuantConfig | None] = contextvars.ContextVar(
    "repro_torch_quant", default=None)


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    return backend


def register(op: str, backend: str):
    """Decorator: register ``fn`` as ``op``'s implementation on ``backend``."""
    _check_backend(backend)

    def deco(fn):
        _REGISTRY.setdefault(op, {})[backend] = fn
        return fn

    return deco


@contextlib.contextmanager
def use(*, backend: str | None = None, quant=None):
    """Scope a backend and a quant config for every op called inside.  A
    field left ``None`` keeps the outer context's choice; the previous state
    is restored on exit.  ``quant`` is normalized (and so validated) here."""
    tokens = []
    if backend is not None:
        tokens.append((_BACKEND, _BACKEND.set(_check_backend(backend))))
    if quant is not None:
        tokens.append((_QUANT, _QUANT.set(as_quant_config(quant))))
    try:
        yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)


def resolve_quant(quant=None) -> QuantConfig | None:
    """The active ``QuantConfig``: the call's argument, else the innermost
    ``use(quant=...)``, else None (full precision)."""
    if quant is not None:
        return as_quant_config(quant)
    return _QUANT.get()


def resolve(op: str, backend: str | None, tensor: torch.Tensor) -> str:
    """The backend ``op`` runs on for a call on ``tensor``."""
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; known: {sorted(_REGISTRY)}")
    name = backend or _BACKEND.get()
    if name is None:
        name = "cuda" if tensor.is_cuda else "torch"
    _check_backend(name)
    if name == "cuda" and not tensor.is_cuda:
        raise ValueError(
            f"backend 'cuda' for {op!r} needs CUDA tensors, got a tensor on "
            f"{tensor.device}")
    if name not in _REGISTRY[op]:
        raise KeyError(f"op {op!r} has no {name!r} backend")
    return name


def get_impl(op: str, backend: str | None, tensor: torch.Tensor) -> Callable:
    return _REGISTRY[op][resolve(op, backend, tensor)]


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no card, so that no entry point quietly runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return device

"""A lean op registry: one plain PyTorch backend and one kernel backend per op.

Backends:
  * ``"torch"`` — the plain PyTorch version.  It runs anywhere; it is the CPU
    path, and on the card it is the version a kernel is held against.
  * ``"cuda"``  — the hand-written Hopper kernel.  CUDA tensors only.

Precedence, highest first: the explicit ``backend=`` argument of a call, the
innermost active ``use(backend=...)`` context, then the device of the tensor
the op was given (a CUDA tensor resolves to ``"cuda"``, a CPU tensor to
``"torch"``).  Nothing falls back: a backend that cannot run the call raises.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import torch

BACKENDS = ("torch", "cuda")

_REGISTRY: dict[str, dict[str, Callable]] = {}
_BACKEND: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "repro_torch_backend", default=None)


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
def use(*, backend: str | None = None):
    """Scope a backend for every op called inside; ``None`` keeps the outer
    context's choice."""
    if backend is None:
        yield
        return
    token = _BACKEND.set(_check_backend(backend))
    try:
        yield
    finally:
        _BACKEND.reset(token)


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

"""A lean op registry: one plain PyTorch backend and one kernel backend per op.

Backends:
  * ``"torch"`` — the plain PyTorch version.  It runs anywhere; it is the CPU
    path, and on the card it is the version a kernel is held against.
  * ``"cuda"``  — the hand-written Hopper kernel.  CUDA tensors on a card of
    compute capability 9.0 only (the kernels are built for ``sm_90a``).

Precedence, highest first, as in the reference's ``repro/core/dispatch.py``:
the explicit ``backend=`` argument of a call, the innermost active
``use(backend=...)`` context, the ``REPRO_TORCH_BACKEND`` environment
variable (``torch`` or ``cuda``; any other value raises), then the hardware
default: ``"cuda"`` for a tensor on a card of compute capability (9, 0),
``"torch"`` for every other tensor (the CPU, other cards).  The reference's
own ``REPRO_BACKEND`` names its backends (``pallas``, ``xla``) and is not
read here: the tests import both packages in one process.  Nothing falls
back: a backend that any tier names and that cannot run the call raises.

``use(quant=...)`` switches the GEMM family to quantized execution (a
``QuantConfig``, dict, or shorthand such as ``"int8"`` / ``"fp8"``; see
``core/quantize.py``); ``resolve_quant`` gives the explicit argument, else the
innermost context's config, else None (full precision), as the reference's
``repro/core/dispatch.py`` does.  ``use(tracer=...)`` scopes a
``repro_torch.obs.Tracer`` to the context.  Every ``resolve`` counts its
(op, backend) in ``obs.TELEMETRY`` and, under an active tracer, records a
``dispatch`` event, as the reference's ``_record_dispatch`` does.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import os
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.core.quantize import QuantConfig, as_quant_config

BACKENDS = ("torch", "cuda")
ENV_VAR = "REPRO_TORCH_BACKEND"
HOPPER = (9, 0)        # the compute capability the kernels are built for

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
def use(*, backend: str | None = None, quant=None, tracer=None):
    """Scope a backend, a quant config and a tracer for every op called
    inside.  A field left ``None`` keeps the outer context's choice; the
    previous state is restored on exit.  ``quant`` is normalized (and so
    validated) here.  ``tracer`` (a ``repro_torch.obs.Tracer``) records the
    dispatch events and every ``obs.span`` entered inside."""
    tokens = []
    if backend is not None:
        tokens.append((_BACKEND, _BACKEND.set(_check_backend(backend))))
    if quant is not None:
        tokens.append((_QUANT, _QUANT.set(as_quant_config(quant))))
    obs_token = obs._activate(tracer) if tracer is not None else None
    try:
        yield
    finally:
        if obs_token is not None:
            obs._deactivate(obs_token)
        for var, token in reversed(tokens):
            var.reset(token)


def resolve_quant(quant=None) -> QuantConfig | None:
    """The active ``QuantConfig``: the call's argument, else the innermost
    ``use(quant=...)``, else None (full precision)."""
    if quant is not None:
        return as_quant_config(quant)
    return _QUANT.get()


@functools.lru_cache(maxsize=None)
def _is_hopper(index: int) -> bool:
    """Whether card ``index`` runs the kernels; asked once a card (a
    dispatch is on every op's path).  ``_is_hopper.cache_clear()`` forgets
    the answers."""
    return tuple(torch.cuda.get_device_capability(index)) == HOPPER


def _env_backend() -> str | None:
    name = os.environ.get(ENV_VAR) or None
    if name is not None and name not in BACKENDS:
        raise ValueError(f"{ENV_VAR}={name!r} names no backend; known: "
                         f"{BACKENDS}")
    return name


def resolve(op: str, backend: str | None, tensor: torch.Tensor) -> str:
    """The backend ``op`` runs on for a call on ``tensor``: the argument,
    else the innermost context, else ``REPRO_TORCH_BACKEND``, else the
    hardware default.  Raises where the chosen backend cannot run it."""
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; known: {sorted(_REGISTRY)}")
    name = backend or _BACKEND.get() or _env_backend()
    if name is None:
        name = ("cuda" if tensor.is_cuda and _is_hopper(tensor.device.index)
                else "torch")
    _check_backend(name)
    if name == "cuda":
        if not tensor.is_cuda:
            raise ValueError(
                f"backend 'cuda' for {op!r} needs CUDA tensors, got a tensor "
                f"on {tensor.device}")
        if not _is_hopper(tensor.device.index):
            raise ValueError(
                f"backend 'cuda' for {op!r} needs a card of compute "
                f"capability {HOPPER}, got {tensor.device}: the kernels are "
                f"built for sm_90a")
    if name not in _REGISTRY[op]:
        raise KeyError(f"op {op!r} has no {name!r} backend")
    obs.TELEMETRY.record_dispatch(op, name)
    tr = obs.current_tracer()
    if tr is not None:
        tr.event("dispatch", op=op, backend=name)
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

"""repro_torch.obs: the tracer and the dispatch counters.

The port of ``repro/obs/__init__.py``: a low-overhead tracer (nested spans
and instant events in a ring buffer, :mod:`repro_torch.obs.tracer`) that
dispatch resolutions (``dispatch`` and ``resolve_blocks`` events), the
autotuner's searches (``autotune.search`` spans, an ``autotune.measure``
span a candidate) and the serving engine's request lifecycles record
into, and the always-on dispatch, tuning-cache and autotune counters
(:mod:`repro_torch.obs.telemetry`).  The reference's Chrome export and
FLOP accounting are not ported.

Activation (off by default; the disabled fast path is one bool check):

    tracer = obs.Tracer()
    prev = obs.install(tracer)          # global, all threads
    ...
    obs.install(prev)

    with repro_torch.use(tracer=tracer):   # scoped to the context
        ...

Instrumented code guards its hot sites with::

    tr = obs.current_tracer()
    if tr is not None:
        tr.event("dispatch", op=op, ...)

and ``obs.span("name")`` / ``obs.event(...)`` / ``obs.annotate(...)``
are safe to call unconditionally: with no tracer active they return a
shared no-op singleton / do nothing, allocating nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading

from repro_torch.obs import telemetry  # noqa: F401
from repro_torch.obs.telemetry import TELEMETRY  # noqa: F401
from repro_torch.obs.tracer import (  # noqa: F401
    NULL_SPAN,
    EventRecord,
    Span,
    SpanRecord,
    Tracer,
)

# Activation state.  _ENABLED is the one-check disabled fast path: it is
# True iff a global tracer is installed or any scoped activation is live
# anywhere in the process, so the common "tracing off" case pays a single
# module-global bool read.  The context var carries scoped activations
# (repro_torch.use(tracer=...), activate) and wins over the global install.
_GLOBAL: Tracer | None = None
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_tracer", default=None)
_SCOPED_DEPTH = 0
_ENABLED = False
_STATE_LOCK = threading.Lock()


def _refresh() -> None:
    global _ENABLED
    _ENABLED = _GLOBAL is not None or _SCOPED_DEPTH > 0


def install(tracer: Tracer | None):
    """Install ``tracer`` globally (all threads); returns the previous
    global tracer so callers can restore it.  ``install(None)``
    uninstalls."""
    global _GLOBAL
    with _STATE_LOCK:
        prev, _GLOBAL = _GLOBAL, tracer
        _refresh()
    return prev


def _activate(tracer: Tracer):
    """Scoped activation (context var), used by
    ``repro_torch.use(tracer=...)``.  Returns a token for
    :func:`_deactivate`."""
    global _SCOPED_DEPTH
    with _STATE_LOCK:
        _SCOPED_DEPTH += 1
        _refresh()
    return _ACTIVE.set(tracer)


def _deactivate(token) -> None:
    global _SCOPED_DEPTH
    _ACTIVE.reset(token)
    with _STATE_LOCK:
        _SCOPED_DEPTH -= 1
        _refresh()


@contextlib.contextmanager
def activate(tracer: Tracer | None):
    """Scope ``tracer`` as the current-context tracer (a
    ``repro_torch.use(tracer=...)`` without the dispatch context); passing
    None is a no-op scope."""
    if tracer is None:
        yield None
        return
    token = _activate(tracer)
    try:
        yield tracer
    finally:
        _deactivate(token)


def current_tracer() -> Tracer | None:
    """The active tracer: scoped activation > global install > None.
    The disabled path is one bool check."""
    if not _ENABLED:
        return None
    return _ACTIVE.get() or _GLOBAL


def span(name: str, **attrs):
    """A span on the active tracer, or the shared no-op singleton —
    always usable as ``with obs.span("prefill"): ...``."""
    if not _ENABLED:
        return NULL_SPAN
    tr = _ACTIVE.get() or _GLOBAL
    return tr.span(name, **attrs) if tr is not None else NULL_SPAN


def event(name: str, **attrs) -> None:
    """An instant event on the active tracer (no-op when disabled)."""
    if not _ENABLED:
        return
    tr = _ACTIVE.get() or _GLOBAL
    if tr is not None:
        tr.event(name, **attrs)


def annotate(**attrs) -> None:
    """Attach attributes to the active tracer's open span (no-op when
    disabled or outside any span)."""
    if not _ENABLED:
        return
    tr = _ACTIVE.get() or _GLOBAL
    if tr is not None:
        tr.annotate(**attrs)

"""Activation sharding constraints, decoupled from model code: the port
of ``repro/sharding/annotate.py``.

Models call ``constrain(x, kind)`` with a *logical* activation kind; the
launcher installs an active rule set (mesh-aware) via ``use_rules``.  In
the reference the constraint steers GSPMD's layout.  Each rank of the
port already holds its own shard of every activation (the executor,
``distributed/parallel.py``, runs the local problem), so ``constrain``
asks the rules and returns ``x`` itself: the rules stay queryable
(``current_rules``), the call sites stay the reference's.
"""
from __future__ import annotations

import contextlib
import contextvars

_ACTIVE = contextvars.ContextVar("repro_torch_sharding_rules", default=None)
_MESH = contextvars.ContextVar("repro_torch_sharding_mesh", default=None)


@contextlib.contextmanager
def use_rules(rules, mesh=None):
    """rules: callable (x, kind) -> spec | None."""
    tok = _ACTIVE.set(rules)
    tok_m = _MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)
        _MESH.reset(tok_m)


def current_mesh():
    """Mesh installed by the launcher (None in single-device contexts)."""
    return _MESH.get()


def current_rules():
    return _ACTIVE.get()


def constrain(x, kind: str):
    """``x``: a rank's tensor is its shard already."""
    return x

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

``use(accum_dtype=...)`` sets the accumulator of every full-precision GEMM,
convolution and flash kernel (``torch.float32``, the default, or
``torch.bfloat16``; their names too); :func:`resolve_accum_dtype` gives
the call's argument, else the innermost context's, else fp32, as the
reference's ``resolve_accum_dtype``.  Under bf16 accumulation a kernel
rounds its fp32 sums to bf16 at the ends of the reference's reduction
blocks (``blocking.accum_block``); the quantized GEMMs keep the
accumulator their storage implies (int32 for int8, fp32 for fp8) and
ignore it.

``use(blocks_policy=...)`` picks how a kernel's plan is chosen
(:func:`resolve_blocks`): the wrapper's explicit ``plan=`` argument, else
the innermost context's policy, else ``"heuristic"`` (the op's own
``plan*`` function, ``core/blocking.py``).  ``"autotune"`` measures the
candidate grid on the card (``core/autotune.py``); a callable is a policy
of its own.  Picks are memoized in a shape-keyed tuning cache, keyed as
the reference's (op, backend, m, n, k, dtype, policy, geometry, mesh
signature, quant tag), and persisted to JSON (:func:`save_cache` /
:func:`load_cache`, or through the file ``REPRO_TORCH_TUNING_CACHE``
names: loaded on first use, written through on every new named-policy
entry).  The reference's ``REPRO_TUNING_CACHE`` names files of TPU tiles
and is not read here.

``use(mesh=..., axis_specs=...)`` makes plans per shard, as the
reference's: under a mesh the cache key carries its signature (its axis
names, ``sharding.local.mesh_signature``).  Under an *abstract* mesh (one
that models a layout: ``sharding.local.abstract_mesh``) the call runs the
global shape and :func:`resolve_blocks` maps its triple to the shard's
(``sharding.local.local_problem``, honouring ``axis_specs``), as the
reference's GSPMD trace does; the kernels fit a plan chosen for the
shard to the shape they run (``blocking.fit_plan``).  On a
rank of a running mesh the call's triple is the shard's already, and is
not divided again.  ``axis_specs`` maps an op to its triple's axes, or to
``{"axes": ..., "backend": ...}``, whose ``backend`` pins the op's
backend below an explicit argument and above the context's (the
reference's order).

Autograd runs a CUDA backward on a thread of its own, where this module's
context variables hold their defaults: a kernel's backward re-enters its
forward's state (:func:`snapshot`, :func:`restored`).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import inspect
import json
import os
import threading
import warnings
from typing import Any, Callable

import torch

from repro_torch import obs
from repro_torch.core import blocking
from repro_torch.core.quantize import QuantConfig, as_quant_config

BACKENDS = ("torch", "cuda")
ENV_VAR = "REPRO_TORCH_BACKEND"
TUNING_CACHE_ENV = "REPRO_TORCH_TUNING_CACHE"
HOPPER = (9, 0)        # the compute capability the kernels are built for

_REGISTRY: dict[str, dict[str, Callable]] = {}
_BACKEND: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "repro_torch_backend", default=None)
_QUANT: contextvars.ContextVar[QuantConfig | None] = contextvars.ContextVar(
    "repro_torch_quant", default=None)
_POLICY: contextvars.ContextVar[str | Callable | None] = \
    contextvars.ContextVar("repro_torch_blocks_policy", default=None)
_ACCUM: contextvars.ContextVar[torch.dtype | None] = contextvars.ContextVar(
    "repro_torch_accum_dtype", default=None)
_MESH: contextvars.ContextVar[Any] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_AXIS_SPECS: contextvars.ContextVar[Any] = contextvars.ContextVar(
    "repro_torch_axis_specs", default=None)
# The ops whose canonical triple a mesh localises (the reference's
# ``BLOCK_SCHEMAS``; ``sharding.local.default_axis_specs``).
MESH_OPS = ("matmul", "brgemm", "batched_matmul", "conv2d",
            "flash_attention", "flash_attention_bwd")
ACCUM_DTYPES = (torch.float32, torch.bfloat16)


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


def _axis_spec_axes(spec):
    """The (m, n, k) axis triple of an axis_specs entry, or None (a dict
    without ``axes`` pins only the backend)."""
    if isinstance(spec, dict):
        return spec.get("axes")
    return spec


def _axis_spec_backend(spec) -> str | None:
    """The per-op backend pin of an axis_specs entry, or None."""
    if isinstance(spec, dict):
        return spec.get("backend")
    return None


def _check_axis_spec(op: str, spec) -> None:
    """An axis spec is one entry per canonical dim: exactly 3 entries,
    each ``None`` / axis name / tuple of axis names, or a dict with
    ``axes`` (the same triple) and/or ``backend`` (a per-op backend pin).
    A bare string would iterate per character, so it is refused."""
    if isinstance(spec, dict):
        unknown = set(spec) - {"axes", "backend"}
        if unknown:
            raise ValueError(
                f"axis_specs[{op!r}]: unknown key(s) {sorted(unknown)}; "
                f"a dict entry takes 'axes' and/or 'backend'")
        backend = spec.get("backend")
        if backend is not None:
            _check_backend(backend)
            if op in _REGISTRY and backend not in _REGISTRY[op]:
                raise ValueError(
                    f"axis_specs[{op!r}]: backend {backend!r} is not "
                    f"registered for this op (has: "
                    f"{', '.join(sorted(_REGISTRY[op]))})")
        spec = spec.get("axes")
        if spec is None:
            return
    bad = None
    if isinstance(spec, str) or not hasattr(spec, "__iter__"):
        bad = f"{spec!r} is not a sequence of 3 entries"
    else:
        entries = tuple(spec)
        if len(entries) != 3:
            bad = f"expected 3 entries (m, n, k), got {len(entries)}"
        else:
            for e in entries:
                if e is None or isinstance(e, str):
                    continue
                if isinstance(e, (tuple, list)) and all(
                        isinstance(a, str) for a in e):
                    continue
                bad = (f"entry {e!r} is not None, an axis name, or a "
                       f"tuple of axis names")
                break
    if bad:
        raise ValueError(f"axis_specs[{op!r}]: {bad}")


def check_axis_specs(axis_specs):
    """``axis_specs`` when ``use`` takes it (None, or a mapping of known
    ops to valid entries), else raises."""
    if axis_specs is not None:
        unknown = set(axis_specs) - set(MESH_OPS)
        if unknown:
            raise ValueError(
                f"axis_specs for unknown op(s) {sorted(unknown)}; known: "
                f"{', '.join(sorted(MESH_OPS))}")
        for op_name, spec in axis_specs.items():
            _check_axis_spec(op_name, spec)
    return axis_specs


def current_mesh():
    """The innermost ``use(mesh=...)``'s mesh, else None."""
    return _MESH.get()


def current_axis_specs():
    """The innermost ``use(axis_specs=...)``'s mapping, else None."""
    return _AXIS_SPECS.get()


@contextlib.contextmanager
def use(*, backend: str | None = None, quant=None, tracer=None,
        blocks_policy: str | Callable | None = None, accum_dtype=None,
        mesh=None, axis_specs=None):
    """Scope a backend, a quant config, a block policy, an accumulator
    dtype, a mesh, axis specs and a tracer for every op called inside.  A
    field left ``None`` keeps the outer context's choice (an ``axis_specs``
    mapping replaces the outer one whole, it is not merged); the previous
    state is restored on exit.  ``quant``, ``accum_dtype``,
    ``axis_specs`` and a named ``blocks_policy`` are validated here.
    ``tracer`` (a ``repro_torch.obs.Tracer``) records the dispatch
    events, the ``resolve_blocks`` events, autotune spans and every
    ``obs.span`` entered inside."""
    check_axis_specs(axis_specs)
    tokens = []
    if mesh is not None:
        tokens.append((_MESH, _MESH.set(mesh)))
    if axis_specs is not None:
        tokens.append((_AXIS_SPECS, _AXIS_SPECS.set(axis_specs)))
    if backend is not None:
        tokens.append((_BACKEND, _BACKEND.set(_check_backend(backend))))
    if quant is not None:
        tokens.append((_QUANT, _QUANT.set(as_quant_config(quant))))
    if blocks_policy is not None:
        tokens.append((_POLICY, _POLICY.set(
            check_blocks_policy(blocks_policy))))
    if accum_dtype is not None:
        tokens.append((_ACCUM, _ACCUM.set(as_accum_dtype(accum_dtype))))
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


def as_accum_dtype(accum_dtype) -> torch.dtype:
    """``accum_dtype`` (a dtype or its name) as one of ACCUM_DTYPES, else
    raises."""
    dtype = (getattr(torch, accum_dtype, None)
             if isinstance(accum_dtype, str) else accum_dtype)
    if dtype not in ACCUM_DTYPES:
        raise ValueError(f"accum_dtype {accum_dtype!r} is not one of "
                         f"{ACCUM_DTYPES} (or their names)")
    return dtype


def resolve_accum_dtype(accum_dtype=None) -> torch.dtype:
    """The accumulator dtype of the full-precision GEMM, convolution and
    flash kernels: the call's argument, else the innermost
    ``use(accum_dtype=...)``, else fp32."""
    if accum_dtype is not None:
        return as_accum_dtype(accum_dtype)
    return _ACCUM.get() or torch.float32


def accum_block(op: str, k: int) -> int:
    """The rounding block of a call of ``op`` (``blocking.accum_block``)
    under the context's accumulator, or 0 for fp32 accumulation."""
    if resolve_accum_dtype() == torch.float32:
        return 0
    return blocking.accum_block(op, k)


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
    else the op's ``axis_specs`` pin, else the innermost context, else
    ``REPRO_TORCH_BACKEND``, else the hardware default.  Raises where the
    chosen backend cannot run it."""
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; known: {sorted(_REGISTRY)}")
    specs = _AXIS_SPECS.get()
    pinned = (_axis_spec_backend(specs.get(op))
              if backend is None and specs is not None else None)
    name = backend or pinned or _BACKEND.get() or _env_backend()
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


def check_blocks_policy(policy):
    """``policy`` when ``use(blocks_policy=policy)`` takes it (None, a
    callable or a registered name; naming ``"autotune"`` registers it),
    else raises."""
    if policy is not None and not callable(policy):
        _policy_fn(policy)
    return policy


_STATE = (_BACKEND, _QUANT, _POLICY, _ACCUM, _MESH, _AXIS_SPECS)


def snapshot() -> tuple:
    """This context's backend, quant config, block policy, accumulator
    dtype, mesh and axis specs, for :func:`restored` on another thread
    (autograd's CUDA backward, a checkpointed block's recompute)."""
    return tuple(var.get() for var in _STATE)


@contextlib.contextmanager
def restored(state: tuple):
    """Run inside the state a :func:`snapshot` took."""
    tokens = [(var, var.set(value)) for var, value in zip(_STATE, state)]
    try:
        yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)


# --------------------------------------------------------------------------
# shape-keyed tuning cache
# --------------------------------------------------------------------------

BLOCK_POLICIES: dict[str, Callable] = {}
_TUNING_CACHE: dict[tuple, Any] = {}
_TUNING_LOCK = threading.Lock()
_ENV_CACHE_LOADED = False
_CACHE_LOAD_ERRORS = 0    # corrupt or unreadable cache files seen


def register_block_policy(name: str, fn: Callable) -> None:
    """Register a block policy: ``fn(op, m, n, k, dtype, backend,
    geometry=None, quant=None) -> plan`` (the op's own plan type).  Its
    picks are memoized in the tuning cache, so a search pays its cost once
    an (op, shape, dtype, geometry, quant) key."""
    BLOCK_POLICIES[name] = fn


register_block_policy(
    "heuristic",
    lambda op, m, n, k, dtype, backend, geometry=None, quant=None:
        blocking.default_plan(op, m, n, k, dtype, geometry=geometry,
                              quant=quant))


def _accepts_kwarg(fn: Callable, name: str) -> bool:
    """Whether a policy takes the optional ``name=`` argument (a 6-argument
    policy is called without it)."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):  # pragma: no cover - builtins
        return False
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _policy_fn(name: str) -> Callable:
    fn = BLOCK_POLICIES.get(name)
    if fn is not None:
        return fn
    if name == "autotune":
        # Registered at first use: importing dispatch never pays for the
        # autotuner, which imports every kernel wrapper.
        import repro_torch.core.autotune  # noqa: F401
        return BLOCK_POLICIES[name]
    raise ValueError(
        f"unknown blocks_policy {name!r}; registered policies: "
        f"{', '.join(sorted(BLOCK_POLICIES))}")


def _quant_tag(quant) -> str | None:
    return quant if quant is None or isinstance(quant, str) else quant.tag()


def resolve_blocks(op: str, m: int, n: int, k: int, dtype, *, backend: str,
                   plan=None, geometry=None, quant=None):
    """The plan of a call of ``op``: the explicit ``plan``, else the
    context's block policy, else the heuristic.

    ``(m, n, k)`` is the op's canonical triple (``core/blocking.py``);
    ``geometry`` what its plan reads beyond it (a call that names none
    gets plain row-major operands'); ``quant`` (a ``QuantConfig`` or tag)
    marks a quantized call, whose tag joins the key, and ``dtype`` is then
    the weights' storage dtype.  Under ``use(mesh=...)`` the key carries
    the mesh's signature, and an abstract mesh's call has its triple
    mapped to the shard's first (``sharding.local.local_problem``, under
    ``use(axis_specs=...)``); a rank of a running mesh passes the shard's
    triple itself.  Policy picks are memoized keyed (op, backend, m, n,
    k, dtype, policy, geometry, mesh signature, quant tag); an explicit
    ``plan`` bypasses the cache.  A miss while the current stream is
    being captured into a CUDA graph raises: a policy may launch and
    synchronise, so warm the cache first.
    """
    if plan is not None:
        return plan
    if not _ENV_CACHE_LOADED:
        _maybe_load_env_cache()
    policy = _POLICY.get() or "heuristic"
    policy_fn = policy if callable(policy) else _policy_fn(policy)
    mesh, mesh_sig = _MESH.get(), None
    if mesh is not None:
        from repro_torch.sharding import local as _local
        if getattr(mesh, "is_abstract", True):
            m, n, k = _local.local_problem(op, m, n, k, mesh,
                                           axis_specs=_AXIS_SPECS.get())
        mesh_sig = _local.mesh_signature(mesh)
    if geometry is None:
        geometry = blocking.default_geometry(op, m, n, k, dtype, quant=quant)
    quant_tag = _quant_tag(quant)
    key = (op, backend, int(m), int(n), int(k), blocking.dtype_name(dtype),
           policy, geometry, mesh_sig, quant_tag)
    hit = _TUNING_CACHE.get(key)
    if hit is not None:
        source = "cache-hit"
    else:
        if torch.cuda.is_initialized() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"resolve_blocks: no cached plan for {key} while a CUDA "
                f"graph is being captured; run the call once before the "
                f"capture")
        kwargs = {}
        if _accepts_kwarg(policy_fn, "geometry"):
            kwargs["geometry"] = geometry
        if quant is not None and _accepts_kwarg(policy_fn, "quant"):
            kwargs["quant"] = quant
        auto_before = dict(obs.TELEMETRY.autotune)
        hit = policy_fn(op, m, n, k, dtype, backend, **kwargs)
        source = _blocks_source(policy, auto_before)
        with _TUNING_LOCK:
            _TUNING_CACHE[key] = hit
        env_path = os.environ.get(TUNING_CACHE_ENV)
        if env_path and isinstance(policy, str):
            try:
                save_cache(env_path)
            except OSError as exc:
                # write-through is best effort: an unwritable path must
                # not fail the call whose plan it just chose
                warnings.warn(f"could not write the tuning cache to "
                              f"{env_path!r}: {exc}")
    obs.TELEMETRY.record_blocks(source)
    tr = obs.current_tracer()
    if tr is not None:
        _trace_blocks(tr, op, backend, m, n, k, dtype, geometry, quant_tag,
                      source, hit, mesh_sig)
    return hit


def localising() -> bool:
    """Whether plans are chosen for a shard of the call's problem (an
    abstract mesh is active), so a kernel fits its plan to the call
    (``blocking.fit_plan``)."""
    mesh = _MESH.get()
    return mesh is not None and getattr(mesh, "is_abstract", True)


def _trace_blocks(tr, op, backend, m, n, k, dtype, geometry, quant_tag,
                  source, plan, mesh_sig=None) -> None:
    """One ``resolve_blocks`` instant event carrying the decision (op,
    backend, shape, the plan's source, quant, mesh, and the op's
    ``axis_specs`` axes where the context names them) and the FLOP / byte
    cost of the problem (an op without a cost model gets none), and a
    blocks-source annotation on the enclosing span."""
    ev = {"op": op, "backend": backend, "m": int(m), "n": int(n),
          "k": int(k), "dtype": blocking.dtype_name(dtype),
          "source": source, "blocks": str(plan)}
    if quant_tag is not None:
        ev["quant"] = quant_tag
    if mesh_sig is not None:
        ev["mesh"] = str(mesh_sig)
        axes = _axis_spec_axes((_AXIS_SPECS.get() or {}).get(op))
        if axes is not None:
            ev["axes"] = repr(tuple(axes))
    try:
        cost = obs.op_cost(op, m, n, k, dtype, geometry=geometry,
                           quant=quant_tag)
    except ValueError:
        cost = None
    if cost is not None:
        ev["flops"] = cost.flops
        ev["bytes"] = cost.bytes
        ev["intensity"] = round(cost.intensity, 3)
    tr.event("resolve_blocks", **ev)
    tr.annotate(**{f"blocks_source.{op}": source})


def _blocks_source(policy, auto_before: dict) -> str:
    """Where a fresh pick came from: the policy's name, for ``autotune``
    refined by whether a search (or a neighbour's seed) ran: off the
    ``cuda`` backend, and for a grid of one plan, it returns the
    heuristic unmeasured."""
    if not isinstance(policy, str):
        return "custom"
    if policy == "autotune":
        after = obs.TELEMETRY.autotune
        if after["seeded"] > auto_before["seeded"]:
            return "autotune-seeded"
        if after["searches"] > auto_before["searches"]:
            return "autotune-measured"
        return "heuristic"
    return policy


def tuning_cache_info() -> dict[tuple, Any]:
    return dict(_TUNING_CACHE)


def cache_load_errors() -> int:
    """How many corrupt or unreadable tuning-cache loads this process has
    met (warned, or raised when strict)."""
    return _CACHE_LOAD_ERRORS


def clear_tuning_cache() -> None:
    global _ENV_CACHE_LOADED, _CACHE_LOAD_ERRORS
    _TUNING_CACHE.clear()
    _ENV_CACHE_LOADED = False
    _CACHE_LOAD_ERRORS = 0


def _maybe_load_env_cache() -> None:
    global _ENV_CACHE_LOADED
    _ENV_CACHE_LOADED = True    # one attempt a process (or a clear)
    path = os.environ.get(TUNING_CACHE_ENV)
    if path and os.path.exists(path):
        # not strict: a bad cache file costs the heuristic's plans, never
        # the call
        load_cache(path, strict=False)


@functools.lru_cache(maxsize=None)
def _platform() -> str:
    """What a persisted entry was measured on: the card's name, or
    ``cpu``; an entry of another platform is not loaded."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def _entry_key(e: dict) -> tuple:
    geom = e.get("geometry")
    mesh = e.get("mesh")
    return (e["op"], e["backend"], int(e["m"]), int(e["n"]), int(e["k"]),
            e["dtype"], e["policy"], e.get("platform"),
            tuple(sorted(geom.items())) if geom else None,
            tuple(mesh) if mesh else None, e.get("quant"))


def save_cache(path: str | None = None) -> int:
    """Write the tuning cache as JSON; returns the number of entries.

    Entries of a callable policy are skipped (a function does not outlive
    the process).  Each entry is stamped with the platform that chose it;
    entries already in the file and not in memory (another process's, or
    another platform's) are kept.  The file is replaced atomically.
    """
    path = path or os.environ.get(TUNING_CACHE_ENV)
    if not path:
        raise ValueError(f"no path given and {TUNING_CACHE_ENV} is not set")
    platform = _platform()
    with _TUNING_LOCK:
        entries = [
            {"op": op, "backend": backend, "m": m, "n": n, "k": k,
             "dtype": dtype, "policy": policy, "platform": platform,
             "geometry": blocking.geometry_to_dict(geometry),
             "mesh": list(mesh_sig) if mesh_sig is not None else None,
             "quant": quant_tag, "plan": blocking.plan_to_dict(plan)}
            for (op, backend, m, n, k, dtype, policy, geometry, mesh_sig,
                 quant_tag), plan in _TUNING_CACHE.items()
            if isinstance(policy, str)
        ]
    if os.path.exists(path):
        try:
            with open(path) as f:
                prior = json.load(f).get("entries", [])
        except (OSError, ValueError, AttributeError):
            prior = []      # unreadable or corrupt: overwrite it
        if not isinstance(prior, list):
            prior = []
        seen = {_entry_key(e) for e in entries}
        for e in prior:
            try:
                if _entry_key(e) not in seen:
                    entries.append(e)
            except (KeyError, TypeError, AttributeError):
                continue    # a junk entry is dropped from the rewrite
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=1)
    os.replace(tmp, path)
    return len(entries)


def load_cache(path: str | None = None, *, strict: bool = True) -> int:
    """Merge a JSON tuning cache into memory; returns the entries added.
    Entries in memory win a collision; entries of another platform are
    skipped, as are entries this version cannot read.  A corrupt file
    raises when ``strict`` (an explicit call's default) and otherwise
    warns and adds nothing; either way it counts in
    :func:`cache_load_errors`."""
    path = path or os.environ.get(TUNING_CACHE_ENV)
    if not path:
        raise ValueError(f"no path given and {TUNING_CACHE_ENV} is not set")
    global _CACHE_LOAD_ERRORS
    try:
        with open(path) as f:
            data = json.load(f)
        entries = data.get("entries", ())
        if not isinstance(entries, (list, tuple)):
            raise ValueError(f"unknown tuning-cache schema: 'entries' is "
                             f"{type(entries).__name__}, expected a list")
    except (OSError, ValueError, AttributeError) as exc:
        with _TUNING_LOCK:
            _CACHE_LOAD_ERRORS += 1
        if strict:
            raise
        warnings.warn(f"ignoring the corrupt tuning cache {path!r} "
                      f"({type(exc).__name__}: {exc}); the heuristic's "
                      f"plans stand")
        return 0
    platform = _platform()
    count = 0
    with _TUNING_LOCK:
        for e in entries:
            try:
                if e.get("platform", platform) != platform:
                    continue
                mesh = e.get("mesh")
                key = (e["op"], e["backend"], int(e["m"]), int(e["n"]),
                       int(e["k"]), e["dtype"], e["policy"],
                       blocking.geometry_from_dict(e.get("geometry")),
                       tuple(str(a) for a in mesh) if mesh else None,
                       e.get("quant"))
                plan = blocking.plan_from_dict(e["plan"])
            except (KeyError, TypeError, ValueError, AttributeError):
                continue
            if key not in _TUNING_CACHE:
                _TUNING_CACHE[key] = plan
                count += 1
    return count

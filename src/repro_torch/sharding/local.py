"""Per-device *local* problem shapes under a mesh.

PolyDL's lesson is that loop/tile choices must track the actual working
set; under a production mesh every device executes a sharded local
problem, so tiles tuned for the global shape are tuned for a problem no
device runs.  This module computes the local view:

  * :func:`shard_count` / :func:`local_shape` apply one spec-like
    assignment to a shape with the same divisibility fallback the sharding
    rules use (a dim that does not divide over its axes replicates — it
    stays global, never raises),
  * :func:`default_axis_specs` maps every registered op's canonical
    (m, n, k) tuning triple onto mesh axes the way ``sharding.rules``
    shards the corresponding operands (GEMM rows follow the batch rule
    onto the DP axes, the out dim follows the column-parallel weight rule
    onto the model axis, the contraction dim stays gathered ZeRO-3-style),
  * :func:`local_problem` is what ``dispatch.resolve_blocks`` calls: the
    per-device (m, n, k) for an op under the active mesh, overridable per
    op via ``repro_torch.use(axis_specs={op: (m_axes, n_axes, k_axes)})`` —
    e.g. a row-parallel GEMM shards k on the model axis instead of n,
  * :func:`mesh_signature` is the tuning-cache tag: the mesh *axis names*
    (not sizes), so entries tuned per-shard transfer across mesh sizes
    exactly when the local problems coincide.

Only ``mesh.axis_names`` and ``mesh.shape`` are read, so a mesh of the
running world and a device-free one (see :func:`abstract_mesh`) are
interchangeable everywhere in this module and in dispatch.  The port of
``repro/sharding/local.py``, its arithmetic unchanged.
"""
from __future__ import annotations

from repro_torch.launch.mesh import Mesh, dp_axes

# The ops whose canonical triple is a plain GEMM (m rows, n out, k in).
GEMM_OPS = ("matmul", "brgemm", "batched_matmul")


def shard_count(dim: int, axes, mesh) -> int:
    """How many ways a dim of size ``dim`` shards over mesh ``axes``.

    Returns 1 (replicate) when ``axes`` is empty/None or when the dim does
    not divide over the combined axis size — the same fallback
    ``sharding.rules`` applies to params/activations, so per-dim the local
    problem dispatch tunes for matches what the partitioner would do (see
    the flattened-rows caveat on :func:`default_axis_specs`).
    Axis names absent from the mesh are skipped, so a spec written against
    the full production axis set (e.g. ``("pod", "data")``) degrades
    gracefully on single-pod or host-scale meshes.
    """
    if not axes:
        return 1
    size = 1
    for a in (axes if isinstance(axes, (tuple, list)) else (axes,)):
        if a is None or a not in mesh.axis_names:
            continue
        size *= mesh.shape[a]
    if size <= 1 or dim < size or dim % size != 0:
        return 1
    return size


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The per-device shape of a global ``shape`` under ``spec``.

    ``spec`` is spec-like: one entry per (leading) dim, each
    ``None`` / axis name / tuple of axis names; missing trailing entries
    replicate.  Non-divisible dims stay global (see :func:`shard_count`).
    """
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(int(d) // shard_count(int(d), ax, mesh)
                 for d, ax in zip(shape, spec))


def mesh_signature(mesh) -> tuple[str, ...]:
    """The tuning-cache tag for ``mesh``: its axis *names*.

    Sizes are deliberately excluded: the local problem already encodes
    them, so a cache tuned on a (4, 4) mesh transfers to a (16, 16) mesh
    whenever the per-device shapes coincide — and never collides with
    entries tuned without a mesh (signature ``None``).
    """
    return tuple(str(a) for a in mesh.axis_names)


def default_axis_specs(mesh) -> dict[str, tuple]:
    """Per-op canonical-triple axis assignments under ``mesh``.

    Derived from the ``sharding.rules`` conventions:

      * GEMM family ``(m, n, k)``: activation rows shard on the DP axes,
        the out dim on the model axis (the column-parallel ``param_spec``
        rule), and the contraction dim is compute-local — FSDP all-gathers
        it before the kernel runs.  Caveat: the canonical ``m`` is the
        *flattened* batch x seq product, so divisibility is checked on the
        product while ``batch_spec`` checks batch and seq separately — a
        product that divides when neither factor does (e.g. B=4, S=6 over
        8 DP ways) over-localizes; pass
        ``axis_specs={"matmul": (None, "model", None)}`` for such shapes.
      * conv2d ``(q, c, k)``: out channels follow the column-parallel rule
        onto the model axis; the per-row pixel walk stays local.
      * attention ``(tq, tk, d)``: the model axis shards *heads*, which are
        outside the triple, so the per-device triple equals the global one
        (sequence parallelism can be expressed via ``axis_specs=``).
    """
    dp = dp_axes(mesh) or None
    model = "model" if "model" in mesh.axis_names else None
    gemm = (dp, model, None)
    return {
        "matmul": gemm,
        "brgemm": gemm,
        "batched_matmul": gemm,
        "conv2d": (None, None, model),
        "flash_attention": (None, None, None),
        "flash_attention_bwd": (None, None, None),
    }


def local_problem(op: str, m: int, n: int, k: int, mesh,
                  axis_specs=None) -> tuple[int, int, int]:
    """The per-device (m, n, k) of ``op`` under ``mesh``.

    ``axis_specs`` (a mapping ``{op: (m_axes, n_axes, k_axes)}``) overrides
    the defaults per op — e.g. a row-parallel projection passes
    ``{"matmul": (dp_axes, None, "model")}`` so the *contraction* dim
    localizes instead of the out dim.  Dict-valued entries (the
    ``{"axes": ..., "backend": ...}`` form dispatch accepts) contribute
    their ``"axes"`` here; a backend-only pin keeps the default axes.
    """
    specs = default_axis_specs(mesh)
    for op_name, entry in (axis_specs or {}).items():
        axes = entry.get("axes") if isinstance(entry, dict) else entry
        if axes is not None or not isinstance(entry, dict):
            specs[op_name] = axes
    spec = specs.get(op)
    if spec is None:
        return int(m), int(n), int(k)
    return local_shape((int(m), int(n), int(k)), spec, mesh)


def abstract_mesh(shape, axes) -> Mesh:
    """A device-free mesh for local-shape math: axis names and sizes only
    (``launch.mesh.Mesh`` with no ``DeviceMesh``), so tests and the card
    can model a (16, 16) production mesh without 256 ranks."""
    return Mesh(shape, axes)

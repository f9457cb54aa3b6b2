"""Meshes: the port of ``repro/launch/mesh.py`` on ``torch.distributed``.

A ``Mesh`` names its axes and their sizes, as a ``jax`` mesh does:
``mesh.axis_names``, ``mesh.shape`` (a read-only mapping from axis to
size: ``mesh.shape["model"]``, ``mesh.shape.get("pod", 1)``) and
``mesh.size``.  A mesh of the running world (:func:`make_mesh` under an
initialised process group of ``prod(shape)`` ranks) also wraps the
``torch.distributed.device_mesh.DeviceMesh`` that ``init_device_mesh``
builds over it, holds this rank's coordinate, and hands out a process
group for any tuple of its axes (:meth:`Mesh.group`).  An *abstract*
mesh carries the names and sizes only (``sharding.local.abstract_mesh``,
:func:`make_production_mesh`): the shape arithmetic of
``sharding.local`` and dispatch reads nothing else, so a (16, 16)
deployment can be modelled on one card.  Ranks are laid out row-major
over the axes, as ``DeviceMesh`` and ``jax.make_mesh`` lay out devices.
Nothing here touches the process group at import.
"""
from __future__ import annotations

import itertools
import math
import types

import torch


class Mesh:
    """Axis names and sizes, and for a mesh of the running world its
    ``device_mesh``, this rank's ``coords`` and its process groups."""

    def __init__(self, shape, axes, *, device_mesh=None):
        shape, axes = tuple(int(s) for s in shape), tuple(str(a)
                                                          for a in axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"a mesh needs one size a distinct axis, got "
                             f"shape {shape} and axes {axes}")
        self.axis_names = axes
        self.shape = types.MappingProxyType(dict(zip(axes, shape)))
        self.device_mesh = device_mesh
        self._groups: dict[tuple[str, ...], object] = {}
        self.coords = None
        if device_mesh is not None:
            import torch.distributed as dist
            rank = dist.get_rank()
            self.coords = types.MappingProxyType(dict(zip(
                axes, (int(c) for c in _unravel(rank, shape)))))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def devices_shape(self) -> tuple[int, ...]:
        return tuple(self.shape.values())

    @property
    def is_abstract(self) -> bool:
        """Whether the mesh only models a layout (no running world)."""
        return self.device_mesh is None

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (a name or a tuple, major to
        minor), over the ones the mesh has."""
        idx = 0
        for a in _present(axes, self):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (a name or a tuple; names the mesh lacks are
        skipped).  Every group of a tuple of axes is made at its first
        request, on every rank at once (a collective call)."""
        axes = _present(axes, self)
        if axes not in self._groups:
            import torch.distributed as dist
            names = self.axis_names
            free = [a for a in names if a not in axes]
            cosets = []
            for fixed in itertools.product(*(range(self.shape[a])
                                             for a in free)):
                at = dict(zip(free, fixed))
                ranks = []
                for moving in itertools.product(*(range(self.shape[a])
                                                  for a in axes)):
                    at.update(zip(axes, moving))
                    ranks.append(_ravel([at[a] for a in names],
                                        self.devices_shape))
                cosets.append(ranks)
            self._groups[axes], _ = dist.new_subgroups_by_enumeration(cosets)
        return self._groups[axes]

    def __repr__(self) -> str:
        kind = "abstract " if self.is_abstract else ""
        return f"{kind}Mesh({dict(self.shape)})"


def _present(axes, mesh) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return tuple(a for a in axes if a is not None and a in mesh.axis_names)


def _ravel(coords, shape) -> int:
    idx = 0
    for c, s in zip(coords, shape):
        idx = idx * s + c
    return idx


def _unravel(rank: int, shape) -> list[int]:
    """``rank``'s coordinate on a row-major mesh of ``shape``."""
    out = []
    for s in reversed(shape):
        rank, c = divmod(rank, s)
        out.append(c)
    return out[::-1]


def make_mesh(shape, axes, *, device_type: str | None = None) -> Mesh:
    """A mesh of the running world: ``prod(shape)`` ranks of an
    initialised process group, over ``device_type`` (default: ``cuda``
    where the ranks see a card, else ``cpu``).  A one-rank shape with no process group is an abstract mesh
    (single-device runs).  Raises where the world's size differs."""
    import torch.distributed as dist
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        if math.prod(shape) == 1:
            return Mesh(shape, axes)
        raise ValueError(
            f"a mesh of {math.prod(shape)} ranks needs a running world of "
            f"as many (torch.distributed.init_process_group); "
            f"sharding.local.abstract_mesh models one without ranks")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = ("cuda" if torch.cuda.is_available() else "cpu")
    return Mesh(shape, axes, device_mesh=init_device_mesh(
        device_type, shape, mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout, (16, 16) ``(data, model)`` or
    (2, 16, 16) ``(pod, data, model)``, as an abstract mesh: no world of
    256 or 512 ranks runs here; dispatch tunes for its shards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(n_devices: int | None = None) -> Mesh:
    """A smoke-scale abstract ``(data, model)`` mesh of ``n_devices``
    (default: the running world's size, else the cards the host sees, at
    least one): the model axis takes the largest power of two up to 16
    that still leaves a data axis (8 -> (2, 4)), as the reference's."""
    if n_devices is None:
        import torch.distributed as dist
        n_devices = (dist.get_world_size() if dist.is_initialized()
                     else max(1, torch.cuda.device_count()))
    n = n_devices
    model = 1
    while model * 2 <= min(n // 2, 16) and n % (model * 2) == 0:
        model *= 2
    return Mesh((n // model, model), ("data", "model"))


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel / FSDP axes present in the mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= mesh.shape[a]
    return s


def model_size(mesh) -> int:
    return mesh.shape.get("model", 1)

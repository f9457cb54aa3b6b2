"""Atomic, async, keep-k checkpoints of the train state, in the reference's
on-disk layout.

Layout: ``<dir>/step_<n:08d>/shard_0.npz`` plus ``MANIFEST.json``, written
into a temporary directory and committed by renaming it, so a crash mid-way
never corrupts the latest checkpoint.  The arrays are keyed by the
reference's flattened paths of ``{"opt": {"step", "m", "v", "master"}}``
(``opt/master/blocks/attn/wq``, layers stacked), built through
``interop.opt_state_to_numpy``, so a checkpoint written by either package
restores in the other.  ``save_async`` copies the state to host memory
before it returns and writes on a background thread.

On a mesh of the running world (``mesh=``: the state is each rank's
shard, ``distributed/parallel.py``) ``save`` and ``save_async`` are
collective: every leaf is gathered whole and rank 0 writes it, so the
layout on disk stays the reference's.  ``restore(..., mesh=)`` slices
each leaf onto the mesh it is given, whatever mesh wrote it (the
reference's ``shardings=``), one rank or many.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading

import numpy as np

from repro_torch import interop
from repro_torch.configs.base import ArchCfg


def _flatten(tree, prefix="") -> dict:
    """Nested dicts -> {"a/b/c": array}, keys in sorted order (the
    reference's pytree order)."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            out.update(_flatten(tree[key], path + "/"))
        else:
            out[path] = np.asarray(tree[key])
    return out


def _unflatten(flat) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def _rank0(mesh) -> bool:
    return all(c == 0 for c in mesh.coords.values())


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for rank 0's write (no-op without)."""
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist
        dist.barrier()


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:08d}"

    @staticmethod
    def _host_tree(state, cfg=None, mesh=None) -> dict:
        if mesh is not None:
            from repro_torch.distributed import parallel
            state = parallel.gather_state(state, cfg, mesh)
            if not _rank0(mesh):
                return None
        return {"opt": interop.opt_state_to_numpy(state["opt"], cfg)}

    def _write(self, step: int, tree) -> None:
        flat = _flatten(tree)
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "shard_0.npz", **flat)
        (tmp / "MANIFEST.json").write_text(json.dumps({
            "step": step, "n_arrays": len(flat), "keys": sorted(flat)}))
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)          # atomic commit
        self._gc()

    def save(self, step: int, state, *, cfg: ArchCfg | None = None,
             mesh=None) -> None:
        """Writes the train state ``{"opt": ...}`` as checkpoint ``step``;
        on a mesh (a collective) every rank's shards, ``cfg``'s layout,
        written by rank 0, which the others wait for."""
        tree = self._host_tree(state, cfg, mesh)
        if tree is not None:
            self._write(step, tree)
        _barrier(mesh)

    def save_async(self, step: int, state, *, cfg: ArchCfg | None = None,
                   mesh=None) -> None:
        """Copies the state to host memory now (gathered whole on a mesh,
        a collective); writes in the background."""
        self.wait()
        tree = self._host_tree(state, cfg, mesh)
        if tree is None:
            return
        self._thread = threading.Thread(target=self._write,
                                        args=(step, tree), daemon=True)
        self._thread.start()

    def latest_step(self) -> int | None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        return steps[-1] if steps else None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, cfg: ArchCfg, step: int | None = None, *,
                device="cuda", mesh=None):
        """``(state, step)``: checkpoint ``step`` (default: the latest) as
        the port's train state on ``device``; on a mesh of the running
        world, this rank's shard of it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self._step_dir(step) / "shard_0.npz") as data:
            tree = _unflatten({k: data[k] for k in data.files})
        if mesh is None:
            return {"opt": interop.opt_state_from_numpy(tree["opt"], cfg,
                                                        device)}, step
        from repro_torch.distributed import parallel
        whole = {"opt": interop.opt_state_from_numpy(tree["opt"], cfg,
                                                     "cpu")}
        return parallel.shard_state(whole, cfg, mesh, device), step

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

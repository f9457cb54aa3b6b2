"""Training launcher: mesh, shards, data, checkpoints, resume.

Usage (CPU-scale; the default device is the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --steps 10 --batch 8 --seq 64 --device cpu [--mesh 2x2]

``--mesh DxM`` trains on a ``(data, model)`` mesh of D·M ranks (every
family, with ``--microbatches``; ``distributed/parallel.py``).  Under ``torchrun`` the ranks are
its processes; otherwise the CLI spawns them itself, each joining the
world through a file store in a fresh temporary directory.
``--dist-backend`` is ``nccl`` where each rank has a card of its own and
``gloo`` otherwise (several ranks on one card, or the CPU); the choice is
printed.  ``--mesh 1x1`` (the default) trains on one device with no world.
``--out PATH`` writes rank 0's record as JSON: the losses, the step times,
tokens/s, each rank's peak memory, the collective bytes by kind, and the
``resolve_blocks`` triples of the first step's forward.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import torch

from repro_torch import configs, obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.core import dispatch
from repro_torch.core.dispatch import check_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import rules
from repro_torch.sharding.annotate import use_rules
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


def _rank0(mesh) -> bool:
    return mesh is None or mesh.is_abstract or mesh.coords is None or \
        all(c == 0 for c in mesh.coords.values())


def forward_triples(tracer: obs.Tracer) -> list[dict]:
    """The ``resolve_blocks`` events of the ``train.forward`` spans a
    tracer holds, in order: op, m, n, k, and the mesh and axes fields
    where present."""
    spans = tracer.spans("train.forward")
    keep = ("op", "m", "n", "k", "mesh", "axes")
    return [{k: e.attrs[k] for k in keep if k in e.attrs}
            for e in tracer.events("resolve_blocks")
            if any(s.thread == e.thread and s.t0 <= e.t <= s.t1
                   for s in spans)]


def run(cfg, shape, *, steps: int, mesh=None, device="cuda", ckpt_dir=None,
        save_every: int = 50, microbatches: int = 1, log_every: int = 10,
        seed: int = 0, tracer: obs.Tracer | None = None, record=None):
    """Trains ``steps`` steps (resuming after the latest checkpoint in
    ``ckpt_dir`` if there is one); returns ``(state, losses)``, one loss per
    step run.  Weights are drawn from a CPU generator seeded ``seed``.

    ``mesh``: None (one device), an abstract mesh (one device, per-shard
    plans), or a mesh of the running world (this rank's part of the data
    x model parallel run; ``state`` is then its shard).  ``tracer``
    records the first step run.  ``record`` (a dict) gets each step's
    seconds (``step_s``) and the tokens a step trains."""
    device = check_device(device)
    ocfg = opt.AdamWCfg()
    step_fn = ts.make_train_step(cfg, ocfg, microbatches=microbatches,
                                 mesh=mesh)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    real = mesh is not None and not mesh.is_abstract
    rank0 = _rank0(mesh)
    say = print if rank0 else (lambda *a, **k: None)
    with use_rules(rules.activation_rules(mesh) if mesh is not None
                   else None, mesh):
        start = 0
        if ckpt and ckpt.latest_step() is not None:
            state, start = ckpt.restore(cfg, device=device,
                                        mesh=mesh if real else None)
            start += 1
            say(f"[train] resumed from step {start - 1}")
        else:
            state = ts.init_state(cfg, ocfg,
                                  torch.Generator().manual_seed(seed),
                                  device, mesh=mesh if real else None)
        pipe = TokenPipeline(cfg, shape, seed=seed, start_step=start)
        losses = []
        t0 = time.time()
        try:
            for step in range(start, steps):
                batch = next(pipe)
                t_step = time.perf_counter()
                with dispatch.use(tracer=tracer) if (
                        tracer is not None and step == start) else \
                        contextlib.nullcontext():
                    state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                if record is not None:
                    record.setdefault("step_s", []).append(
                        time.perf_counter() - t_step)
                    record["tokens_per_step"] = int(
                        shape.global_batch * batch["tokens"].shape[1])
                if step % log_every == 0 or step == steps - 1:
                    dt = time.time() - t0
                    tok_s = (step - start + 1) * shape.global_batch \
                        * batch["tokens"].shape[1] / max(dt, 1e-9)
                    say(f"[train] step {step} loss {losses[-1]:.4f} "
                        f"tokens/s {tok_s:,.0f}")
                if ckpt and step and step % save_every == 0:
                    ckpt.save_async(step, state, cfg=cfg,
                                    mesh=mesh if real else None)
            if ckpt:
                ckpt.wait()
        finally:
            pipe.close()
    return state, losses


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DxM"`` -> (D, M)."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text!r}: expected DATAxMODEL, e.g. 2x2")
    if d < 1 or m < 1:
        raise SystemExit(f"--mesh {text!r}: axes must be at least 1")
    return d, m


def dist_backend(choice: str, device: str, world: int) -> str:
    """``nccl`` where each of ``world`` ranks has a card of its own, else
    ``gloo`` (``choice`` other than ``auto`` is taken as it is)."""
    if choice != "auto":
        return choice
    if device.startswith("cuda") and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _rank_device(name: str) -> torch.device:
    """A rank's device: card ``rank % cards`` (set as the current one, as
    the device mesh and NCCL expect) where ``name`` is a card."""
    device = check_device(name)
    import torch.distributed as dist
    if device.type == "cuda" and dist.is_initialized():
        device = torch.device("cuda", dist.get_rank()
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def _train(args, cfg, shape, mesh, device) -> dict:
    """One rank's run of the CLI's arguments; rank 0's record."""
    tracer = obs.Tracer() if args.out else None
    record: dict = {}
    collectives.reset_counts()
    _, losses = run(cfg, shape, mesh=mesh, steps=args.steps, device=device,
                    ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
                    seed=args.seed, tracer=tracer, record=record,
                    save_every=args.save_every)
    peaks = [_peak_bytes(device)]
    if mesh is not None and not mesh.is_abstract:
        import torch.distributed as dist
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, peaks[0])
        peaks = got
    later = record.get("step_s", [])[1:] or record.get("step_s", [])
    step_s = statistics.median(later) if later else float("nan")
    return {
        "losses": losses, "step_s": record.get("step_s", []),
        "step_ms": step_s * 1e3,
        "tokens_per_s": record.get("tokens_per_step", 0) / step_s
        if later else None,
        "peak_bytes": peaks, "collectives": dict(collectives.COUNTS),
        "forward_triples": forward_triples(tracer) if tracer else [],
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "dist_backend": (torch.distributed.get_backend()
                         if mesh is not None and not mesh.is_abstract
                         else None),
        "device": str(device),
    }


def _world_rank(rank, world, init_method, backend, args_list):
    """A spawned rank: joins the world, trains, leaves."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        main(args_list)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_NAMES,
                    default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL: a (data, model) mesh of D*M ranks")
    ap.add_argument("--dist-backend", default="auto",
                    choices=("auto", "gloo", "nccl"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write rank 0's record (losses, times, triples) "
                         "as JSON")
    args = ap.parse_args(argv)
    d, m = parse_mesh(args.mesh)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeCfg("cli", "train", args.seq, args.batch)
    world = d * m

    import torch.distributed as dist
    if world > 1 and not dist.is_initialized():
        backend = dist_backend(args.dist_backend, args.device, world)
        if "RANK" in os.environ:      # under torchrun
            print(f"[train] dist backend {backend} (rank "
                  f"{os.environ['RANK']} of {world})", flush=True)
            dist.init_process_group(backend, init_method="env://")
            try:
                return main(argv)
            finally:
                dist.destroy_process_group()
        print(f"[train] dist backend {backend}: spawning {world} ranks",
              flush=True)
        store = tempfile.mkdtemp(prefix="repro_torch_world_")
        try:
            torch.multiprocessing.spawn(
                _world_rank, args=(world, f"file://{store}/store", backend,
                                   list(argv) if argv is not None
                                   else sys.argv[1:]),
                nprocs=world, join=True)
        finally:
            shutil.rmtree(store, ignore_errors=True)
        return None
    device = _rank_device(args.device)
    mesh = make_mesh((d, m), ("data", "model")) if dist.is_initialized() \
        else None
    rec = _train(args, cfg, shape, mesh, device)
    if _rank0(mesh):
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rec, f)
        print(f"[train] first loss {rec['losses'][0]:.4f} -> last "
              f"{rec['losses'][-1]:.4f}", flush=True)
    return rec


if __name__ == "__main__":
    main()

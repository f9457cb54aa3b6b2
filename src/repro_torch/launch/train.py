"""Training launcher, single device: data, train step, checkpoints, resume.

Usage (CPU-scale; the default device is the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --steps 10 --batch 8 --seq 64 --device cpu

The reference's launcher also builds a mesh and shards the state over it;
that waits for the distributed port, so ``--mesh`` takes ``1x1`` only.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.core.dispatch import check_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


def run(cfg, shape, *, steps: int, device="cuda", ckpt_dir=None,
        save_every: int = 50, microbatches: int = 1, log_every: int = 10,
        seed: int = 0):
    """Trains ``steps`` steps (resuming after the latest checkpoint in
    ``ckpt_dir`` if there is one); returns ``(state, losses)``, one loss per
    step run.  Weights are drawn from a CPU generator seeded ``seed``."""
    device = check_device(device)
    ocfg = opt.AdamWCfg()
    step_fn = ts.make_train_step(cfg, ocfg, microbatches=microbatches)
    state = ts.init_state(cfg, ocfg, torch.Generator().manual_seed(seed),
                          device)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        state, start = ckpt.restore(cfg, device=device)
        start += 1
        print(f"[train] resumed from step {start - 1}")

    pipe = TokenPipeline(cfg, shape, seed=seed, start_step=start)
    losses = []
    t0 = time.time()
    try:
        for step in range(start, steps):
            batch = next(pipe)
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            if step % log_every == 0 or step == steps - 1:
                dt = time.time() - t0
                tok_s = (step - start + 1) * shape.global_batch \
                    * batch["tokens"].shape[1] / max(dt, 1e-9)
                print(f"[train] step {step} loss {losses[-1]:.4f} "
                      f"tokens/s {tok_s:,.0f}")
            if ckpt and step and step % save_every == 0:
                ckpt.save_async(step, state)
        if ckpt:
            ckpt.wait()
    finally:
        pipe.close()
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_NAMES,
                    default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; only 1x1 (one device) is ported")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise SystemExit(f"--mesh {args.mesh}: only 1x1 is ported; meshes "
                         f"wait for the distributed port")

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeCfg("cli", "train", args.seq, args.batch)
    _, losses = run(cfg, shape, steps=args.steps, device=args.device,
                    ckpt_dir=args.ckpt_dir, microbatches=args.microbatches)
    print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()

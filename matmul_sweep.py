"""Time the matmul kernel at every GEMM shape of the port's main paths.

    python3 matmul_sweep.py [--src DIR] [--label NAME] [--variants]

Each shape's operands lie as the path hands them over: smollm-135m's serving
and training GEMMs (chip_smoke.py's main_path_gemms and train_gemms),
ResNet-50's weight gradients at N = 32 through the package's own window
operand (conv2d.ops.patches) and its head.  Per shape: the device time of a
call (profiler; operands cycled past the L2, chip_smoke.time_ms) beside
torch.matmul's on the same inputs and the bound; the wall time a call back
to back (CUDA events: where the device time is small, the host's cost of a
call); the plan the package chose.  --src imports repro_torch from another
checkout's src, so that an earlier commit's kernel is timed on the same
card in the same run; --variants also times each shape that has few output
tiles under other split targets (one wave of 132 blocks, two, four, and no
split).  One JSON line a shape, then the card's name and power limit.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

import chip_smoke as CS

TARGETS = (132, 264, 528)      # split blocks a variant aims at


def smollm_shapes(cfg, gen):
    for g in CS.main_path_gemms(cfg) + CS.train_gemms(cfg):
        nbytes = (g.m * g.k + g.k * g.n) * 2 + g.m * g.n * 2
        sets = [CS.gemm_inputs(g, torch.bfloat16, gen)
                for _ in range(CS.n_sets(nbytes))]
        yield (g.name, g.m, g.k, g.n, sets,
               dict(activation=g.activation, out_dtype=g.out_dtype))


def resnet_shapes(cfg, patches, gen):
    bf = torch.bfloat16
    for cv in CS.unique_convs(CS.resnet_convs(cfg)):
        sets = []
        for _ in range(2):
            x = torch.randn(CS.RESNET_BATCH, cv.h, cv.h, cv.c, device="cuda",
                            generator=gen).to(bf)
            cols = patches(x, cv.r, cv.r, cv.stride, cv.padding)
            g = torch.randn(cols.size(0), cv.k, device="cuda",
                            generator=gen).to(bf)
            sets.append((cols.T, g))
        m, k = sets[0][0].shape
        yield (f"resnet.wgrad.{cv.name} x{cv.count}", m, k, cv.k, sets,
               dict(out_dtype=torch.float32))
    b, c, k = CS.RESNET_BATCH, 4 * 8 * cfg.width, cfg.n_classes
    for name, m, kk, n, make in (
            ("resnet.head.fwd", b, c, k, lambda x, w, g: (x, w)),
            ("resnet.head.dx", b, k, c, lambda x, w, g: (g, w.T)),
            ("resnet.head.dw", c, b, k, lambda x, w, g: (x.T, g))):
        sets = []
        for _ in range(8):
            x = torch.randn(b, c, device="cuda", generator=gen).to(bf)
            w = (torch.randn(c, k, device="cuda", generator=gen)
                 * c ** -0.5).to(bf)
            g = torch.randn(b, k, device="cuda", generator=gen).to(bf)
            sets.append(make(x, w, g))
        yield name, m, kk, n, sets, {}


def variants(K, x, w):
    """Other plans of the same mainloop and tile: the splits that aim at
    each of TARGETS blocks, and no split."""
    p = K.plan_call(x, w)
    slices = -(-x.size(1) // p.bk)
    out = {}
    for target in TARGETS:
        splits = max(1, min(target // p.tiles, slices))
        chunk = -(-slices // splits)
        out[f"blocks{target}"] = dataclasses.replace(
            p, splits=-(-slices // chunk), chunk=chunk)
    out["no_split"] = dataclasses.replace(p, splits=1, chunk=slices)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", help="import repro_torch from this src dir")
    ap.add_argument("--label", default="", help="tag of every line")
    ap.add_argument("--variants", action="store_true",
                    help="also time other split targets")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("matmul_sweep: no CUDA device")
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get
    from repro_torch.kernels.brgemm import kernel as K
    from repro_torch.kernels.conv2d.ops import patches
    from repro_torch.models.resnet import ResNetCfg
    torch.backends.cuda.matmul.allow_tf32 = False
    card = CS.card_line()
    gen = torch.Generator(device="cuda").manual_seed(CS.SEED + 8)
    shapes = list(smollm_shapes(get("smollm-135m"), gen))
    shapes += list(resnet_shapes(ResNetCfg(), patches, gen))
    for name, m, k, n, sets, kw in shapes:
        def call(x, w):
            return K.matmul_cuda(x, w, **kw)
        ms, wall = CS.time_ms(call, sets)
        lib, _ = CS.time_ms(torch.matmul, sets)
        out_bytes = 4 if kw.get("out_dtype") == torch.float32 else 2
        bms, by = CS.bound(2 * m * n * k, 2 * (m * k + k * n)
                           + out_bytes * m * n, card)
        rec = {"label": args.label, "shape": name, "m": m, "k": k, "n": n,
               "ms": ms, "wall_ms": wall, "library_ms": lib,
               "ratio": ms / lib,
               "bound_ms": bms, "bound_by": by}
        if hasattr(K, "plan_call"):
            p = K.plan_call(*sets[0])
            rec["plan"] = {"mainloop": p.mainloop, "bm": p.bm,
                           "splits": p.splits, "chunk": p.chunk}
            if args.variants and 2 * p.tiles <= K.SMS:
                real = K.plan
                rec["variants_ms"] = {}
                for vname, vp in variants(K, *sets[0]).items():
                    K.plan = lambda *_, _p=vp: _p
                    try:
                        ms_v = CS.time_ms(call, sets)[0]
                    finally:
                        K.plan = real
                    rec["variants_ms"][vname] = [ms_v, vp.splits]
        print(json.dumps(rec), flush=True)
        del sets
    print(card, flush=True)


if __name__ == "__main__":
    main()

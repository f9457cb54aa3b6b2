"""Time the matmul kernel at every GEMM shape of the port's main paths, the
flash forward at the prefill shape, the flash backward at the training
shape, and batched_matmul and brgemm_stacked at the paper's cases.

    python3 matmul_sweep.py [--src DIR] [--label NAME] [--variants]

Each shape's operands lie as the path hands them over: smollm-135m's serving
and training GEMMs (chip_smoke.py's main_path_gemms and train_gemms),
ResNet-50's weight gradients at N = 32 through the package's own window
operand (conv2d.ops.patches) and its head; the flash forward on the
attention layer's head-split views at the prefill shape (B = 8, Hq = 9,
Hkv = 3, T = 512, d = 64, causal); the flash backward at the training
shape (the same views, B = 8, T = 512, from the forward kernel's residuals,
dY a view of the merged heads' gradient); batched_matmul at each of
chip_smoke.py's BRGEMM_CASES, as batched_matmul's own call and as brgemm's
backward's two products (g broadcast with B_i^T, A_i^T with g), and
brgemm_stacked at each.  Per shape: the device time of a call (a CUDA graph
of calls, operands cycled past the L2, chip_smoke.time_ms) beside one
PyTorch call's on the same inputs (torch.matmul, scaled_dot_product_attention,
its backward through autograd, whose kernels the profiler names, or
torch.einsum) and the bound; the wall
time a call back to back (CUDA events: where the device time is small, the
host's cost of a call); the plan the package chose.  --src imports
repro_torch from another checkout's src, so that an earlier commit's
kernels are timed on the same card in the same run; --variants also times
each matmul shape that has few output tiles under other split targets (one
wave of 132 blocks, two, four, and no split).  One JSON line a shape, then
the card's name and power limit.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
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


def flash_rows(args, card, gen, cfg):
    """The flash forward at the prefill shape, beside SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    b, hq, hkv, t, d = CS.BATCH, cfg.n_heads, cfg.n_kv_heads, CS.PROMPT, \
        cfg.dh
    nbytes = 2 * (2 * b * hq * t * d + 2 * b * hkv * t * d)
    sets = [CS.qkv_views(b, hq, hkv, t, d, torch.bfloat16, gen)[:3]
            for _ in range(CS.n_sets(nbytes))]
    ms, wall = CS.time_ms(lambda q, k, v: FK.flash_attention_cuda(q, k, v),
                          sets)
    lib, _ = CS.time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), sets)
    bms, by = CS.bound(4 * b * hq * (t * (t + 1) // 2) * d, nbytes, card)
    rec = {"label": args.label, "kernel": "flash_attention",
           "shape": f"prefill q{[b, hq, t, d]} kv{[b, hkv, t, d]} causal",
           "ms": ms, "wall_ms": wall, "library_ms": lib, "ratio": ms / lib,
           "bound_ms": bms, "bound_by": by}
    if hasattr(FK, "plan_call"):
        rec["plan"] = {"mainloop": FK.plan_call(*sets[0])}
    print(json.dumps(rec), flush=True)


def flash_bwd_rows(args, card, gen, cfg):
    """The flash backward at the training shape, beside SDPA's backward
    (autograd of scaled_dot_product_attention, which a CUDA graph cannot
    capture: the profiler's sum of its kernels, named in the row)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import bwd as FB
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    b, hq, hkv, t, d = CS.TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, \
        CS.TRAIN_SEQ, cfg.dh
    q_bytes, kv_bytes = 2 * b * hq * t * d, 2 * b * hkv * t * d
    # q, k, v, y, dY and lse in; dq, dk, dv out
    nbytes = 4 * q_bytes + 4 * kv_bytes + 4 * b * hq * t
    sets, lib_sets = [], []
    for _ in range(CS.n_sets(nbytes)):
        q, k, v, dy = CS.qkv_views(b, hq, hkv, t, d, torch.bfloat16, gen)
        o, lse = flash_attention_cuda(q, k, v, return_residuals=True)
        sets.append((q, k, v, o, lse, dy))
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        lib_sets.append((out, leaves, dy))
    ms, wall = CS.time_ms(FB.flash_attention_bwd_cuda, sets)

    def sdpa_bwd(out, leaves, dy):
        return torch.autograd.grad(out, leaves, dy, retain_graph=True)

    lib, _ = CS.time_ms(sdpa_bwd, lib_sets)
    by_name = CS.device_ms_by_kernel(
        lambda: [sdpa_bwd(*x) for x in lib_sets], len(lib_sets))
    bms, by = CS.bound(10 * b * hq * (t * (t + 1) // 2) * d, nbytes, card)
    rec = {"label": args.label, "kernel": "flash_attention_bwd",
           "shape": f"train q{[b, hq, t, d]} kv{[b, hkv, t, d]} causal",
           "ms": ms, "wall_ms": wall, "library_ms": lib, "ratio": ms / lib,
           "bound_ms": bms, "bound_by": by,
           "library_kernels_ms": {k[:90]: v for k, v in by_name.items()}}
    if hasattr(FB, "plan_call"):
        rec["plan"] = {"mainloop": FB.plan_call(*sets[0][:4], sets[0][5])}
    print(json.dumps(rec), flush=True)


def stacked_rows(args, card, gen):
    """brgemm_stacked at each of BRGEMM_CASES, beside torch.einsum."""
    from repro_torch.kernels.brgemm import kernel as K
    bf = torch.bfloat16
    for nb, m, k, n in CS.BRGEMM_CASES:
        nbytes = 2 * (nb * m * k + nb * k * n + m * n)
        sets = [(torch.randn(nb, m, k, device="cuda", generator=gen).to(bf),
                 (torch.randn(nb, k, n, device="cuda", generator=gen)
                  * (nb * k) ** -0.5).to(bf))
                for _ in range(CS.n_sets(nbytes))]
        ms, wall = CS.time_ms(K.brgemm_stacked_cuda, sets)
        lib, _ = CS.time_ms(lambda a, b: torch.einsum("imk,ikn->mn", a, b),
                            sets)
        bms, by = CS.bound(2 * nb * m * k * n, nbytes, card)
        rec = {"label": args.label, "kernel": "brgemm_stacked",
               "shape": f"B{nb} m{m} k{k} n{n}", "ms": ms, "wall_ms": wall,
               "library_ms": lib, "ratio": ms / lib, "bound_ms": bms,
               "bound_by": by}
        if hasattr(K, "plan_stacked_call"):
            p = K.plan_stacked_call(*sets[0])
            rec["plan"] = {"mainloop": p.mainloop, "bm": p.bm,
                           "splits": p.splits, "chunk": p.chunk}
        print(json.dumps(rec), flush=True)
        del sets


def batched_rows(args, card, gen):
    """batched_matmul at each of BRGEMM_CASES, its own call and brgemm's
    backward's two products, beside torch.matmul."""
    from repro_torch.kernels.brgemm import kernel as K
    bf = torch.bfloat16
    for nb, m, k, n in CS.BRGEMM_CASES:
        per = 2 * (nb * m * k + nb * k * n + m * n)
        base = []
        for _ in range(CS.n_sets(per)):
            a = torch.randn(nb, m, k, device="cuda", generator=gen).to(bf)
            bb = (torch.randn(nb, k, n, device="cuda", generator=gen)
                  * (nb * k) ** -0.5).to(bf)
            g = torch.randn(m, n, device="cuda", generator=gen).to(bf)
            base.append((a, bb, g))
        for name, make, mats in (
                ("A_i @ B_i", lambda a, bb, g: (a, bb),
                 ((nb, m, k), (nb, k, n), (nb, m, n))),
                ("dA = g @ B_i^T", lambda a, bb, g: (g, bb.transpose(1, 2)),
                 ((m, n), (nb, k, n), (nb, m, k))),
                ("dB = A_i^T @ g", lambda a, bb, g: (a.transpose(1, 2), g),
                 ((nb, m, k), (m, n), (nb, k, n)))):
            sets = [make(*t) for t in base]
            ms, wall = CS.time_ms(K.batched_matmul_cuda, sets)
            lib, _ = CS.time_ms(torch.matmul, sets)
            nbytes = 2 * sum(math.prod(x) for x in mats)
            bms, by = CS.bound(2 * nb * m * k * n, nbytes, card)
            rec = {"label": args.label, "kernel": "batched_matmul",
                   "shape": f"{name} B{nb} m{m} k{k} n{n}", "ms": ms,
                   "wall_ms": wall, "library_ms": lib, "ratio": ms / lib,
                   "bound_ms": bms, "bound_by": by}
            if hasattr(K, "plan_batched_call"):
                p = K.plan_batched_call(*sets[0])
                rec["plan"] = {"mainloop": p.mainloop, "bm": p.bm}
            print(json.dumps(rec), flush=True)
            del sets
        del base


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
        rec = {"label": args.label, "kernel": "matmul", "shape": name,
               "m": m, "k": k, "n": n,
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
    flash_rows(args, card, gen, get("smollm-135m"))
    flash_bwd_rows(args, card, gen, get("smollm-135m"))
    batched_rows(args, card, gen)
    stacked_rows(args, card, gen)
    print(card, flush=True)


if __name__ == "__main__":
    main()

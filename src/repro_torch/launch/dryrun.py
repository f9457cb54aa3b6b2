"""Per-shard plans of a cell: the part of ``repro/launch/dryrun.py`` that
does not lower through XLA.

For one (arch x shape) cell and a mesh, :func:`cell_problems` lists the
hot canonical problems with the axes the sharding rules put on each
triple, and :func:`block_choices` resolves each plan twice: once for the
global shape (no mesh) and once through mesh-aware dispatch
(``use(mesh=..., axis_specs=...)``, which localises the triple first),
recording both with the local problem.  So the table shows where a plan
chosen for the global shape would run a shard no device runs.  The
reference's lowering (``lower_cell``: memory, cost and collective
accounts of the compiled program) and ``launch/{costs,roofline}.py`` are
not ported yet (ROADMAP queue 1, item 6.5).

Usage (no card needed under the default heuristic policy):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --blocks-smoke \
      [--arch smollm-135m] [--shape decode_32k] [--devices 8]
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import blocking, dispatch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import local as shlocal


def cell_problems(cfg, shape):
    """The cell's hot canonical tuning problems, with the axis assignment
    the sharding rules induce on each triple.

    One row per projection family: column-parallel GEMMs (qkv / mlp-up)
    shard rows on the DP axes and the out dim on the model axis;
    row-parallel GEMMs (attn-out / mlp-down) shard the *contraction* dim
    on the model axis instead; attention's triple stays head-sharded
    (local == global).  Returns ``(name, op, (m, n, k), axis_spec)``.
    """
    dp = ("pod", "data")  # shard_count skips axes absent from the mesh
    model = "model" if cfg.tp else None
    decode = shape.kind == "decode"
    rows = shape.global_batch * (1 if decode else shape.seq_len)
    d, dh = cfg.d_model, cfg.dh
    n_q = cfg.n_heads * dh
    probs = [
        ("attn_qkv", "matmul", (rows, n_q, d), (dp, model, None)),
        ("attn_out", "matmul", (rows, d, n_q), (dp, None, model)),
    ]
    if cfg.d_ff:
        probs += [
            ("mlp_up", "matmul", (rows, cfg.d_ff, d), (dp, model, None)),
            ("mlp_down", "matmul", (rows, d, cfg.d_ff), (dp, None, model)),
        ]
    if cfg.moe_d_ff:
        probs.append(("moe_up", "brgemm",
                      (rows, cfg.moe_d_ff, d), (dp, model, None)))
    tq = 1 if decode else shape.seq_len
    probs.append(("attention", "flash_attention",
                  (tq, shape.seq_len, dh), (None, None, None)))
    return probs


def block_choices(cfg, shape, mesh, dtype=None, *, backend: str = "cuda"):
    """Per-shard against global-shape plan resolution for one cell.

    For each hot problem the plan is resolved twice, against the global
    shape (no mesh) and through mesh-aware dispatch, under the active
    block policy (the heuristic by default; ``use(blocks_policy=
    "autotune")`` measures both on the card).  Returns one record a
    problem: name, op, dtype, ``global`` and ``local`` triples, both
    plans and whether they differ."""
    dtype = blocking.as_dtype(dtype or cfg.dtype)
    out = []
    for name, op, (m, n, k), spec in cell_problems(cfg, shape):
        plan_global = dispatch.resolve_blocks(op, m, n, k, dtype,
                                              backend=backend)
        with dispatch.use(mesh=mesh, axis_specs={op: spec}):
            local = shlocal.local_problem(op, m, n, k, mesh,
                                          axis_specs={op: spec})
            plan_local = dispatch.resolve_blocks(op, m, n, k, dtype,
                                                 backend=backend)
        out.append({
            "name": name, "op": op, "dtype": blocking.dtype_name(dtype),
            "global": [m, n, k], "local": list(local),
            "blocks_global": blocking.plan_to_dict(plan_global),
            "blocks_local": blocking.plan_to_dict(plan_local),
            "differs": plan_local != plan_global,
        })
    return out


def blocks_smoke(arch: str, shape_name: str, n_devices: int = 8) -> int:
    """One (arch x shape x host-mesh) cell through mesh-aware dispatch.
    Prints the ``resolved_blocks`` record; returns 0 iff at least one
    per-shard choice differs from the global-shape choice."""
    mesh = make_host_mesh(n_devices)
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh_axes": {str(a): int(mesh.shape[a]) for a in mesh.axis_names},
        "n_devices": mesh.size,
        "resolved_blocks": block_choices(cfg, shape, mesh),
    }
    print(json.dumps(rec, indent=1))
    n_diff = sum(r["differs"] for r in rec["resolved_blocks"])
    print(f"[dryrun-smoke] problems={len(rec['resolved_blocks'])} "
          f"per_shard_differs={n_diff}")
    return 0 if n_diff else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_NAMES,
                    default="smollm-135m")
    ap.add_argument("--shape", choices=tuple(SHAPES), default="decode_32k")
    ap.add_argument("--devices", type=int, default=8,
                    help="the host mesh's size (launch.mesh.make_host_mesh)")
    ap.add_argument("--blocks-smoke", action="store_true",
                    help="resolve one cell's plans per shard on a host mesh "
                         "and fail unless one differs from the global pick")
    args = ap.parse_args(argv)
    if not args.blocks_smoke:
        raise SystemExit("only --blocks-smoke is ported: the lowering, cost "
                         "and roofline accounts wait (ROADMAP queue 1, "
                         "item 6.5)")
    sys.exit(blocks_smoke(args.arch, args.shape, args.devices))


if __name__ == "__main__":
    main()

"""GPipe-style pipeline parallelism over a mesh's ``"stage"`` axis: the
port of ``repro/distributed/pipeline.py``.

The layer stack is split into S stages, one a rank of the axis; each
microbatch flows stage -> stage by point-to-point send and receive.  The
schedule is the reference's GPipe loop of (S + M - 1) ticks for M
microbatches: stage s computes microbatch m at tick s + m, then every
stage passes its output to the next (a ring, as the reference's
``ppermute``: the last stage's send to stage 0 is ignored there).  At the
end each stage returns the last stage's outputs, summed over the stages
(the others contribute zeros), as the reference's ``psum``.
"""
from __future__ import annotations

import torch


def pipeline_apply(stage_params, x, layer_fn, *, mesh,
                   n_microbatches: int, axis: str = "stage"):
    """Run ``layer_fn(params, x)`` as a pipeline over mesh axis ``axis``
    of a mesh of the running world.

    stage_params: ``{name: tensor}`` whose leaves have a leading stage dim
    (every rank passes the whole; it runs its stage's slice); x: (M, mb,
    ...) the microbatched global input, the same on every rank.  Returns y
    with the same shape as x, on every rank.
    """
    import torch.distributed as dist
    n_stages = mesh.shape[axis]
    m = n_microbatches
    if x.shape[0] != m:
        raise ValueError(f"x holds {x.shape[0]} microbatches, expected {m}")
    group = mesh.group(axis)
    stage = mesh.index(axis)
    ranks = dist.get_process_group_ranks(group)
    nxt, prev = ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages]
    params = {k: v[stage] for k, v in stage_params.items()}

    buf = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    for t in range(n_stages + m - 1):
        mb = t - stage
        active = 0 <= mb < m
        inp = x[min(t, m - 1)] if stage == 0 else buf
        y = layer_fn(params, inp) if active else buf
        if active and stage == n_stages - 1:
            outputs[mb] = y
        if n_stages > 1:
            recv = torch.empty_like(buf)
            reqs = [dist.isend(y.contiguous(), nxt, group=group),
                    dist.irecv(recv, prev, group=group)]
            for r in reqs:
                r.wait()
            buf = recv
        else:
            buf = y
    if stage != n_stages - 1:
        outputs.zero_()
    dist.all_reduce(outputs, group=group)
    return outputs

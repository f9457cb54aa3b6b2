"""AdamW with an fp32 master copy, as in the reference's ``train/optimizer``.

The optimizer state mirrors the parameters by name (``model.
named_parameters()``): ``{"step": int, "m": {...}, "v": {...},
"master": {...}}``, with the fp32 master copy kept apart from the working
(compute-dtype) parameters, which ``cast_params`` rewrites from it.  The
update is the reference's, not ``torch.optim.AdamW``'s: gradients are cast
to fp32 and clipped by the global norm of all of them, the bias
corrections use the incremented step, ``eps`` sits outside the square
root, and weight decay is applied to the master inside the same step.
Where the reference builds new arrays, this updates ``m``, ``v`` and
``master`` in place (``torch._foreach_*``), so the state costs no second
copy.

SGDM (``SGDMCfg``, ``sgdm_init``, ``sgdm_update``) is the reference's too,
for the paper's LSTM workloads: the gradients clipped by the global norm of
the raw gradients, weight decay added to the gradient, an fp32 momentum,
and the parameters (no master copy) updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamWCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWCfg) -> dict:
    mdt = getattr(torch, cfg.moment_dtype)
    with torch.no_grad():
        return {
            "step": 0,
            "m": {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
                  for n, p in params.items()},
            "master": {n: p.detach().float().clone()
                       for n, p in params.items()},
        }


def global_norm(tensors, *, replicas=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32 (0-d tensor).

    On a mesh each rank passes its shards, ``replicas`` (one count a
    tensor, in order) the ranks that hold each of a shard's elements, and
    ``group`` (a ``collectives.AxisGroup`` of every rank): the squares are
    summed over the ranks, each replicated element counted once."""
    tensors = list(tensors.values() if isinstance(tensors, Mapping)
                   else tensors)
    norms = torch._foreach_norm([t.float() for t in tensors])
    if (group is None or group.size == 1) and all(
            r == 1 for r in (replicas or ())):
        return torch.linalg.vector_norm(torch.stack(norms))
    from repro_torch.distributed.collectives import all_reduce
    sq = torch.stack(norms).square()
    if replicas is not None:
        sq = sq / torch.tensor(list(replicas), dtype=sq.dtype,
                               device=sq.device)
    return all_reduce(sq.sum(), group).sqrt()


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: dict,
                 cfg: AdamWCfg, lr_scale: float = 1.0, *, replicas=None,
                 group=None):
    """Returns ``(new_state, metrics)``; ``m``, ``v`` and ``master`` are
    updated in place and carried into the new state.  On a mesh the state
    and ``grads`` are a rank's shards, ``replicas`` ({name: ranks that
    hold each element}) and ``group`` (every rank) give the clipping norm
    over all of them (:func:`global_norm`)."""
    names = list(state["master"])
    step = state["step"] + 1
    g32 = [grads[n].float() for n in names]
    gnorm = global_norm(g32, group=group, replicas=(
        None if replicas is None else [replicas[n] for n in names]))
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    g32 = torch._foreach_mul(g32, clip)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    lr = cfg.lr * lr_scale

    m = [state["m"][n] for n in names]
    v = [state["v"][n] for n in names]
    master = [state["master"][n] for n in names]
    m32 = [t.float() for t in m]      # the same tensors when moments are fp32
    v32 = [t.float() for t in v]
    torch._foreach_mul_(m32, cfg.b1)
    torch._foreach_add_(m32, g32, alpha=1 - cfg.b1)
    torch._foreach_mul_(v32, cfg.b2)
    torch._foreach_addcmul_(v32, g32, g32, value=1 - cfg.b2)
    denom = torch._foreach_div(v32, b2c)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(m32, b1c)
    torch._foreach_div_(upd, denom)
    torch._foreach_add_(upd, master, alpha=cfg.weight_decay)
    torch._foreach_add_(master, upd, alpha=-lr)
    for dst, src in zip(m + v, m32 + v32):
        if dst is not src:
            dst.copy_(src)
    new_state = {"step": step, "m": state["m"], "v": state["v"],
                 "master": state["master"]}
    return new_state, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def cast_params(state: dict, params: Mapping[str, torch.Tensor]):
    """Working (compute-dtype) params from the fp32 master copy, written in
    place into ``params`` (name -> tensor); returns ``params``."""
    for n, p in params.items():
        p.copy_(state["master"][n])
    return params


@dataclasses.dataclass(frozen=True)
class SGDMCfg:
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip: float = 0.0


def sgdm_init(params: Mapping[str, torch.Tensor], cfg: SGDMCfg) -> dict:
    """``{"step": 0, "mom": {name: fp32 zeros}}``."""
    return {"step": 0,
            "mom": {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()}}


@torch.no_grad()
def sgdm_update(params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor], state: dict,
                cfg: SGDMCfg, lr_scale: float = 1.0):
    """Returns ``(params, new_state, {"grad_norm"})``, in the reference's
    order of operations: ``scale = min(1, clip / (gnorm + 1e-9))`` (when
    clipping), ``g32 = g * scale + wd * p``, ``m = mu * m + g32``, ``p =
    p32 - lr * lr_scale * m`` cast back to the parameter's dtype.  The
    parameters and the momentum are updated in place."""
    names = list(state["mom"])
    gnorm = global_norm([grads[n] for n in names])
    g32 = [grads[n].float() for n in names]
    if cfg.grad_clip:
        g32 = torch._foreach_mul(
            g32, torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0))
    p = [params[n] for n in names]
    p32 = [t.float() for t in p]      # the same tensors when fp32
    if cfg.weight_decay:
        torch._foreach_add_(g32, torch._foreach_mul(p32, cfg.weight_decay))
    mom = [state["mom"][n] for n in names]
    torch._foreach_mul_(mom, cfg.momentum)
    torch._foreach_add_(mom, g32)
    torch._foreach_sub_(p32, torch._foreach_mul(mom, cfg.lr * lr_scale))
    for dst, src in zip(p, p32):
        if dst is not src:
            dst.copy_(src)
    return params, {"step": state["step"] + 1, "mom": state["mom"]}, {
        "grad_norm": gnorm}

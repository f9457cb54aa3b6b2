"""The train step: working params from the master copy -> loss -> grads ->
(microbatch accumulation) -> AdamW update, as in the reference's
``train/train_step``.

The state is ``{"opt": adamw state}``, the reference's tree.  The working
parameters are a model in ``cfg.dtype`` (a ``Transformer``, or the
encoder-decoder's ``EncDec``, whose batches also carry ``src_embeds``)
that the step builds once on the master copy's device and rewrites from
the master at the start of every step; gradients are taken with respect to it by autograd, so in bf16
training they are bf16, as in the reference, and the optimizer casts them to
fp32.  With microbatches they are summed in fp32 and divided by their
count.  The learning-rate scale reads the step *before* the update
increments it, so the first update has lr = 0, as in the reference.
``backend``, ``blocks_policy`` and ``accum_dtype`` scope the forward and
the backward (the kernels' backward passes re-enter the forward's dispatch
state, ``dispatch.restored``): under ``accum_dtype="bfloat16"`` the
forward kernels and the flash backward round their sums at the
reference's block ends, the GEMMs' and convolution's backward stay fp32,
as in the reference.  ``cfg.remat`` checkpoints each decoder block
(``models/transformer.py``): memory, not numbers.  ``grad_compression``
(``"bf16"`` or ``"int8"``) quantizes and dequantizes the gradients between
the backward and AdamW, which then takes them in fp32, as the reference's
step does (``distributed/collectives.py``); an int8 scale covers a leaf of
the reference's tree, every layer of a stack (``interop.stacked_leaves``).

``mesh`` (default: the mesh the launcher installed,
``sharding.annotate.current_mesh``, read at each step as the reference
reads it at trace time) and ``axis_specs`` scope dispatch, so plans are
chosen for the shard (``dispatch.resolve_blocks``).  On an abstract mesh
the step runs the global problem on one device, as the reference's does
under GSPMD's view of a layout.  On a mesh of the running world
(``launch.mesh.make_mesh``) the step is the data x model parallel
executor's (``distributed/parallel.py``; every family, with
``microbatches`` and ``grad_compression`` as here): the state is this
rank's shard (``init_state(..., mesh=)``), the batch the global one, the
loss the global mean.
"""
from __future__ import annotations

import torch

from repro_torch import interop, obs
from repro_torch.configs.base import ArchCfg
from repro_torch.core import dispatch
from repro_torch.distributed.collectives import (KINDS, compress_grads,
                                                 decompress_grads)
from repro_torch.models import api
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import Transformer
from repro_torch.sharding import annotate
from repro_torch.train import optimizer as opt
from repro_torch.train.schedule import warmup_cosine


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(model: Transformer | EncDec, batch, cfg: ArchCfg):
    """``(metrics, grads)``: the loss's metrics (0-d tensors) and the
    gradient of every parameter, by name, in the parameter's dtype."""
    for p in model.parameters():
        p.grad = None
    with obs.span("train.forward"):
        loss, metrics = api.loss_fn(model, _to_device(batch, model.device),
                                    cfg)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ArchCfg, ocfg: opt.AdamWCfg, *,
                    microbatches: int = 1, grad_compression: str = "none",
                    backend: str | None = None, blocks_policy=None,
                    accum_dtype=None, mesh=None, axis_specs=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` (and a VLM's
    ``patch_embeds``, an encoder-decoder's ``src_embeds``; numpy or
    tensors), moved to the master copy's device.  ``backend``,
    ``blocks_policy``, ``accum_dtype``, ``mesh`` and ``axis_specs`` scope
    every op of the step, forward and backward; a mesh of the running
    world makes it the rank's step of ``distributed.parallel``.
    """
    if grad_compression not in ("none", *KINDS):
        raise ValueError(f"grad_compression={grad_compression!r}; expected "
                         f"'none' or one of {', '.join(KINDS)}")
    blocks_policy = dispatch.check_blocks_policy(blocks_policy)
    if accum_dtype is not None:
        accum_dtype = dispatch.as_accum_dtype(accum_dtype)
    dispatch.check_axis_specs(axis_specs)
    if mesh is not None and not mesh.is_abstract:
        from repro_torch.distributed import parallel
        return parallel.make_train_step(
            cfg, ocfg, mesh, microbatches=microbatches,
            grad_compression=grad_compression, backend=backend,
            blocks_policy=blocks_policy, accum_dtype=accum_dtype,
            axis_specs=axis_specs)
    model = None     # the working params, built at the first step

    def train_step(state, batch):
        nonlocal model
        if model is None:
            device = next(iter(state["opt"]["master"].values())).device
            model = (EncDec if api.is_encdec(cfg) else Transformer)(
                cfg, device=device)
        opt.cast_params(state["opt"], dict(model.named_parameters()))
        step_mesh = mesh if mesh is not None else annotate.current_mesh()
        if step_mesh is not None and not step_mesh.is_abstract:
            raise ValueError(
                f"the launcher installed {step_mesh}, a mesh of the running "
                f"world: pass it as make_train_step(mesh=) to run its "
                f"executor")
        with dispatch.use(backend=backend, blocks_policy=blocks_policy,
                          accum_dtype=accum_dtype, mesh=step_mesh,
                          axis_specs=axis_specs):
            if microbatches > 1:
                rows = len(batch["tokens"])
                if rows % microbatches:
                    raise ValueError(f"a batch of {rows} rows does not split "
                                     f"into {microbatches} microbatches")
                size, grads = rows // microbatches, None
                for i in range(microbatches):
                    mb = {k: v[i * size:(i + 1) * size]
                          for k, v in batch.items()}
                    metrics, g = loss_and_grads(model, mb, cfg)
                    if grads is None:
                        grads = {n: t.float() for n, t in g.items()}
                    else:
                        torch._foreach_add_(list(grads.values()),
                                            [g[n].float() for n in grads])
                grads = {n: t / microbatches for n, t in grads.items()}
            else:
                metrics, grads = loss_and_grads(model, batch, cfg)
        if grad_compression != "none":
            grads = decompress_grads(*compress_grads(
                grads, kind=grad_compression,
                groups=interop.stacked_leaves(cfg)), kind=grad_compression)
        lr_scale = warmup_cosine(state["opt"]["step"])
        new_opt, opt_metrics = opt.adamw_update(grads, state["opt"], ocfg,
                                                lr_scale)
        return {"opt": new_opt}, {**metrics, **opt_metrics}

    return train_step


def init_state(cfg: ArchCfg, ocfg: opt.AdamWCfg,
               generator: torch.Generator | None = None, device="cuda", *,
               mesh=None):
    """``{"opt": adamw_init(params)}`` for random params drawn from
    ``generator`` in ``cfg.dtype`` (the master copy holds them in fp32).
    On a mesh of the running world, this rank's shard of it."""
    if mesh is not None and not mesh.is_abstract:
        from repro_torch.distributed import parallel
        return parallel.init_state(cfg, ocfg, mesh, generator, device)
    model = api.init_params(cfg, generator, device=device)
    return {"opt": opt.adamw_init(dict(model.named_parameters()), ocfg)}

"""Flash-attention entry points, through the op registry.

``flash_attention``: ``"torch"`` runs the plain ``mha_ref`` (plain
autograd); ``"cuda"`` the Hopper forward kernel, differentiated by the
Hopper backward kernels (``_FlashCuda``): the forward saves
(q, k, v, o, lse) and the backward rebuilds P from lse, as the reference's
``_flash_fwd`` / ``_flash_bwd`` do.

``flash_attention_bwd``: the backward as an op of its own, from the
forward's residuals.  ``"torch"`` is ``flash_attention_bwd_ref`` (autograd
through ``mha_ref``, ignoring y and lse, like the reference's ``xla``
backend); ``"cuda"`` the Hopper kernels.

Under ``use(accum_dtype=torch.bfloat16)`` the ``"cuda"`` backends round
their accumulators at the reference's block ends
(``dispatch.accum_block``), and ``_FlashCuda`` carries its forward's
accumulation to its backward, as the reference's ``_Cfg`` does; the
``"torch"`` backends ignore it, as the reference's ``xla`` backends do.
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch
from repro_torch.kernels.flash_attention import bwd as B
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     mha_ref)


@dispatch.register("flash_attention", "torch")
def _flash_torch(q, k, v, *, causal, window, scale, return_residuals):
    return mha_ref(q, k, v, causal=causal, window=window, scale=scale,
                   return_lse=return_residuals)


class _FlashCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, round_k):
        o, lse = K.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        return_residuals=True,
                                        round_k=round_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, window, scale, round_k)
        ctx.dispatch = dispatch.snapshot()
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale, round_k = ctx.cfg
        # The kernel reads dO through its strides; a gradient it cannot read
        # in place (the zero strides of a sum's broadcast, say) is copied.
        # The training path's dO, a view of the merged heads, never is.
        vec = 16 // do.element_size()
        if do.stride(-1) != 1 or do.data_ptr() % 16 or any(
                st % vec for st in do.stride()[:3]):
            do = do.contiguous()
        with dispatch.restored(ctx.dispatch):
            dq, dk, dv = B.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, causal=causal, window=window,
                scale=scale, round_k=round_k)
        return dq, dk, dv, None, None, None, None


@dispatch.register("flash_attention", "cuda")
def _flash_cuda(q, k, v, *, causal, window, scale, return_residuals):
    round_k = dispatch.accum_block("flash_attention", k.size(-2))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o, lse = _FlashCuda.apply(q, k, v, causal, window, scale, round_k)
        return (o, lse) if return_residuals else o
    return K.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  scale=scale,
                                  return_residuals=return_residuals,
                                  round_k=round_k)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    backend: str | None = None,
                    return_residuals: bool = False):
    """q: (B, Hq, Tq, d); k, v: (B, Hkv, Tk, d) -> (B, Hq, Tq, d).

    With ``return_residuals`` returns ``(o, lse)``, lse fp32 (B, Hq, Tq).
    """
    impl = dispatch.get_impl("flash_attention", backend, q)
    return impl(q, k, v, causal=causal, window=window, scale=scale,
                return_residuals=return_residuals)


@dispatch.register("flash_attention_bwd", "torch")
def _flash_bwd_torch(q, k, v, y, lse, dy, *, causal, window, scale):
    return flash_attention_bwd_ref(q, k, v, y, lse, dy, causal=causal,
                                   window=window, scale=scale)


@dispatch.register("flash_attention_bwd", "cuda")
def _flash_bwd_cuda(q, k, v, y, lse, dy, *, causal, window, scale):
    return B.flash_attention_bwd_cuda(
        q, k, v, y, lse, dy, causal=causal, window=window, scale=scale,
        round_k=dispatch.accum_block("flash_attention_bwd", k.size(-2)))


def flash_attention_bwd(q, k, v, y, lse, dy, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None,
                        backend: str | None = None):
    """(dq, dk, dv) from the forward's residuals ``y`` and ``lse``
    (``flash_attention(..., return_residuals=True)``); the ``"torch"``
    backend rebuilds everything and reads neither."""
    impl = dispatch.get_impl("flash_attention_bwd", backend, q)
    return impl(q, k, v, y, lse, dy, causal=causal, window=window,
                scale=scale)

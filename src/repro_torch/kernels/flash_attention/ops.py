"""Flash-attention entry point, through the op registry (forward only).

``"torch"`` runs the plain ``mha_ref``; ``"cuda"`` the Hopper kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import mha_ref


@dispatch.register("flash_attention", "torch")
def _flash_torch(q, k, v, *, causal, window, scale, return_residuals):
    return mha_ref(q, k, v, causal=causal, window=window, scale=scale,
                   return_lse=return_residuals)


@dispatch.register("flash_attention", "cuda")
def _flash_cuda(q, k, v, *, causal, window, scale, return_residuals):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the cuda flash_attention is forward only: backward kernels come "
            "with the training slice (run under torch.inference_mode() or "
            "no_grad)")
    return K.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  scale=scale,
                                  return_residuals=return_residuals)


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

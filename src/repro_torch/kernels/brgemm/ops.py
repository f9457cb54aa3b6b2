"""Public entry point of the batch-reduce GEMM, through the op registry.

``matmul`` registers two backends (``core/dispatch.py``): ``"torch"``, the
plain version in ``ref.py``, differentiated by plain autograd; and
``"cuda"``, the Hopper kernel in ``kernel.py``, whose gradient is the same
kernel again (``_MatmulCuda``), as in the reference's custom VJP
(``repro/kernels/brgemm/ops.py``, ``_matmul_fwd`` / ``_matmul_bwd``):

    g  = dy * act'(pre)     fp32; act' from the output, or from ``pre``
                            recomputed by the kernel (activation "none",
                            fp32 out) when the output is not enough
    dx = (alpha g) W^T      the kernel, W read transposed in place
    dw = X^T (alpha g)      the kernel, X read transposed in place
    dbias = sum_rows g,  dc0 = beta g
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch, fusion
from repro_torch.kernels.brgemm import kernel as K
from repro_torch.kernels.brgemm import ref as R


@dispatch.register("matmul", "torch")
def _matmul_torch(x, w, bias, c0, *, activation, alpha, beta, out_dtype):
    return R.matmul_ref(x, w, bias, activation=activation, alpha=alpha,
                        beta=beta, c0=c0, out_dtype=out_dtype)


class _MatmulCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, c0, activation, alpha, beta, out_dtype):
        y = K.matmul_cuda(x, w, bias, c0, activation=activation, alpha=alpha,
                          beta=beta, out_dtype=out_dtype)
        # The output is kept only when the derivative is read from it.
        from_y = activation != "none" and not fusion.needs_preact(activation)
        ctx.save_for_backward(x, w, bias, c0, y if from_y else None)
        ctx.cfg = (activation, alpha, beta)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, c0, y = ctx.saved_tensors
        activation, alpha, beta = ctx.cfg
        g = dy.float()
        if fusion.needs_preact(activation):
            pre = K.matmul_cuda(x, w, bias, c0, activation="none",
                                alpha=alpha, beta=beta,
                                out_dtype=torch.float32)
            g = g * fusion.GRAD_FROM_PREACT[activation](pre)
        elif activation != "none":
            g = g * fusion.GRAD_FROM_OUTPUT[activation](y.float())
        galpha = (g * alpha).to(x.dtype)
        dx = dw = dbias = dc0 = None
        if ctx.needs_input_grad[0]:
            dx = K.matmul_cuda(galpha, w.T)
        if ctx.needs_input_grad[1]:
            dw = K.matmul_cuda(x.T, galpha).to(w.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = g.sum(0).to(bias.dtype)
        if c0 is not None and ctx.needs_input_grad[3]:
            dc0 = (g * beta).to(c0.dtype)
        return dx, dw, dbias, dc0, None, None, None, None


@dispatch.register("matmul", "cuda")
def _matmul_cuda(x, w, bias, c0, *, activation, alpha, beta, out_dtype):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias, c0)):
        return _MatmulCuda.apply(x, w, bias, c0, activation, alpha, beta,
                                 out_dtype)
    return K.matmul_cuda(x, w, bias, c0, activation=activation, alpha=alpha,
                         beta=beta, out_dtype=out_dtype)


def matmul(x, w, bias=None, c0=None, *, activation: str = "none",
           alpha: float = 1.0, beta: float = 0.0, out_dtype=None,
           backend: str | None = None):
    """``act(alpha * x @ w + beta * c0 + bias)``; x may have any leading dims.

    w is (k, n); c0, when given, has x's leading dims and n columns.
    """
    n = w.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    c02 = c0.reshape(-1, n) if c0 is not None else None
    impl = dispatch.get_impl("matmul", backend, x)
    y = impl(x2, w, bias, c02, activation=activation, alpha=alpha,
             beta=beta, out_dtype=out_dtype)
    return y.reshape(*lead, n)

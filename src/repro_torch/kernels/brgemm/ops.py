"""Public entry point of the batch-reduce GEMM, through the op registry.

``matmul`` registers two backends (``core/dispatch.py``): ``"torch"``, the
plain version in ``ref.py``, and ``"cuda"``, the Hopper kernel in
``kernel.py``.  Forward only: the ``"cuda"`` backend refuses a call that
autograd would record, since the backward kernels come with training.
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch
from repro_torch.kernels.brgemm import kernel as K
from repro_torch.kernels.brgemm import ref as R


@dispatch.register("matmul", "torch")
def _matmul_torch(x, w, bias, c0, *, activation, alpha, beta, out_dtype):
    return R.matmul_ref(x, w, bias, activation=activation, alpha=alpha,
                        beta=beta, c0=c0, out_dtype=out_dtype)


@dispatch.register("matmul", "cuda")
def _matmul_cuda(x, w, bias, c0, *, activation, alpha, beta, out_dtype):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias, c0)):
        raise NotImplementedError(
            "the cuda matmul is forward only: backward kernels come with the "
            "training slice (run under torch.inference_mode() or no_grad)")
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

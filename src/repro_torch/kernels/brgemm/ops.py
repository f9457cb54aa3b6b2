"""Public entry points of the batch-reduce GEMMs, through the op registry:
``matmul``, the paper's stacked ``brgemm`` and ``batched_matmul``.

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

``brgemm``'s ``"cuda"`` backend (``_BrgemmCuda``) differentiates as the
reference's ``_brgemm_bwd`` does, with ``g`` made the same way:

    dA_i = (alpha g) B_i^T   the batched kernel, g broadcast over i and
    dB_i = A_i^T (alpha g)   B_i^T / A_i^T read in place through strides

``batched_matmul``'s ``"cuda"`` backend (``_BatchedCuda``) differentiates
with the batched kernel itself, ``g`` made the same way, where the
reference's Pallas op has no VJP and the reference trains its MoE models
through the XLA einsum that this contraction is:

    dA_i = (alpha g_i) B_i^T   the batched kernel, B_i^T read in place
    dB_i = A_i^T (alpha g_i)   the batched kernel, A_i^T read in place
    dbias = sum g over the batch and the rows

and a 2-D operand broadcast over the batch takes the sum of its entries'
gradients.

Under ``use(accum_dtype=torch.bfloat16)`` the ``"torch"`` backends round
the product to bf16 once before the fp32 epilogue, as the reference's XLA
path does, and the ``"cuda"`` forwards round their sums at the reference's
k-block ends (``dispatch.accum_block``).  The backward GEMMs and the
pre-activation recomputes run in fp32 whatever the context, as the
reference's VJPs call the kernels with no accumulator dtype.

Each entry takes ``quant=`` and routes through ``quant.active_quant``: an
explicit spec, an ambient ``use(quant=...)`` or a calibrated
``QuantizedTensor`` weight sends the call to the quantized GEMM
(``quant.py``) with no change at the call site.  Under an *ambient* quant a
``c0`` / ``beta`` accumulator chain degrades to full precision (a
calibrated weight dequantized); an explicit ``quant=`` raises instead, as
in the reference (``repro/kernels/brgemm/ops.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch, fusion
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.kernels.brgemm import kernel as K
from repro_torch.kernels.brgemm import quant as Q
from repro_torch.kernels.brgemm import ref as R


@dispatch.register("matmul", "torch")
def _matmul_torch(x, w, bias, c0, *, activation, alpha, beta, out_dtype):
    return R.matmul_ref(x, w, bias, activation=activation, alpha=alpha,
                        beta=beta, c0=c0, out_dtype=out_dtype,
                        accum=dispatch.resolve_accum_dtype())


class _MatmulCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, c0, activation, alpha, beta, out_dtype,
                round_k):
        y = K.matmul_cuda(x, w, bias, c0, activation=activation, alpha=alpha,
                          beta=beta, out_dtype=out_dtype, round_k=round_k)
        # The output is kept only when the derivative is read from it.
        from_y = activation != "none" and not fusion.needs_preact(activation)
        ctx.save_for_backward(x, w, bias, c0, y if from_y else None)
        ctx.cfg = (activation, alpha, beta)
        ctx.dispatch = dispatch.snapshot()
        return y

    @staticmethod
    def backward(ctx, dy):
        with dispatch.restored(ctx.dispatch):
            return _MatmulCuda._backward(ctx, dy)

    @staticmethod
    def _backward(ctx, dy):
        x, w, bias, c0, y = ctx.saved_tensors
        activation, alpha, beta = ctx.cfg
        g = fusion.output_grad(dy, y, activation, lambda: K.matmul_cuda(
            x, w, bias, c0, activation="none", alpha=alpha, beta=beta,
            out_dtype=torch.float32))
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
        return dx, dw, dbias, dc0, None, None, None, None, None


@dispatch.register("matmul", "cuda")
def _matmul_cuda(x, w, bias, c0, *, activation, alpha, beta, out_dtype):
    round_k = dispatch.accum_block("matmul", x.size(-1))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias, c0)):
        return _MatmulCuda.apply(x, w, bias, c0, activation, alpha, beta,
                                 out_dtype, round_k)
    return K.matmul_cuda(x, w, bias, c0, activation=activation, alpha=alpha,
                         beta=beta, out_dtype=out_dtype, round_k=round_k)


def _quant_for(w, quant, x, c0, beta):
    """(QuantConfig or None, w): the ambient quant skips accumulator
    chains, which have no quantized form, dequantizing a calibrated w."""
    qcfg = Q.active_quant(w, quant)
    if qcfg is not None and quant is None and c0 is not None and beta != 0.0:
        qcfg = None
        if isinstance(w, QuantizedTensor):
            w = w.dequantize().to(x.dtype)
    return qcfg, w


def matmul(x, w, bias=None, c0=None, *, activation: str = "none",
           alpha: float = 1.0, beta: float = 0.0, out_dtype=None,
           backend: str | None = None, quant=None):
    """``act(alpha * x @ w + beta * c0 + bias)``; x may have any leading dims.

    w is (k, n), or a calibrated ``QuantizedTensor``; c0, when given, has
    x's leading dims and n columns.
    """
    qcfg, w = _quant_for(w, quant, x, c0, beta)
    n = w.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    c02 = c0.reshape(-1, n) if c0 is not None else None
    if qcfg is not None:
        y = Q.matmul_q(x2, w, bias, c02, activation=activation, alpha=alpha,
                       beta=beta, out_dtype=out_dtype, backend=backend,
                       qcfg=qcfg)
        return y.reshape(*lead, n)
    impl = dispatch.get_impl("matmul", backend, x)
    y = impl(x2, w, bias, c02, activation=activation, alpha=alpha,
             beta=beta, out_dtype=out_dtype)
    return y.reshape(*lead, n)


def brgemm_bwd(stacked, batched, a, b, bias, c0, y, dy, *, activation,
               alpha, beta, needs=(True, True, True, True)):
    """(da, db, dbias, dc0) of ``brgemm``, as the reference's
    ``_brgemm_bwd`` computes them, over the given stacked and batched GEMM
    callables (the kernels on the card, the plain versions in the CPU
    tests).  ``needs`` says which of the four to compute."""
    g = fusion.output_grad(dy, y, activation, lambda: stacked(
        a, b, bias, c0=c0, activation="none", alpha=alpha, beta=beta,
        out_dtype=torch.float32))
    galpha = (g * alpha).to(a.dtype)
    da = db = dbias = dc0 = None
    if needs[0]:
        da = batched(galpha, b.transpose(-1, -2)).to(a.dtype)
    if needs[1]:
        db = batched(a.transpose(-1, -2), galpha).to(b.dtype)
    if bias is not None and needs[2]:
        dbias = g.sum(0).to(bias.dtype)
    if c0 is not None and needs[3]:
        dc0 = (g * beta).to(c0.dtype)
    return da, db, dbias, dc0


@dispatch.register("brgemm", "torch")
def _brgemm_torch(a, b, bias, c0, *, activation, alpha, beta, out_dtype):
    return R.brgemm_ref(a, b, bias, activation=activation, alpha=alpha,
                        beta=beta, c0=c0, out_dtype=out_dtype,
                        accum=dispatch.resolve_accum_dtype())


class _BrgemmCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, bias, c0, activation, alpha, beta, out_dtype,
                round_k):
        y = K.brgemm_stacked_cuda(a, b, bias, c0, activation=activation,
                                  alpha=alpha, beta=beta,
                                  out_dtype=out_dtype, round_k=round_k)
        from_y = activation != "none" and not fusion.needs_preact(activation)
        ctx.save_for_backward(a, b, bias, c0, y if from_y else None)
        ctx.cfg = dict(activation=activation, alpha=alpha, beta=beta)
        ctx.dispatch = dispatch.snapshot()
        return y

    @staticmethod
    def backward(ctx, dy):
        a, b, bias, c0, y = ctx.saved_tensors
        with dispatch.restored(ctx.dispatch):
            grads = brgemm_bwd(K.brgemm_stacked_cuda, K.batched_matmul_cuda, a,
                               b, bias, c0, y, dy,
                               needs=ctx.needs_input_grad[:4], **ctx.cfg)
        return (*grads, None, None, None, None, None)


@dispatch.register("brgemm", "cuda")
def _brgemm_cuda(a, b, bias, c0, *, activation, alpha, beta, out_dtype):
    round_k = dispatch.accum_block("brgemm", a.size(-1))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, bias, c0)):
        return _BrgemmCuda.apply(a, b, bias, c0, activation, alpha, beta,
                                 out_dtype, round_k)
    return K.brgemm_stacked_cuda(a, b, bias, c0, activation=activation,
                                 alpha=alpha, beta=beta, out_dtype=out_dtype,
                                 round_k=round_k)


def brgemm(a, b, bias=None, c0=None, *, activation: str = "none",
           alpha: float = 1.0, beta: float = 0.0, out_dtype=None,
           backend: str | None = None, quant=None):
    """The paper's batch-reduce GEMM,
    ``act(alpha * sum_i a[i] @ b[i] + beta * c0 + bias)``.

    a: (B, m, k), b: (B, k, n) -> (m, n); bias (n,), c0 (m, n).
    """
    qcfg, b = _quant_for(b, quant, a, c0, beta)
    if qcfg is not None:
        return Q.brgemm_q(a, b, bias, c0, activation=activation, alpha=alpha,
                          beta=beta, out_dtype=out_dtype, backend=backend,
                          qcfg=qcfg)
    impl = dispatch.get_impl("brgemm", backend, a)
    return impl(a, b, bias, c0, activation=activation, alpha=alpha,
                beta=beta, out_dtype=out_dtype)


@dispatch.register("batched_matmul", "torch")
def _batched_matmul_torch(a, b, bias, *, activation, alpha, out_dtype):
    return R.batched_matmul_ref(a, b, bias, activation=activation,
                                alpha=alpha, out_dtype=out_dtype,
                                accum=dispatch.resolve_accum_dtype())


def batched_bwd(batched, a, b, bias, y, dy, *, activation, alpha,
                needs=(True, True, True)):
    """(da, db, dbias) of ``batched_matmul`` over the given batched GEMM
    callable (the kernel on the card, the plain version in the CPU tests):
    ``g = dy * act'(pre)``, act' from the output or from the fp32
    pre-activation recomputed by the same GEMM, then one batched GEMM for
    each operand's gradient, reading the other operand transposed in
    place.  A broadcast 2-D operand's gradient is summed over the batch
    in fp32.  ``needs`` says which of the three to compute."""
    g = fusion.output_grad(dy, y, activation, lambda: batched(
        a, b, bias, activation="none", alpha=alpha,
        out_dtype=torch.float32))
    galpha = (g * alpha).to(a.dtype)
    da = db = dbias = None
    if needs[0]:
        da = batched(galpha, b.transpose(-1, -2),
                     out_dtype=torch.float32 if a.dim() == 2 else None)
        da = (da.sum(0) if a.dim() == 2 else da).to(a.dtype)
    if needs[1]:
        db = batched(a.transpose(-1, -2), galpha,
                     out_dtype=torch.float32 if b.dim() == 2 else None)
        db = (db.sum(0) if b.dim() == 2 else db).to(b.dtype)
    if bias is not None and needs[2]:
        dbias = g.sum((0, 1)).to(bias.dtype)
    return da, db, dbias


class _BatchedCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, bias, activation, alpha, out_dtype, round_k):
        y = K.batched_matmul_cuda(a, b, bias, activation=activation,
                                  alpha=alpha, out_dtype=out_dtype,
                                  round_k=round_k)
        from_y = activation != "none" and not fusion.needs_preact(activation)
        ctx.save_for_backward(a, b, bias, y if from_y else None)
        ctx.cfg = dict(activation=activation, alpha=alpha)
        ctx.dispatch = dispatch.snapshot()
        return y

    @staticmethod
    def backward(ctx, dy):
        a, b, bias, y = ctx.saved_tensors
        with dispatch.restored(ctx.dispatch):
            grads = batched_bwd(K.batched_matmul_cuda, a, b, bias, y, dy,
                                needs=ctx.needs_input_grad[:3], **ctx.cfg)
        return (*grads, None, None, None, None)


@dispatch.register("batched_matmul", "cuda")
def _batched_matmul_cuda(a, b, bias, *, activation, alpha, out_dtype):
    round_k = dispatch.accum_block("batched_matmul", a.size(-1))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, bias)):
        return _BatchedCuda.apply(a, b, bias, activation, alpha, out_dtype,
                                  round_k)
    return K.batched_matmul_cuda(a, b, bias, activation=activation,
                                 alpha=alpha, out_dtype=out_dtype,
                                 round_k=round_k)


def batched_matmul(a, b, bias=None, *, activation: str = "none",
                   alpha: float = 1.0, out_dtype=None,
                   backend: str | None = None, quant=None,
                   a_groups: int = 1):
    """Strided-batched GEMM, ``act(alpha * a[i] @ b[i] + bias)``, with no
    reduction across the batch.

    a: (B, m, k) or (m, k) broadcast; b: (B, k, n) or (k, n) broadcast ->
    (B, m, n).  ``a_groups``: the routing groups folded into a's rows,
    which a quantized call's per-tensor activation scales keep apart
    (``quant.batched_matmul_q``); full precision ignores it.
    """
    qcfg = Q.active_quant(b, quant)
    if qcfg is not None:
        return Q.batched_matmul_q(a, b, bias, activation=activation,
                                  alpha=alpha, out_dtype=out_dtype,
                                  backend=backend, a_groups=a_groups,
                                  qcfg=qcfg)
    impl = dispatch.get_impl("batched_matmul", backend, a)
    return impl(a, b, bias, activation=activation, alpha=alpha,
                out_dtype=out_dtype)

"""Public entry point of the direct convolution, through the op registry.

``conv2d`` registers two backends (``core/dispatch.py``): ``"torch"``, the
plain version in ``ref.py``, differentiated by plain autograd; and
``"cuda"``, the Hopper kernel in ``kernel.py``, whose gradient is
``conv2d_bwd`` over the same kernel and the ``matmul`` kernel
(``_Conv2dCuda``), as the reference's custom VJP
(``repro/kernels/conv2d/ops.py``, ``_conv_bwd``) computes it, the paper's
"dual convolutions" (Sec. 3.2.2):

    g     = dy * act'(pre) in fp32, then cast to x's dtype
    dx    = conv(dilate_stride(g) padded bottom/right to cover H, W,
                 w flipped on (R, S) and swapped C <-> K,
                 stride 1, padding R - 1 - padding)       the conv kernel
    dw    = patches(x)^T g, one GEMM over the (N*P*Q, R*S*C) window
            operand: the reference's R*S GEMMs X_(r,s)^T g side by side,
            the same dot products in the same order    the matmul kernel
    dbias = sum of g over N, P, Q

Under ``use(accum_dtype=torch.bfloat16)`` the ``"cuda"`` forward rounds
its sums at the reference's (tap, 128-channel block) ends
(``dispatch.accum_block``); the backward stays fp32, and the ``"torch"``
backend ignores the context, as the reference's XLA path does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch, fusion
from repro_torch.kernels.brgemm import kernel as BK
from repro_torch.kernels.conv2d import kernel as K
from repro_torch.kernels.conv2d import ref as R


def dual_operands(g, w, hw, stride, padding):
    """(input, weights, padding) of the dual convolution that gives dx of
    spatial size ``hw`` = (H, W) from g = dL/dy: g with stride - 1 zeros
    between its rows and columns and zero rows / columns at the bottom /
    right up to the size that covers (H, W); w flipped on (R, S) and
    swapped C <-> K; padding R - 1 - padding."""
    n, p, q, k = g.shape
    r, s = w.shape[:2]
    extra_h = hw[0] - ((p - 1) * stride + r - 2 * padding)
    extra_w = hw[1] - ((q - 1) * stride + s - 2 * padding)
    w_dual = w.flip(0, 1).transpose(2, 3).contiguous()     # (R, S, K, C)
    if stride == 1 and extra_h == extra_w == 0:
        return g, w_dual, r - 1 - padding
    gd = g.new_zeros((n, (p - 1) * stride + 1 + extra_h,
                      (q - 1) * stride + 1 + extra_w, k))
    gd[:, :(p - 1) * stride + 1:stride, :(q - 1) * stride + 1:stride] = g
    return gd, w_dual, r - 1 - padding


def patches(x, r, s, stride, padding):
    """(N*P*Q, R*S*C): row (n, p, q) holds the window of output pixel
    (p, q) of image n, taps in (r, s) order, channels innermost (the row
    order of w viewed as an (R*S*C, K) matrix).  A 1x1, stride-1, unpadded
    conv's is x itself, viewed.  Otherwise the rows lie a multiple of 8
    elements apart (16 bytes in bf16), so that the GEMM kernel's TMA can
    read the window transposed in place: the first R*S*C columns of a
    wider buffer (the stem's 147 of 152)."""
    n, h, wi, c = x.shape
    if r == s == 1 and stride == 1 and padding == 0:
        return x.reshape(n * h * wi, c)
    p, q = R.out_size(h, r, stride, padding), R.out_size(wi, s, stride,
                                                          padding)
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    sn, sh, sw, sc = xp.stride()
    windows = xp.as_strided((n, p, q, r, s, c), (sn, stride * sh, stride * sw,
                                                 sh, sw, sc),
                            xp.storage_offset())
    rsc = r * s * c
    cols = x.new_empty((n * p * q, -(-rsc // 8) * 8))[:, :rsc]
    cols.view(n, p, q, r, s, c).copy_(windows)
    return cols


def conv2d_bwd(conv, mm, x, w, bias, y, dy, *, stride, padding, activation,
               needs=(True, True, True)):
    """(dx, dw, dbias) of ``conv2d``, as the reference's ``_conv_bwd``
    computes them, over the given convolution and GEMM callables (the
    kernels on the card, the plain versions in the CPU tests).  ``y`` is
    the forward's output, read only by activations whose derivative it
    gives; ``needs`` says which of the three to compute."""
    n, h, wi, c = x.shape
    r, s, _, k = w.shape
    p, q = dy.shape[1:3]
    g = fusion.output_grad(dy, y, activation, lambda: conv(
        x, w, bias, stride=stride, padding=padding, activation="none",
        out_dtype=torch.float32)).to(x.dtype).contiguous()
    dx = dw = dbias = None
    if needs[0]:
        gd, w_dual, pad_dual = dual_operands(g, w, (h, wi), stride, padding)
        dx = conv(gd, w_dual, None, padding=pad_dual,
                  out_dtype=torch.float32).to(x.dtype)
    if needs[1]:
        cols = patches(x, r, s, stride, padding)
        dw = mm(cols.T, g.reshape(n * p * q, k), out_dtype=torch.float32
                ).reshape(r, s, c, k).to(w.dtype)
    if bias is not None and needs[2]:
        dbias = g.float().sum((0, 1, 2)).to(bias.dtype)
    return dx, dw, dbias


@dispatch.register("conv2d", "torch")
def _conv2d_torch(x, w, bias, *, stride, padding, activation, out_dtype):
    return R.conv2d_ref(x, w, bias, stride=stride, padding=padding,
                        activation=activation, out_dtype=out_dtype)


class _Conv2dCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, activation, out_dtype,
                round_c):
        y = K.conv2d_cuda(x, w, bias, stride=stride, padding=padding,
                          activation=activation, out_dtype=out_dtype,
                          round_c=round_c)
        # The output is kept only when the derivative is read from it.
        from_y = activation != "none" and not fusion.needs_preact(activation)
        ctx.save_for_backward(x, w, bias, y if from_y else None)
        ctx.cfg = dict(stride=stride, padding=padding, activation=activation)
        ctx.dispatch = dispatch.snapshot()
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, y = ctx.saved_tensors
        with dispatch.restored(ctx.dispatch):
            grads = conv2d_bwd(K.conv2d_cuda, BK.matmul_cuda, x, w, bias, y,
                               dy, needs=ctx.needs_input_grad[:3], **ctx.cfg)
        return (*grads, None, None, None, None, None)


@dispatch.register("conv2d", "cuda")
def _conv2d_cuda(x, w, bias, *, stride, padding, activation, out_dtype):
    round_c = dispatch.accum_block("conv2d", x.size(3))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return _Conv2dCuda.apply(x, w, bias, stride, padding, activation,
                                 out_dtype, round_c)
    return K.conv2d_cuda(x, w, bias, stride=stride, padding=padding,
                         activation=activation, out_dtype=out_dtype,
                         round_c=round_c)


def conv2d(x, w, bias=None, *, stride: int = 1, padding: int = 0,
           activation: str = "none", out_dtype=None,
           backend: str | None = None):
    """Direct convolution, ``act(conv(x, w) + bias)``: NHWC x RSCK -> NHWC.

    x: (N, H, W, C), w: (R, S, C, K), bias: (K,); zero padding of
    ``padding`` on every side.
    """
    impl = dispatch.get_impl("conv2d", backend, x)
    return impl(x, w, bias, stride=stride, padding=padding,
                activation=activation, out_dtype=out_dtype)

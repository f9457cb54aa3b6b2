"""Plain versions of the direct convolution (the paper's Algorithms 3/4).

  * ``conv2d_ref``       — ``F.conv2d`` on NHWC x RSCK, in fp32, with the
    bias and activation of the kernel's epilogue: the CPU path and, on the
    card, the version the kernel is held against.  On the card it runs
    through cuDNN, whose fp32 convolutions use TF32 while
    ``torch.backends.cudnn.allow_tf32`` is True (PyTorch's default): a
    caller that holds fp32 results to fp32 bands turns it off.
  * ``conv2d_loops_ref`` — Algorithm 3 as literal loops in numpy (tiny
    shapes only), pinning the semantics (stride, padding, channel order)
    independently of any library convolution.
  * ``conv2d_ref(..., round_c=128)`` — the blockwise version the kernel is
    held against under bf16 accumulation: the window summed tap by tap,
    ``round_c`` channels at a time, the fp32 sum rounded to bf16 in place
    after each (the reference's (tap, 128-channel block) grid steps).
    Used by the tests and ``chip_smoke.py`` only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import fusion


def out_size(size: int, r: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - r) // stride + 1


def conv2d_ref(x, w, bias=None, *, stride: int = 1, padding: int = 0,
               activation: str = "none", out_dtype=None, round_c: int = 0):
    """x: (N, H, W, C), w: (R, S, C, K) -> (N, P, Q, K)."""
    out_dtype = out_dtype or x.dtype
    if round_c:
        y = _taps_rounded(x, w, stride, padding, round_c)
    else:
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1), stride=stride,
                     padding=padding).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    return fusion.apply(activation, y).to(out_dtype).contiguous()


def _taps_rounded(x, w, stride, padding, round_c):
    """sum over taps (r, s) and blocks of ``round_c`` channels of the
    shifted x times w[r, s], in fp32, rounded to bf16 after each block."""
    n, h, wi, c = x.shape
    r_, s_, _, k = w.shape
    p, q = out_size(h, r_, stride, padding), out_size(wi, s_, stride,
                                                      padding)
    xp = F.pad(x.float(), (0, 0, padding, padding, padding, padding))
    acc = x.new_zeros((n, p, q, k), dtype=torch.float32)
    for r in range(r_):
        for s in range(s_):
            rows = xp[:, r:r + (p - 1) * stride + 1:stride,
                      s:s + (q - 1) * stride + 1:stride]
            for c0 in range(0, c, round_c):
                acc = (acc + rows[..., c0:c0 + round_c]
                       @ w[r, s, c0:c0 + round_c].float()
                       ).to(torch.bfloat16).float()
    return acc


def conv2d_loops_ref(x, w, *, stride: int = 1, padding: int = 0):
    """Paper Algorithm 3 as loops over numpy arrays; returns fp32 numpy."""
    x = np.asarray(x, np.float32)
    w = np.asarray(w, np.float32)
    n_, h, wi, _ = x.shape
    r_, s_, _, k = w.shape
    xp = np.pad(x, ((0, 0), (padding, padding), (padding, padding), (0, 0)))
    p, q = out_size(h, r_, stride, padding), out_size(wi, s_, stride, padding)
    out = np.zeros((n_, p, q, k), np.float32)
    for n in range(n_):
        for oj in range(p):
            for oi in range(q):
                for r in range(r_):
                    for s in range(s_):
                        out[n, oj, oi, :] += (
                            xp[n, oj * stride + r, oi * stride + s, :]
                            @ w[r, s, :, :])
    return out

"""The convolution's plan and a model of its im2col walk, on the CPU.

``plan_conv`` (``kernels/conv2d/kernel.py``) is plain Python: every
convolution of ResNet-50 at N = 32 in bf16 and every dual convolution of
its backward runs the wgmma + TMA mainloop but the stem (C = 3: a 6-byte
pixel TMA cannot step through), which runs the gathered wmma tiles; fp32
runs simt; the window is split where the output tiles alone leave SMs
idle (stage 4: 52 tiles).

A numpy model of what the wgmma kernel's IM2COL walk asks TMA for, one A
slice a (tap, 64-channel block): the producer's first window corner of
the tile, then the map's bounding box walked along W, then H, then N at
the conv stride, each pixel moved by the tap, zeros outside the image,
past the channels and past the last image.  Each box row is held against
the window operand ``conv2d.ops.patches`` builds (exactly: the same
values), at tile sizes that make rows cross images and run past N*P*Q,
with padding and strides 1 and 2; the model's GEMM (the slices' products
in split order over the (R*S*C, K) weights, rows past a tap's channels
included) against the reference's ``conv2d_pallas`` in interpret mode at
1e-4 (fp32 sums in other orders, test_torch_conv.py's band).
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d.kernel import conv2d_pallas
from repro_torch.kernels.conv2d import dual_operands
from repro_torch.kernels.conv2d.kernel import (MAINLOOPS, plan_conv,
                                               plan_conv_call)
from repro_torch.kernels.conv2d.ops import patches
from repro_torch.kernels.conv2d.ref import out_size
from repro_torch.models.resnet import ResNetCfg

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the path's list of ResNet-50's convolutions)

RNG = np.random.default_rng(23)
F32 = dict(atol=1e-4, rtol=1e-4)


def randn(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


# (name, n, h, c, k, r, stride, padding) of each distinct convolution of
# ResNet-50's forward at N = 32, 224 x 224
CONVS = list({cv.key: (cv.name, chip_smoke.RESNET_BATCH, cv.h, cv.c, cv.k,
                      cv.r, cv.stride, cv.padding)
              for cv in chip_smoke.resnet_convs(ResNetCfg(), 224)
              }.values())


def _dual_shape(n, h, c, k, r, stride, padding):
    """The dual convolution's (n, h, c, k, r, padding) at stride 1."""
    p = out_size(h, r, stride, padding)
    g = torch.empty(n, p, p, k, device="meta")
    wt = torch.empty(r, r, c, k, device="meta")
    gd, wd, pd = dual_operands(g, wt, (h, h), stride, padding)
    return gd.shape[1], wd.shape[2], wd.shape[3], pd


@pytest.mark.parametrize("name,n,h,c,k,r,stride,padding", CONVS,
                         ids=[c[0] for c in CONVS])
def test_plan_resnet50_on_wgmma_but_the_stem(name, n, h, c, k, r, stride,
                                             padding):
    p = plan_conv(n, h, h, c, k, r, r, stride, padding, True, True)
    assert p.mainloop == ("wmma" if name == "stem" else "wgmma")
    assert plan_conv(n, h, h, c, k, r, r, stride, padding, False,
                     True).mainloop == "simt"
    if p.mainloop == "wgmma":
        q = out_size(h, r, stride, padding)
        slices = r * r * -(-c // 64)
        assert p.tiles == -(-(n * q * q) // 128) * -(-k // 128)
        assert p.splits * p.chunk >= slices > (p.splits - 1) * p.chunk
        assert p.splits == 1 or 2 * p.tiles <= 132
    if name != "stem":                      # the image takes no gradient
        hd, cd, kd, pd = _dual_shape(n, h, c, k, r, stride, padding)
        d = plan_conv(n, hd, hd, cd, kd, r, r, 1, pd, True, True)
        assert d.mainloop == "wgmma"


def test_plan_splits_stage4_and_keeps_others_whole():
    # stage 4's 3x3: m = 32 * 7 * 7 = 1568, K = 512: 13 x 4 = 52 tiles
    p = plan_conv(32, 7, 7, 512, 512, 3, 3, 1, 1, True, True)
    assert (p.tiles, p.splits) == (52, 2) and p.chunk == 36
    # stage 1's 3x3 fills the card with tiles
    assert plan_conv(32, 56, 56, 64, 64, 3, 3, 1, 1, True, True).splits == 1


def test_plan_call_reads_alignment_and_channels():
    bf = torch.bfloat16
    x, w = torch.zeros(2, 9, 9, 16, dtype=bf), torch.zeros(3, 3, 16, 24,
                                                           dtype=bf)
    assert plan_conv_call(x, w, 2, 1).mainloop == "wgmma"
    assert plan_conv_call(x[..., :12].contiguous(), w[:, :, :12].contiguous(),
                          2, 1).mainloop == "wmma"            # C = 12
    assert plan_conv_call(x, w[..., :20].contiguous(), 2,
                          1).mainloop == "wmma"               # K = 20
    buf = torch.zeros(x.numel() + 1, dtype=bf)
    assert plan_conv_call(buf[1:].view(x.shape), w, 2,
                          1).mainloop == "wmma"               # 2 bytes off
    assert plan_conv_call(x.float(), w.float()).mainloop == "simt"
    assert set(MAINLOOPS) == {"wgmma", "wmma", "simt"}


def im2col_box(x, m0, tap, cb, bm, r, s, stride, pad):
    """One A slice of the IM2COL walk (bm rows of 64 channels), as the
    kernel asks TMA for it: the producer's first corner, then the map's
    bounding box (-pad .. dim - 1 + pad - (window - 1)) walked along W,
    then H, then N at the stride, each corner moved by the tap."""
    n, h, w, c = x.shape
    lo, hi_h, hi_w = -pad, h - 1 + pad - (r - 1), w - 1 + pad - (s - 1)
    p, q = (hi_h - lo) // stride + 1, (hi_w - lo) // stride + 1
    img, pq = divmod(m0, p * q)
    hh, ww = (pq // q) * stride - pad, (pq % q) * stride - pad
    rr, ss = divmod(tap, s)
    box = np.zeros((bm, 64), x.dtype)
    for i in range(bm):
        ih, iw = hh + rr, ww + ss
        if img < n and 0 <= ih < h and 0 <= iw < w:
            chans = x[img, ih, iw, cb * 64:(cb + 1) * 64]
            box[i, :len(chans)] = chans
        ww += stride
        if ww > hi_w:
            ww, hh = lo, hh + stride
            if hh > hi_h:
                hh, img = lo, img + 1
    return box


def conv_model(x, w, stride, pad, bm, splits=1):
    """The wgmma kernel's product: per bm-row tile, the (tap, channel
    block) slices' im2col boxes times the 64 rows of the (R*S*C, K)
    weights at tap * C + block (rows past R*S*C zero, as TMA fills them),
    in `splits` equal runs added in split order."""
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    p, q = out_size(h, r, stride, pad), out_size(wd, s, stride, pad)
    cblocks = -(-c // 64)
    slices = r * s * cblocks
    chunk = -(-slices // splits)
    wmat = np.concatenate([w.reshape(r * s * c, k), np.zeros((64, k),
                                                             w.dtype)])
    m = n * p * q
    out = np.zeros((-(-m // bm) * bm, k), np.float32)
    for m0 in range(0, m, bm):
        acc = None
        for z in range(splits):
            part = np.zeros((bm, k), np.float32)
            for sl in range(z * chunk, min((z + 1) * chunk, slices)):
                tap, cb = divmod(sl, cblocks)
                a = im2col_box(x, m0, tap, cb, bm, r, s, stride, pad)
                row = tap * c + cb * 64
                part += a @ wmat[row:row + 64]
            acc = part if acc is None else acc + part
        out[m0:m0 + bm] = acc
    return out[:m].reshape(n, p, q, k)


# (n, h, c, k, r, stride, padding, tile rows, splits): padding, strides 1
# and 2, a 1x1 stride-2 projection, a 5x5 window, two channel blocks with
# a tail; tiles of 16 / 24 rows so that they cross images and run past
# N*P*Q; one split walk.
WALKS = [
    (2, 6, 8, 8, 3, 1, 1, 16, 1),
    (2, 7, 8, 6, 3, 2, 1, 16, 2),
    (3, 5, 16, 8, 1, 2, 0, 16, 1),
    (1, 9, 8, 4, 5, 2, 2, 24, 3),
    (2, 5, 72, 8, 3, 1, 1, 16, 2),
]


@pytest.mark.parametrize("n,h,c,k,r,stride,pad,bm,splits", WALKS)
def test_im2col_walk_reads_the_window_patches_builds(n, h, c, k, r, stride,
                                                     pad, bm, splits):
    x = randn(n, h, h, c)
    cols = patches(torch.from_numpy(x), r, r, stride, pad).numpy()
    m = cols.shape[0]
    for m0 in range(0, m, bm):
        rows = min(bm, m - m0)
        for tap in range(r * r):
            for cb in range(-(-c // 64)):
                box = im2col_box(x, m0, tap, cb, bm, r, r, stride, pad)
                width = min(64, c - cb * 64)
                lo = tap * c + cb * 64
                np.testing.assert_array_equal(
                    box[:rows, :width], cols[m0:m0 + rows, lo:lo + width])
                assert not box[:rows, width:].any()
                assert not box[rows:].any()        # past N*P*Q: zeros


@pytest.mark.parametrize("n,h,c,k,r,stride,pad,bm,splits", WALKS)
def test_im2col_gemm_matches_pallas_interpret(n, h, c, k, r, stride, pad,
                                              bm, splits):
    x, w = randn(n, h, h, c), randn(r, r, c, k, scale=(c * r * r) ** -0.5)
    got = conv_model(x, w, stride, pad, bm, splits)
    want = conv2d_pallas(jnp.asarray(x), jnp.asarray(w), stride=stride,
                         padding=pad, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_im2col_walk_of_a_dual_convolution():
    """The backward by data at stride 2: the zero-dilated gradient, padded
    bottom / right, read at stride 1 with padding r - 1 - pad."""
    n, h, c, k, r, stride, pad = 2, 7, 8, 8, 3, 2, 1
    p = out_size(h, r, stride, pad)
    g = torch.from_numpy(randn(n, p, p, k))
    wt = torch.from_numpy(randn(r, r, c, k, scale=0.2))
    gd, wd, pd = dual_operands(g, wt, (h, h), stride, pad)
    got = conv_model(gd.numpy(), wd.numpy(), 1, pd, bm=16, splits=2)
    want = conv2d_pallas(jnp.asarray(gd.numpy()), jnp.asarray(wd.numpy()),
                         padding=pd, interpret=True)
    assert got.shape == (n, h, h, c)
    np.testing.assert_allclose(got, np.asarray(want), **F32)

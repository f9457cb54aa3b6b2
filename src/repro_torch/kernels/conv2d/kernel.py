"""Wrapper of the Hopper direct-convolution kernel (``csrc/conv2d.cu``).

``conv2d_cuda`` checks what the kernel takes, allocates the output, and
launches on the current stream; the library is built at first use
(``kernels/_build.py``).  ``plan_conv`` decides how a call runs: on the
shared wgmma + TMA mainloop (``wgmma``: bf16 whose C and K are multiples
of 8, A from TMA in im2col mode, the window split where the output tiles
alone leave SMs idle), on the first kernel's gathered 64 x 64 wmma tiles
(``wmma``: other bf16, as the stem's C = 3), or on FMA (``simt``: fp32).
``conv2d_cuda.launches`` counts the launches, forward and backward-by-data
alike (both run this kernel); ``.mainloops`` the calls by mainloop and
``.split_launches`` those that also launched the split reduction
(``reset_conv_counts`` zeroes them).  ``plan_conv`` is the heuristic:
``conv2d_cuda`` takes its plan from ``dispatch.resolve_blocks`` under the
reference's triple (q, c, k), the rest of the call as a
``ConvGeometry``; ``candidate_plans_conv`` is the grid a measured policy
searches (the split counts of the wgmma plan).  ``round_c`` asks for bf16
accumulation: the sums rounded to bf16 in place at the end of every
``round_c`` channels of a tap and at the tap's end (the reference's
(tap, 128-channel block) grid steps), on one split; the wmma and simt
mainloops then walk the window tap by tap.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import blocking, dispatch, fusion
from repro_torch.core.blocking import ConvGeometry, Plan, PlanSchema
from repro_torch.kernels import _build
from repro_torch.kernels.brgemm.kernel import PER_SM, _split, one_split
from repro_torch.kernels.conv2d.ref import out_size

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int

MAINLOOPS = ("wgmma", "wmma", "simt")   # conv2d.cu's Mainloop codes
BM = BN = 128                           # the wgmma tile
CBLOCK = 64                             # channels a slice (128 bytes)


@functools.lru_cache(maxsize=4096)
def plan_conv(n: int, h: int, w: int, c: int, k: int, r: int, s: int,
              stride: int, padding: int, is_bf16: bool,
              aligned: bool) -> Plan:
    """How ``conv2d_cuda`` runs an (n, h, w, c) x (r, s, c, k) conv.

    wgmma for bf16 where TMA can describe x and w (``aligned``: 16-byte
    aligned bases; C and K multiples of 8, so that a pixel and a weight
    row are whole 16-byte steps) and the window's corners and stride fit
    an im2col map (|corner| <= 127, stride <= 8); wmma for other bf16;
    simt for fp32.  On wgmma a slice is one tap x 64 channels (``bk``), the
    reduction r * s * ceil(c / 64) slices, split as ``kernel.plan`` splits
    k; the other mainloops walk it whole.  ``tiles``: output tiles of the
    (n * p * q, k) product."""
    p, q = out_size(h, r, stride, padding), out_size(w, s, stride, padding)
    m = n * p * q
    fits = (c % 8 == 0 and k % 8 == 0 and aligned and stride <= 8
            and padding <= 127 and max(r, s) - 1 - padding <= 128)
    mainloop = "simt" if not is_bf16 else "wgmma" if fits else "wmma"
    if mainloop != "wgmma":
        return Plan(mainloop, 64, 32 if is_bf16 else 16, 1, 1,
                    -(-m // 64) * -(-k // 64))
    tiles = -(-m // BM) * -(-k // BN)
    slices = r * s * -(-c // CBLOCK)
    splits, chunk = _split(tiles, slices, CBLOCK, 1)
    return Plan("wgmma", BM, CBLOCK, splits, chunk, tiles)


def candidate_plans_conv(n: int, h: int, w: int, c: int, k: int, r: int,
                         s: int, stride: int, padding: int, is_bf16: bool,
                         aligned: bool) -> list[Plan]:
    """The plans a measured policy searches, heuristic first: on wgmma the
    window's split counts that ``_split`` gives at PER_SM blocks an SM;
    the other mainloops walk the window whole, one plan."""
    heuristic = plan_conv(n, h, w, c, k, r, s, stride, padding, is_bf16,
                          aligned)
    out = [heuristic]
    if heuristic.mainloop == "wgmma":
        slices = r * s * -(-c // CBLOCK)
        for per_sm in PER_SM:
            splits, chunk = _split(heuristic.tiles, slices, CBLOCK, per_sm)
            p = Plan("wgmma", BM, CBLOCK, splits, chunk, heuristic.tiles)
            if p not in out:
                out.append(p)
    return out


def _geometry_args(q, c, k, dtype, g: ConvGeometry) -> tuple:
    return (g.n, g.h, g.w, c, k, g.r, g.s, g.stride, g.padding,
            blocking.dtype_name(dtype) == "bfloat16", g.aligned)


blocking.register_schema("conv2d", PlanSchema(
    heuristic=lambda q, c, k, dt, g: plan_conv(*_geometry_args(q, c, k, dt,
                                                              g)),
    candidates=lambda q, c, k, dt, g: candidate_plans_conv(
        *_geometry_args(q, c, k, dt, g)),
    # a 1 x 1 convolution over one row of q pixels
    geometry=lambda q, c, k, dt: ConvGeometry(1, 1, q, 1, 1, 1, 0)))


def _conv_plan(x, w, stride, padding, explicit=None) -> Plan:
    n, h, wi, c = x.shape
    r, s, _, k = w.shape
    geometry = ConvGeometry(n, h, wi, r, s, stride, padding,
                            x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    p = dispatch.resolve_blocks(
        "conv2d", out_size(wi, s, stride, padding), c, k, x.dtype,
        backend="cuda", plan=explicit, geometry=geometry)
    if explicit is None and p.mainloop == "wgmma" and \
            dispatch.localising():
        p = blocking.fit_plan(p, r * s * -(-c // CBLOCK))
    return p


def plan_conv_call(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                   padding: int = 0) -> Plan:
    """The plan of ``conv2d_cuda(x, w, stride=, padding=)``, from the
    shapes, type and alignment under the active block policy (the kernel
    itself is not touched)."""
    return _conv_plan(x, w, stride, padding)


@functools.cache
def _lib():
    lib = _build.load("conv2d")
    lib.repro_conv2d.argtypes = [_P, _P, _P, _P] + [_I] * 21 + [_P, _P]
    lib.repro_conv2d.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def conv2d_cuda(x, w, bias=None, *, stride: int = 1, padding: int = 0,
                activation: str = "none", out_dtype=None,
                plan: Plan | None = None, round_c: int = 0):
    """``act(conv(x, w) + bias)`` on the card, NHWC x RSCK -> NPQK.

    x: (N, H, W, C) and w: (R, S, C, K), both contiguous, fp32 or bf16 of
    one dtype; bias: (K,) contiguous, fp32 or x's dtype.  The input is
    padded by ``padding`` on every side (zeros, never materialized).
    Returns a contiguous (N, P, Q, K) of ``out_dtype`` (default x's dtype).
    ``plan``: run so (one the kernel cannot take raises), else the block
    policy's pick (``dispatch.resolve_blocks``).  ``round_c``: bf16
    accumulation's block of a tap's channels (a multiple of 128), or 0 for
    fp32.
    """
    out_dtype = out_dtype or x.dtype
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("conv2d_cuda needs x and w on the same CUDA device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv2d_cuda takes fp32 or bf16 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"conv2d_cuda out_dtype must be fp32 or bf16, got "
                        f"{out_dtype}")
    if x.dim() != 4 or w.dim() != 4 or x.size(3) != w.size(2):
        raise ValueError(f"conv2d_cuda needs NHWC x and RSCK w with one C, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_cuda needs contiguous x and w")
    if stride < 1 or padding < 0:
        raise ValueError(f"conv2d_cuda stride {stride}, padding {padding}")
    n, h, wi, c = x.shape
    r, s, _, k = w.shape
    p, q = out_size(h, r, stride, padding), out_size(wi, s, stride, padding)
    if p < 1 or q < 1:
        raise ValueError(f"conv2d_cuda: a {r}x{s} window does not fit "
                         f"{h}x{wi} padded by {padding}")
    if bias is not None:
        if bias.device != x.device or bias.dtype not in (torch.float32,
                                                         x.dtype):
            raise TypeError(f"conv2d_cuda bias must be fp32 or {x.dtype} on "
                            f"{x.device}")
        if tuple(bias.shape) != (k,) or not bias.is_contiguous():
            raise ValueError(f"conv2d_cuda bias must be contiguous ({k},), "
                             f"got {tuple(bias.shape)}")
    if max(x.numel(), w.numel(), n * p * q * k) >= 2 ** 31:
        raise ValueError("conv2d_cuda indexes pixels and channels with int")
    out = torch.empty((n, p, q, k), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    is_bf16 = x.dtype == torch.bfloat16
    plan = _conv_plan(x, w, stride, padding, plan)
    if round_c:
        plan = one_split(plan, r * s * -(-c // CBLOCK))
    ws = (torch.empty(plan.splits * out.numel(), dtype=torch.float32,
                      device=x.device) if plan.splits > 1 else None)
    lib = _lib()
    rc = lib.repro_conv2d(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        n, h, wi, c, k, r, s, p, q, stride, padding,
        fusion.code(activation), int(is_bf16),
        int(out_dtype == torch.float32),
        int(bias is not None and bias.dtype == torch.float32),
        int(is_bf16 and c % 8 == 0 and x.data_ptr() % 16 == 0),
        int(is_bf16 and k % 8 == 0 and w.data_ptr() % 16 == 0),
        MAINLOOPS.index(plan.mainloop), plan.splits, plan.chunk,
        int(round_c), ws.data_ptr() if ws is not None else None,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv2d kernel launch failed: CUDA error {rc} "
                           f"({lib.repro_cuda_error_string(rc).decode()})")
    conv2d_cuda.launches += 1
    conv2d_cuda.mainloops[plan.mainloop] += 1
    conv2d_cuda.split_launches += plan.splits > 1
    return out


def reset_conv_counts(fn=None):
    """Zero the counters of ``conv2d_cuda`` (or of a stand-in ``fn`` bound
    to its name)."""
    fn = fn or conv2d_cuda
    fn.launches = fn.split_launches = 0
    fn.mainloops = dict.fromkeys(MAINLOOPS, 0)


reset_conv_counts()

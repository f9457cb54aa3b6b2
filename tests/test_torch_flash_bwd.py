"""The flash backward's plan and its wgmma kernels' walk, on the CPU.

``kernels/flash_attention/bwd.py::plan_call`` is plain Python: bf16 q, k,
v, y and dy that TMA can describe take the wgmma mainloop, fp32 the simt
one, and bf16 views that TMA cannot describe the first kernel (wmma).  It
is held on CPU tensors laid out as the training path lays them out: q, k,
v the attention layer's head-split views, y the forward's contiguous
output, dy the transposed view of the merged heads' gradient.

``wgmma_flash_bwd_model`` is what ``dq_wgmma_kernel`` and
``dkdv_wgmma_kernel`` (``flash_attention_bwd/csrc/flash_bwd.cu``) compute,
written out in numpy: their grids in launch order (kernel A's q tiles from
the last, kernel B's k tiles from the first), the loop bounds, the masks
applied only on the tiles that straddle the diagonal, the window's edge
or Tk (each element's row and column from the wgmma fragment layout),
P = exp2(S * scale * log2 e - lse * log2 e) from the forward's lse with
+inf past Tq, kernel B's per-column (lse, delta) pairs, the group's steps
split between kernel B's warpgroups and their partials added in order,
and the rows with no valid key.  It is held against the gradients of the
reference's ``mha_ref`` (``jax.vjp``), in fp32 at 1e-4 (sums in other
orders, exp2 for exp), causal, windowed and not, GQA, Tq != Tk with rows
that see no key, T not a multiple of the tile, d = 32, 64 and 128.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import mha_ref as jmha_ref
from repro_torch.kernels.flash_attention import bwd as FB
from repro_torch.kernels.flash_attention import (mha_ref,
                                                 reset_flash_bwd_counts)
from repro_torch.kernels.flash_attention.kernel import MAINLOOPS

BF = torch.bfloat16
RNG = np.random.default_rng(29)
NEG_INF = -1e30
TILE = 64
LOG2E = math.log2(math.e)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def head_split(b, t, h, d, dtype=BF):
    """(B, T, H, d) viewed as (B, H, T, d), as the attention layer hands
    q, k and v over, and as dO, the merged heads' gradient, comes back."""
    return torch.zeros(b, t, h, d, dtype=dtype).transpose(1, 2)


def train_views(b=2, hq=9, hkv=3, t=100, d=64, dtype=BF):
    q, k, v = head_split(b, t, hq, d, dtype), head_split(b, t, hkv, d, dtype), \
        head_split(b, t, hkv, d, dtype)
    y = torch.zeros(b, hq, t, d, dtype=dtype)         # the forward's output
    return q, k, v, y, head_split(b, t, hq, d, dtype)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("hq,hkv", [(9, 3), (4, 4), (8, 2)])
def test_bwd_plan_train_views_take_wgmma(d, hq, hkv):
    views = train_views(hq=hq, hkv=hkv, d=d)
    assert FB.plan_call(*views) == "wgmma"
    assert FB.plan_call(*(t.contiguous() for t in views)) == "wgmma"
    assert FB.plan_call(*(t.float() for t in views)) == "simt"


@pytest.mark.parametrize("which", range(5))
@pytest.mark.parametrize("case", ["rows overlap", "base off 16 bytes",
                                  "head stride 4"])
def test_bwd_plan_tma_illegal_takes_wmma(which, case):
    """Any one of q, k, v, y, dy that TMA cannot read sends the call to the
    wmma kernel, which reads every view through its strides."""
    views = list(train_views(b=2, hq=4, hkv=2, t=96, d=64))
    like = views[which]
    b, h, t, d = like.shape
    if case == "rows overlap":        # rows 8 elements apart
        bad = torch.zeros(b * h * (8 * t + d), dtype=BF).as_strided(
            like.shape, (h * (8 * t + d), 8 * t + d, 8, 1))
    elif case == "base off 16 bytes":
        bad = torch.zeros(b * t * h * d + 1, dtype=BF)[1:].view(
            b, t, h, d).transpose(1, 2)
    else:
        bad = torch.zeros(b * h * t * 68, dtype=BF).as_strided(
            like.shape, (h * t * 68, 4, 68, 1))
    views[which] = bad
    assert FB.plan_call(*views) == "wmma"


def test_bwd_plan_no_key_stays_off_wgmma():
    q, k, v, y, dy = train_views()
    assert FB.plan_call(q, k[:, :, :0], v[:, :, :0], y, dy) == "wmma"


def test_bwd_counters_reset_by_mainloop():
    FB.flash_attention_bwd_cuda.launches = 4
    FB.flash_attention_bwd_cuda.mainloops["wgmma"] = 4
    reset_flash_bwd_counts()
    assert FB.flash_attention_bwd_cuda.launches == 0
    assert FB.flash_attention_bwd_cuda.mainloops == dict.fromkeys(MAINLOOPS,
                                                                  0)


# --------------------------------------------------------------------------
# the wgmma kernels' walk
# --------------------------------------------------------------------------

def dq_grid(nq):
    """Kernel A's q tiles in launch order (blockIdx.z outermost, the q tile
    counted from the last)."""
    return [nq - 1 - z for z in range(nq)]


def dq_kv_tiles(q0, tk, causal, window):
    """The KV tiles kernel A walks for the q tile at q0."""
    kv_end = min(tk, q0 + TILE) if causal else tk
    kv_begin = max(0, q0 - window + 1) if window else 0
    return range(kv_begin // TILE, -(-kv_end // TILE))


def dkdv_steps(k0, tq, group, causal, window):
    """Kernel B's (group member, q tile) steps for the k tile at k0."""
    i_begin = k0 // TILE if causal else 0
    q_end = min(tq, k0 + TILE - 1 + window) if window else tq
    n_i = max(0, -(-q_end // TILE) - i_begin)
    return [(g, i_begin + i) for g in range(group) for i in range(n_i)]


def b_wgs(d):
    """Kernel B's consumer warpgroups (flash_bwd.cu's B_WGS)."""
    return 2 if d <= 64 else 1


def fragment_mask(rows, cols, tk, causal, window, kernel_b):
    """The kernel's mask of one 64 x 64 tile, from each fragment element's
    (row, col).  Kernel A: rows q, cols keys; B: rows keys, cols q.  Rows
    past Tq need none: their lse is +inf."""
    q, kk = (cols[None, :], rows[:, None]) if kernel_b else \
        (rows[:, None], cols[None, :])
    ok = kk < tk
    if causal:
        ok = ok & (kk <= q)
    if window:
        ok = ok & (kk > q - window)
    return ok


def wgmma_flash_bwd_model(q, k, v, y, lse, dy, *, causal, window, scale):
    """(dq, dk, dv, delta) as the wgmma kernels compute them, in fp32."""
    nb, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    nq, nk = -(-tq // TILE), -(-tk // TILE)
    c = np.float32(scale * LOG2E)

    def pad(a, t):
        out = np.zeros(a.shape[:2] + (t, d), np.float32)
        out[:, :, :a.shape[2]] = a
        return out

    qq, yy, gg = pad(q, nq * TILE), pad(y, nq * TILE), pad(dy, nq * TILE)
    kk, vv = pad(k, nk * TILE), pad(v, nk * TILE)
    dq = np.zeros_like(qq)
    delta = np.zeros((nb, hq, tq), np.float32)
    # Kernel A's (lse * log2 e, delta) rows for kernel B: +inf, 0 past Tq.
    stats = np.zeros((nb, hq, nq * TILE, 2), np.float32)

    # ---- kernel A ----
    for b in range(nb):
        for h in range(hq):
            for qt in dq_grid(nq):
                q0 = qt * TILE
                rows = q0 + np.arange(TILE)
                live = rows < tq
                dl = (yy[b, h, rows] * gg[b, h, rows]).sum(1)
                delta[b, h, rows[live]] = dl[live]
                ls = np.where(live, lse[b, h, np.minimum(rows, tq - 1)]
                              * LOG2E, np.inf).astype(np.float32)
                stats[b, h, rows] = np.stack([ls, dl], 1)
                for j in dq_kv_tiles(q0, tk, causal, window):
                    k0 = j * TILE
                    cols = k0 + np.arange(TILE)
                    kt, vt = kk[b, h // group, cols], vv[b, h // group, cols]
                    s = qq[b, h, rows] @ kt.T
                    dp = gg[b, h, rows] @ vt.T
                    edge = (k0 + TILE > tk or (causal and k0 + TILE - 1 > q0)
                            or (window and k0 <= q0 + TILE - 1 - window))
                    ok = (fragment_mask(rows, cols, tk, causal, window,
                                        False) if edge else True)
                    with np.errstate(over="ignore"):
                        p = np.where(ok, np.exp2(s * c - ls[:, None]), 0)
                    ds = p * (dp - dl[:, None]) * scale
                    dq[b, h, rows] += ds @ kt

    # ---- kernel B ----
    dk, dv = np.zeros_like(kk), np.zeros_like(vv)
    wgs = b_wgs(d)
    for b in range(nb):
        for hk in range(hkv):
            for kt in range(nk):           # launch order: the first first
                k0 = kt * TILE
                keys = k0 + np.arange(TILE)
                kb_, vb_ = kk[b, hk, keys], vv[b, hk, keys]
                part = np.zeros((wgs, 2, TILE, d), np.float32)
                steps = dkdv_steps(k0, tq, group, causal, window)
                for step, (g, i) in enumerate(steps):
                    h, q0 = hk * group + g, i * TILE
                    cols = q0 + np.arange(TILE)
                    ls, dl = stats[b, h, cols, 0], stats[b, h, cols, 1]
                    st = kb_ @ qq[b, h, cols].T             # S^T
                    dpt = vb_ @ gg[b, h, cols].T            # dP^T
                    edge = (k0 + TILE > tk or (causal and k0 + TILE - 1 > q0)
                            or (window and k0 <= q0 + TILE - 1 - window))
                    ok = (fragment_mask(keys, cols, tk, causal, window,
                                        True) if edge else True)
                    with np.errstate(over="ignore"):
                        p = np.where(ok, np.exp2(st * c - ls[None, :]), 0)
                    dst = p * (dpt - dl[None, :]) * scale
                    part[step % wgs, 0] += dst @ qq[b, h, cols]
                    part[step % wgs, 1] += p @ gg[b, h, cols]
                acc = part[0]
                for w in range(1, wgs):                    # in order
                    acc = acc + part[w]
                dk[b, hk, keys], dv[b, hk, keys] = acc[0], acc[1]
            # Rows with no valid key: 1 / Tk of their dO to every key's dV.
            if window and tq > tk + window - 1:
                empty = np.zeros(d, np.float32)
                for g in range(group):
                    h = hk * group + g
                    for r in range(max(0, tk + window - 1), tq):
                        if lse[b, h, r] <= 0.5 * NEG_INF:
                            empty += dy[b, h, r]
                dv[b, hk] += np.float32(1.0 / tk) * empty
    return dq[:, :, :tq], dk[:, :, :tk], dv[:, :, :tk], delta


def _rng(*shape):
    return RNG.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("tq,tk,hq,hkv,d,causal,window", [
    (150, 150, 4, 2, 32, True, None),      # causal, ragged T, GQA
    (200, 200, 3, 3, 64, True, 70),        # windowed, group 1
    (130, 130, 4, 1, 64, False, None),     # non-causal, group 4
    (150, 70, 4, 2, 64, False, 20),        # Tq > Tk: rows with no key
    (70, 150, 3, 1, 32, False, None),      # Tq < Tk
    (100, 100, 2, 1, 128, True, 40),       # d = 128, windowed, GQA
    (64, 64, 2, 2, 128, True, None),       # one tile
    (40, 100, 2, 1, 32, False, 33),        # windowed, Tq < Tk
])
def test_wgmma_flash_bwd_model_matches_reference(tq, tk, hq, hkv, d, causal,
                                                 window):
    q, k, v = _rng(1, hq, tq, d), _rng(1, hkv, tk, d), _rng(1, hkv, tk, d)
    dy = _rng(1, hq, tq, d)
    scale = d ** -0.5
    y, lse = mha_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                     causal=causal, window=window, return_lse=True)
    dq, dk, dv, delta = wgmma_flash_bwd_model(
        q, k, v, y.numpy(), lse.numpy(), dy, causal=causal, window=window,
        scale=scale)
    out, vjp = jax.vjp(lambda a, b_, c_: jmha_ref(
        a, b_, c_, causal=causal, window=window), *(jnp.asarray(a)
                                                    for a in (q, k, v)))
    want = vjp(jnp.asarray(dy))
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(
        delta, (np.asarray(out) * dy).sum(-1), atol=1e-4, rtol=1e-4)
    if window and tq > tk + window - 1:    # the case has rows with no key
        assert (lse.numpy()[..., tk + window - 1:] <= 0.5 * NEG_INF).all()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None)])
def test_wgmma_flash_bwd_grids_heaviest_first(causal, window):
    """At the training shape's T = 512, each kernel launches its blocks in
    order of non-increasing work: kernel A's q tiles from the last, kernel
    B's k tiles from the first."""
    t, group = 512, 3
    nt = t // TILE
    work_a = [len(dq_kv_tiles(qt * TILE, t, causal, window))
              for qt in dq_grid(nt)]
    work_b = [len(dkdv_steps(kt * TILE, t, group, causal, window))
              for kt in range(nt)]
    if window:                              # the band's two ends are light
        assert max(work_a) == work_a[0] and max(work_b) == work_b[0]
    else:
        assert work_a == sorted(work_a, reverse=True)
        assert work_b == sorted(work_b, reverse=True)
    if causal and not window:
        assert work_a == list(range(nt, 0, -1))
        assert work_b == [group * n for n in range(nt, 0, -1)]
    assert sum(work_a) * group == sum(work_b)    # the same live tile pairs


def test_wgmma_flash_bwd_kernel_b_splits_steps_between_warpgroups():
    """d <= 64: two warpgroups take every other step, so the longest block
    at the training shape (the first k tile: 3 heads x 8 q tiles) runs 12
    steps in series; d = 128 keeps one."""
    steps = dkdv_steps(0, 512, 3, True, None)
    assert len(steps) == 24
    assert [len(steps[w::b_wgs(64)]) for w in range(b_wgs(64))] == [12, 12]
    assert b_wgs(32) == 2 and b_wgs(128) == 1

"""The plans of ``batched_matmul`` and the flash forward, on the CPU.

``kernels/brgemm/kernel.py::plan_batched`` and
``kernels/flash_attention/kernel.py::plan`` are plain Python: bf16 operands
that TMA can describe take the wgmma mainloop, fp32 the simt one, and bf16
that TMA cannot describe (row strides that are not multiples of 8
elements, a base off 16-byte alignment, rows or entries that overlap) the
first kernel (wmma).  They are held on CPU tensors laid out as the paths
lay them out: the paper's ``batched_matmul`` cases, ``brgemm``'s backward
(g broadcast with B_i^T, A_i^T with g, each a transposed view), a
broadcast B, and the attention layer's head-split views.

``wgmma_flash_model`` is what the flash forward's wgmma kernel computes,
written out in numpy: its walk over 64-key tiles for each block of 64 q
rows (the loop bounds, the masks applied only on the tiles that straddle
the diagonal, the window's edge or Tk), the online
softmax in the log2 domain with a per-thread partial l, and the mean of V
for a row with no valid key.  It is held against the reference's
``mha_ref`` (JAX) and lse against the port's ``mha_ref`` (itself held
against the reference in ``test_torch_kernels.py``), in fp32 at 3e-5 (sums
in other orders), causal, windowed and not, Tq != Tk with rows that see no
key, T not a multiple of the tile.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import mha_ref as jmha_ref
from repro_torch.kernels.brgemm import kernel as BK
from repro_torch.kernels.brgemm.kernel import (_batched_operand,
                                               plan_batched,
                                               plan_batched_call,
                                               reset_matmul_counts)
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import mha_ref, reset_flash_counts

BF = torch.bfloat16
RNG = np.random.default_rng(23)
F32 = dict(atol=3e-5, rtol=3e-5)
NEG_INF = -1e30

# (B, m, k, n): the paper's cases (chip_smoke.py's BRGEMM_CASES).
CASES = [(16, 64, 64, 64), (32, 128, 128, 128), (64, 64, 256, 64),
         (8, 4096, 1024, 1024)]


# --------------------------------------------------------------------------
# batched_matmul
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nb,m,k,n", CASES)
def test_batched_plan_at_the_papers_cases(nb, m, k, n):
    a, b = torch.zeros(nb, m, k, dtype=BF), torch.zeros(nb, k, n, dtype=BF)
    g = torch.zeros(m, n, dtype=BF)
    want_bm = 64 if m <= 64 else 128
    for lhs, rhs in ((a, b), (g, b.transpose(1, 2)), (a.transpose(1, 2), g),
                     (a, b[0])):
        p = plan_batched_call(lhs, rhs)
        assert p.mainloop == "wgmma", (lhs.shape, rhs.shape)
        assert p.splits == 1 and p.chunk * p.bk >= lhs.size(-1)
        assert p.bm == (64 if lhs.size(-2) <= 64 else 128)
    assert plan_batched_call(a, b).bm == want_bm
    p32 = plan_batched_call(a.float(), b.float())
    assert p32.mainloop == "simt" and p32.splits == 1


def test_batched_operands_of_brgemms_backward():
    """dA = g B_i^T: g a 2-D map (batch stride 0), B_i^T column-major;
    dB = A_i^T g: A_i^T column-major, g 2-D; each entry's batch stride
    covers it."""
    nb, m, k, n = 4, 96, 80, 40
    a, b = torch.zeros(nb, m, k, dtype=BF), torch.zeros(nb, k, n, dtype=BF)
    g = torch.zeros(m, n, dtype=BF)
    _, bstride, ld, trans, vec = _batched_operand(g, "g")
    assert (bstride, ld, trans, vec) == (0, n, 0, 1)
    _, bstride, ld, trans, vec = _batched_operand(b.transpose(1, 2), "b")
    assert (bstride, ld, trans, vec) == (k * n, n, 1, 1)
    _, bstride, ld, trans, vec = _batched_operand(a.transpose(1, 2), "a")
    assert (bstride, ld, trans, vec) == (m * k, k, 1, 1)
    assert plan_batched_call(g, b.transpose(1, 2)).mainloop == "wgmma"
    assert plan_batched_call(a.transpose(1, 2), g).mainloop == "wgmma"
    # one entry: a 2-D map, whatever its batch stride
    assert _batched_operand(a[:1], "a")[1] == 0
    assert plan_batched_call(a[:1], b[:1]).mainloop == "wgmma"


def test_batched_plan_ragged_rows_padded_for_tma():
    """k = 100 with rows padded to 104 elements: TMA reads it (its zero
    fill ends each entry's k, the 3-D map's entry coordinate); rows 100
    apart it cannot: wmma."""
    nb, m, k, n = 5, 70, 100, 136
    a = torch.zeros(nb, m, 104, dtype=BF)[:, :, :k]
    b = torch.zeros(nb, k, n, dtype=BF)
    assert plan_batched_call(a, b).mainloop == "wgmma"
    assert plan_batched_call(a.transpose(1, 2),
                             torch.zeros(m, n, dtype=BF)).mainloop == "wgmma"
    assert plan_batched_call(a.contiguous(), b).mainloop == "wmma"


@pytest.mark.parametrize("case", ["rows 36 apart", "base off 16 bytes",
                                  "entries overlap", "batch stride 4",
                                  "rows overlap"])
def test_batched_plan_tma_illegal_takes_wmma(case):
    nb, m, k, n = 3, 32, 64, 48
    b = torch.zeros(nb, k, n, dtype=BF)
    if case == "rows 36 apart":
        a = torch.zeros(nb, m, 36, dtype=BF)
        b = torch.zeros(nb, 36, n, dtype=BF)
    elif case == "base off 16 bytes":
        a = torch.zeros(nb * m * k + 1, dtype=BF)[1:].view(nb, m, k)
    elif case == "entries overlap":        # batch stride 8 < m * k
        a = torch.zeros(8 * nb + m * k, dtype=BF).as_strided(
            (nb, m, k), (8, k, 1))
    elif case == "batch stride 4":
        a = torch.zeros(4 * nb + m * k, dtype=BF).as_strided(
            (nb, m, k), (4, k, 1))
    else:                                  # row stride 8 < k
        a = torch.zeros(nb * (m * 8 + k), dtype=BF).as_strided(
            (nb, m, k), (m * 8 + k, 8, 1))
    assert plan_batched_call(a, b).mainloop == "wmma"
    assert plan_batched_call(a.float(), b.float()).mainloop == "simt"


def test_batched_plan_no_reduction_stays_off_wgmma():
    assert plan_batched(64, 64, 0, True, True).mainloop == "wmma"
    assert plan_batched(64, 64, 64, True, True).mainloop == "wgmma"


def test_counters_reset_by_mainloop():
    BK.batched_matmul_cuda.mainloops["wgmma"] = 3
    BK.matmul_cuda.mainloops["simt"] = 2
    reset_matmul_counts()
    assert BK.batched_matmul_cuda.mainloops == dict.fromkeys(BK.MAINLOOPS, 0)
    assert BK.matmul_cuda.mainloops == dict.fromkeys(BK.MAINLOOPS, 0)
    FK.flash_attention_cuda.mainloops["wgmma"] = 5
    FK.flash_attention_cuda.launches = 5
    reset_flash_counts()
    assert FK.flash_attention_cuda.mainloops == dict.fromkeys(
        FK.MAINLOOPS, 0)
    assert FK.flash_attention_cuda.launches == 0


# --------------------------------------------------------------------------
# the flash forward
# --------------------------------------------------------------------------

def head_split(b, t, h, d, dtype=BF):
    """(B, T, H, d) viewed as (B, H, T, d), as the attention layer hands
    q, k and v over."""
    return torch.zeros(b, t, h, d, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("hq,hkv", [(9, 3), (4, 4), (8, 2)])
def test_flash_plan_head_split_views_take_wgmma(d, hq, hkv):
    q, k, v = head_split(2, 100, hq, d), head_split(2, 70, hkv, d), \
        head_split(2, 70, hkv, d)
    assert FK.plan_call(q, k, v) == "wgmma"
    assert FK.plan_call(q.contiguous(), k.contiguous(),
                        v.contiguous()) == "wgmma"
    assert FK.plan_call(q.float(), k.float(), v.float()) == "simt"


def test_flash_plan_tma_illegal_takes_wmma():
    q = head_split(2, 96, 4, 64)
    k = v = head_split(2, 96, 2, 64)
    # rows 8 elements apart overlap: TMA is not asked to read them
    over = torch.zeros(2 * 2 * (8 * 96 + 64), dtype=BF).as_strided(
        (2, 2, 96, 64), (2 * (8 * 96 + 64), 8 * 96 + 64, 8, 1))
    assert FK.plan_call(q, over, v) == "wmma"
    # a base 2 bytes off alignment, a head stride of 4 elements
    off = torch.zeros(2 * 96 * 4 * 64 + 1, dtype=BF)[1:].view(2, 96, 4, 64)
    assert FK.plan_call(off.transpose(1, 2), k, v) == "wmma"
    odd = torch.zeros(2 * 2 * 96 * 68, dtype=BF).as_strided(
        (2, 2, 96, 64), (2 * 96 * 68, 4, 68, 1))
    assert FK.plan_call(q, odd, v) == "wmma"
    # no key at all
    assert FK.plan_call(q, k[:, :, :0], v[:, :, :0]) == "wmma"


@pytest.mark.parametrize("shape", [(1, 4, 50, 64), (3, 1, 50, 64),
                                   (1, 1, 1, 32), (2, 3, 1, 128)])
def test_flash_tma_strides_of_single_entries(shape):
    """A dimension of one entry is read at coordinate 0 alone; its stride
    (any value in PyTorch) becomes a multiple of 8 elements that spans the
    tensor; the others are the view's own."""
    t = torch.zeros(shape, dtype=BF)
    strides = FK._tma_strides(t)
    for i, s in enumerate(strides):
        assert s % 8 == 0 and s > 0
        if shape[i] > 1:
            assert s == t.stride(i)
        else:
            assert s >= t.numel()
    q = head_split(2, 40, 1, 64)              # a single head, transposed
    assert FK._tma_strides(q)[1] % 8 == 0 and FK._tma_strides(q)[1] > 0


def _rng(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def wgmma_flash_model(q, k, v, *, causal, window, scale):
    """What flash_fwd_wgmma_kernel computes, in fp32 numpy: o and lse."""
    nb, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group, kvt, bq = hq // hkv, 64, 64
    c = np.float32(scale * math.log2(math.e))
    o = np.zeros(q.shape, np.float32)
    lse = np.full((nb, hq, tq), NEG_INF, np.float32)
    for b in range(nb):
        for h in range(hq):
            kk = np.zeros((-(-tk // kvt) * kvt, d), np.float32)
            vv = np.zeros_like(kk)
            kk[:tk], vv[:tk] = k[b, h // group], v[b, h // group]
            for qt in range(-(-tq // bq)):
                q0 = qt * bq
                kv_end = min(tk, q0 + bq) if causal else tk
                kv_begin = max(0, q0 - window + 1) if window else 0
                rows = np.arange(q0, q0 + bq)
                qq = np.zeros((bq, d), np.float32)
                live = rows < tq
                qq[live] = q[b, h, rows[live]]
                m = np.full(bq, NEG_INF, np.float32)
                l = np.zeros(bq, np.float32)
                acc = np.zeros((bq, d), np.float32)
                for j in range(kv_begin // kvt, -(-kv_end // kvt)):
                    k0 = j * kvt
                    cols = np.arange(k0, k0 + kvt)
                    s = (qq @ kk[cols].T) * c
                    if (k0 + kvt > tk or (causal and k0 + kvt - 1 > q0)
                            or (window and k0 <= q0 + bq - 1 - window)):
                        ok = cols[None, :] < tk
                        if causal:
                            ok = ok & (cols[None, :] <= rows[:, None])
                        if window:
                            ok = ok & (cols[None, :] > rows[:, None] - window)
                        s = np.where(ok, s, -np.inf)
                    mn = np.maximum(m, s.max(1))
                    corr = np.exp2(m - mn)
                    p = np.exp2(s - mn[:, None])
                    m, l = mn, l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ vv[cols]
                for r in np.nonzero(live)[0]:
                    if l[r] > 0:
                        o[b, h, rows[r]] = acc[r] / l[r]
                        lse[b, h, rows[r]] = (m[r] + np.log2(l[r])) \
                            * math.log(2)
                    else:
                        o[b, h, rows[r]] = vv[:tk].mean(0)
    return o, lse


@pytest.mark.parametrize("tq,tk,hq,hkv,d,causal,window", [
    (150, 150, 4, 2, 32, True, None),      # causal, ragged T
    (200, 200, 3, 3, 32, True, 70),        # windowed, group 1
    (130, 130, 4, 1, 64, False, None),     # non-causal, group 4
    (150, 70, 4, 2, 32, False, 20),        # Tq > Tk: rows with no key
    (70, 150, 3, 1, 32, False, None),      # Tq < Tk
    (64, 64, 2, 2, 128, True, None),       # one tile
    (40, 100, 2, 1, 32, False, 33),        # windowed, Tq < Tk
])
def test_wgmma_flash_model_matches_reference(tq, tk, hq, hkv, d, causal,
                                             window):
    q, k, v = _rng(1, hq, tq, d), _rng(1, hkv, tk, d), _rng(1, hkv, tk, d)
    scale = d ** -0.5
    o, lse = wgmma_flash_model(q, k, v, causal=causal, window=window,
                               scale=scale)
    want = jmha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window)
    np.testing.assert_allclose(o, np.asarray(want), **F32)
    _, want_lse = mha_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, window=window, return_lse=True)
    np.testing.assert_allclose(lse, want_lse.numpy(), **F32)

"""Plain PyTorch attention (GQA, causal, sliding window, offset, padded KV).

``mha_ref`` is the semantic oracle: a full (Tq, Tk) softmax in fp32.  It is
the decode path's attention (one query against a padded cache) and the
``"torch"`` backend of ``flash_attention``, whose lse it also returns.
``flash_attention_bwd_ref`` is its gradient by autograd, and
``delta_rowsum_ref`` the softmax-Jacobian term the backward kernel fuses.

``flash_fwd_blockwise`` and ``flash_bwd_blockwise`` are the versions the
kernels are held against under bf16 accumulation: the forward's online
softmax over 64-key tiles with O rounded to bf16 in place after each
``round_k`` keys counted from key 0, the backward's dQ rounded after each
``round_k`` keys and dK, dV after each ``round_k`` q rows of a q-head (the
group's heads summed in turn into the rounded sums), as the kernels walk
them (``blocking.accum_block``).  Used by the tests and ``chip_smoke.py``
only.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mha_ref(q, k, v, *, causal: bool = True, window: int | None = None,
            scale: float | None = None, q_offset=0, kv_len=None,
            return_lse: bool = False):
    """q: (B, Hq, Tq, d); k: (B, Hkv, Tk, d); v: (B, Hkv, Tk, dv);
    Hq % Hkv == 0.  The output (B, Hq, Tq, dv) has v's head size, which
    may differ from q's and k's (MLA's q and k are wider than its v).

    ``q_offset``: absolute position of q[0] (decode: Tq = 1, offset = pos).
    ``kv_len``: number of valid kv positions (for padded decode caches).
    Either may be an int, shared by the batch, or a (B,) integer tensor,
    one per row (a slot pool's decode, each slot at its own position).
    ``window``: sliding-window size (positions <= pos - window masked).
    Masked scores are ``NEG_INF`` (-1e30), not -inf, as in the reference.
    With ``return_lse`` also returns the fp32 (B, Hq, Tq) log-sum-exp of
    the scaled scores, ``NEG_INF`` for a row with no valid key.

    GQA folds the q heads of each kv group into the rows of one product
    (q head h reads kv head h // group), so K and V are never repeated: a
    broadcast over the group would make ``torch.matmul`` copy K and V once
    a q head.
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} q heads do not group over {hkv} kv heads")
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5

    qg = q.float().reshape(b, hkv, group * tq, d)
    s = torch.matmul(qg, k.float().transpose(-1, -2)).reshape(
        b, hkv, group, tq, tk) * scale                   # (b,hkv,g,tq,tk)
    q_pos = torch.arange(tq, device=q.device)[:, None]
    k_pos = torch.arange(tk, device=q.device)[None, :]
    if isinstance(q_offset, torch.Tensor):    # per row: (b, 1, 1, tq, 1)
        q_pos = q_offset.reshape(b, 1, 1, 1, 1) + q_pos
    else:
        q_pos = q_offset + q_pos
    if isinstance(kv_len, torch.Tensor):
        kv_len = kv_len.reshape(b, 1, 1, 1, 1)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    if kv_len is not None:
        mask = mask & (k_pos < kv_len)
    s = torch.where(mask, s, NEG_INF)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    den = p.sum(dim=-1, keepdim=True)
    p = p / den
    out = torch.matmul(p.to(v.dtype).float().reshape(b, hkv, group * tq, tk),
                       v.float())
    out = out.reshape(b, hq, tq, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(mask.any(dim=-1, keepdim=True), mx + torch.log(den),
                      NEG_INF)
    return out, lse.reshape(b, hq, tq)


def delta_rowsum_ref(y, dy):
    """``rowsum(dY * Y)`` in fp32: (B, H, T, d) -> (B, H, T)."""
    return (y.float() * dy.float()).sum(dim=-1)


def flash_attention_bwd_ref(q, k, v, y, lse, dy, *, causal: bool = True,
                            window: int | None = None,
                            scale: float | None = None):
    """(dq, dk, dv) by autograd through ``mha_ref``, in the inputs' dtypes.

    The reference's ``xla`` backend of ``flash_attention_bwd``: it rebuilds
    everything from q, k and v, so ``y`` and ``lse`` are not read.
    """
    del y, lse
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = mha_ref(*leaves, causal=causal, window=window, scale=scale)
        return torch.autograd.grad(out, leaves, dy)


def _bf16_round(t):
    return t.to(torch.bfloat16).float()


def _mask(tq, tk, causal, window, device):
    q_pos = torch.arange(tq, device=device)[:, None]
    k_pos = torch.arange(tk, device=device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def _empty_weight(tk, dtype):
    """mha_ref's weight of each key in a row with no valid key: 1 / Tk in
    V's type."""
    return float(torch.tensor(1.0 / tk).to(dtype))


def flash_fwd_blockwise(q, k, v, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None, round_k: int = 128,
                        tile: int = 64):
    """(o, lse) of the flash forward under bf16 accumulation: an online
    softmax over ``tile``-key tiles in fp32 (P cast to V's type before its
    product), O rounded to bf16 in place after each ``round_k`` keys and
    after the last tile (``round_k`` 0: never, fp32 accumulation).  Shapes
    as ``mha_ref``'s; a row with no valid key gets mha_ref's mean of V and
    lse ``NEG_INF``."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.float().reshape(b, hkv, group * tq, d)
    mask = _mask(tq, tk, causal, window, q.device).repeat(group, 1)
    rows = group * tq
    m = q.new_full((b, hkv, rows, 1), NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    o = q.new_zeros((b, hkv, rows, v.shape[-1]), dtype=torch.float32)
    n_tiles = -(-tk // tile)
    for j in range(n_tiles):
        k0 = j * tile
        kt, vt = k[:, :, k0:k0 + tile].float(), v[:, :, k0:k0 + tile]
        s = torch.matmul(qg, kt.transpose(-1, -2)) * scale
        s = torch.where(mask[:, k0:k0 + tile], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
        if round_k and (((j + 1) * tile) % round_k == 0
                        or j == n_tiles - 1):
            o = _bf16_round(o)
    empty = l == 0
    mean_v = _empty_weight(tk, v.dtype) * v.float().sum(2, keepdim=True)
    out = torch.where(empty, mean_v, o / torch.where(empty, 1.0, l))
    lse = torch.where(empty, NEG_INF, m + torch.log(torch.where(
        empty, 1.0, l)))
    return (out.reshape(b, hq, tq, -1).to(q.dtype),
            lse.reshape(b, hq, tq))


def flash_bwd_blockwise(q, k, v, y, lse, dy, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None, round_k: int = 128):
    """(dq, dk, dv) of the flash backward under bf16 accumulation, from the
    forward's ``y`` and ``lse``: P = exp(S scale - lse) and dS = P (dP -
    delta) scale in fp32, each cast to q's type before its product; dQ
    summed over keys and rounded to bf16 in place after each ``round_k``
    of them, dK and dV summed over q rows, q-head by q-head of the group,
    and rounded after each ``round_k`` rows of a head and at its end
    (``round_k`` 0: never, fp32 accumulation).  A row with no valid key
    adds 1 / Tk (in V's type) of its dO to every key's dV after the sums,
    as the kernels do."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    dt = q.dtype
    q5 = q.float().reshape(b, hkv, group, tq, d)
    dy5 = dy.float().reshape(b, hkv, group, tq, -1)
    delta = (y.float() * dy.float()).sum(-1).reshape(b, hkv, group, tq, 1)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    mask = _mask(tq, tk, causal, window, q.device)
    s = torch.matmul(q5, kf.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hkv, group, tq, 1)),
                    0.0)
    dp = torch.matmul(dy5, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dt).float()
    p = p.to(dt).float()
    rnd = _bf16_round if round_k else (lambda t: t)
    dq = torch.zeros_like(q5)
    kb = round_k or max(tk, 1)
    for k0 in range(0, tk, kb):
        dq = rnd(dq + torch.matmul(ds[..., k0:k0 + kb],
                                   kf[:, :, :, k0:k0 + kb]))
    dk = q.new_zeros((b, hkv, tk, d), dtype=torch.float32)
    dv = q.new_zeros((b, hkv, tk, v.shape[-1]), dtype=torch.float32)
    qb = round_k or max(tq, 1)
    for g in range(group):
        for q0 in range(0, tq, qb):
            rows = slice(q0, q0 + qb)
            dk = rnd(dk + torch.matmul(
                ds[:, :, g, rows].transpose(-1, -2), q5[:, :, g, rows]))
            dv = rnd(dv + torch.matmul(
                p[:, :, g, rows].transpose(-1, -2), dy5[:, :, g, rows]))
    empty = ~mask.any(-1)
    if bool(empty.any()):
        dv = dv + _empty_weight(tk, v.dtype) * dy5[:, :, :, empty].sum(
            (2, 3))[:, :, None]
    return (dq.reshape(b, hq, tq, d).to(dt), dk.to(k.dtype),
            dv.to(v.dtype))

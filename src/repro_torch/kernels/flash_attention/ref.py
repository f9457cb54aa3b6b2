"""Plain PyTorch attention (GQA, causal, sliding window, offset, padded KV).

``mha_ref`` is the semantic oracle: a full (Tq, Tk) softmax in fp32.  It is
the decode path's attention (one query against a padded cache) and the
``"torch"`` backend of ``flash_attention``, whose lse it also returns.
``flash_attention_bwd_ref`` is its gradient by autograd, and
``delta_rowsum_ref`` the softmax-Jacobian term the backward kernel fuses.
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

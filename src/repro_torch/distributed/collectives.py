"""Gradient compression with error feedback: the port of
``repro/distributed/collectives.py``.

Compressing the fp32 gradients to int8 (one absmax scale a tensor) or to
bf16 before the optimizer models the wire format of a compressed
all-reduce.  Error feedback keeps convergence: the residual of one step's
compression is added to the next step's gradients, carried by the caller.
The functions are plain ones over ``{name: tensor}`` gradients, the
reference's arithmetic bit for bit: ``scale = max(absmax, 1e-30) / 127``,
``q = clip(round(g / scale), -127, 127)`` (round half to even), and
``q * scale`` back in fp32.  The reference takes one scale a leaf of its
tree, and its leaves stack the layers: ``groups`` ({name: group}) gives
the gradients that share one scale, the absmax over all of them
(``interop.stacked_leaves`` names the reference's stacks); a name it
does not list is a group of its own.
"""
from __future__ import annotations

import torch

KINDS = ("bf16", "int8")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"gradient compression kind {kind!r}; expected one "
                         f"of {', '.join(KINDS)}")


def compress_grads(grads: dict, *, kind: str = "int8", groups=None):
    """``(compressed, scales)``: bf16 copies and None, or int8 tensors and
    their fp32 0-d scales (one a group), each by the gradient's name."""
    _check_kind(kind)
    if kind == "bf16":
        return {n: g.to(torch.bfloat16) for n, g in grads.items()}, None
    members = {}
    for n in grads:
        members.setdefault((groups or {}).get(n, n), []).append(n)
    q, scales = {}, {}
    for names in members.values():
        amax = torch.stack([grads[n].float().abs().amax()
                            for n in names]).amax()
        scale = torch.clamp_min(amax, 1e-30) / 127.0
        for n in names:
            scales[n] = scale
            q[n] = torch.clamp(torch.round(grads[n].float() / scale), -127,
                               127).to(torch.int8)
    return q, scales


def decompress_grads(grads: dict, scales, *, kind: str = "int8") -> dict:
    """The fp32 gradients of :func:`compress_grads`' output."""
    _check_kind(kind)
    if kind == "bf16":
        return {n: g.float() for n, g in grads.items()}
    return {n: q.float() * scales[n] for n, q in grads.items()}


def compress_with_error_feedback(grads: dict, residual, *,
                                 kind: str = "int8"):
    """Error-feedback compression: ``d = D(C(g + r))``, ``r' = (g + r) -
    d``.  ``residual`` None starts from zeros.  Returns ``(d, r')``."""
    if residual is None:
        residual = {n: torch.zeros_like(g, dtype=torch.float32)
                    for n, g in grads.items()}
    biased = {n: g.float() + residual[n] for n, g in grads.items()}
    deq = decompress_grads(*compress_grads(biased, kind=kind), kind=kind)
    return deq, {n: biased[n] - deq[n] for n in biased}

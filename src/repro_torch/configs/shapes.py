"""Input shapes and the (arch x shape) applicability rule (a copy of
``repro.configs.shapes``, kept inside the port so that it never imports
the JAX package)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchCfg


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524_288, 1),
}

# Families with sub-quadratic sequence handling (O(1)-state recurrence or
# bounded-window attention) run long_500k; pure full-attention archs skip it.
_SUBQUADRATIC_BLOCKS = ("xlstm", "rglru_hybrid")


def applicable(arch: ArchCfg, shape: ShapeCfg) -> tuple[bool, str]:
    if shape.name == "long_500k":
        if arch.block in _SUBQUADRATIC_BLOCKS:
            return True, ""
        if arch.block == "dense" and arch.window:
            # bounded sliding window -> ring cache of size `window`
            return True, ""
        return False, (
            "long_500k skipped: pure full-attention arch cannot hold a "
            "524k dense KV cache")
    return True, ""

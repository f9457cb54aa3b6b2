"""grok-1-314b [moe] — 8 experts top-2.

64L d_model=6144 48H (GQA kv=8) d_ff=32768(per-expert) vocab=131072
[hf:xai-org/grok-1; unverified]
"""
from repro_torch.configs.base import ArchCfg

CONFIG = ArchCfg(
    name="grok-1-314b",
    family="moe",
    block="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    tie_embeddings=False,
)

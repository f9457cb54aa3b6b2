"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000 [arXiv:2402.19427]
"""
from repro_torch.configs.base import ArchCfg

CONFIG = ArchCfg(
    name="recurrentgemma-9b",
    family="hybrid",
    block="rglru_hybrid",
    n_layers=38,               # 12 x (rec, rec, attn) + 2 trailing rec
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    window=2048,               # local attention window
    pattern=("rec", "rec", "attn"),
    d_rnn=4096,                # lru width
)

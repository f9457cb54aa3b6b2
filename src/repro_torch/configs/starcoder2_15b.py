"""starcoder2-15b [dense] — GQA + RoPE.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152 [arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ArchCfg

CONFIG = ArchCfg(
    name="starcoder2-15b",
    family="dense",
    block="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    window=4096,      # starcoder2 uses sliding-window attention
    gated_mlp=False,  # plain GELU FFN (d_ff = 4d)
    mlp_activation="gelu",
)

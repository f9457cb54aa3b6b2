"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 experts + MTP.

61L d_model=7168 128H (GQA kv=128) d_ff=2048(per-expert) vocab=129280
[arXiv:2412.19437; hf]
"""
from repro_torch.configs.base import ArchCfg

CONFIG = ArchCfg(
    name="deepseek-v3-671b",
    family="moe",
    block="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,          # dense-FFN hidden for the first n_dense_layers
    vocab=129280,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    n_dense_layers=3,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp=True,
    tie_embeddings=False,
)

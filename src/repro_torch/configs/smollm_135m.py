"""smollm-135m [dense] — llama-arch small; the serving path's model.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""
from repro_torch.configs.base import ArchCfg

CONFIG = ArchCfg(
    name="smollm-135m",
    family="dense",
    block="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
)

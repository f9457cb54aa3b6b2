"""llava-next-34b [vlm] — anyres-tiled VLM; transformer backbone only.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The modality frontend (anyres patch tiling + CLIP tower) is a STUB: a
batch carries precomputed patch embeddings (``patch_embeds``) of length
``n_patches``, projected and prepended to the token sequence.  The head
is the tied embedding table, as in the reference's config.
"""
from repro_torch.configs.base import ArchCfg

CONFIG = ArchCfg(
    name="llava-next-34b",
    family="vlm",
    block="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    n_patches=576,      # one anyres tile of 24x24 patches (stub frontend)
)

"""seamless-m4t-large-v2 [audio] — enc-dec transformer backbone.

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf]

The audio frontend (w2v-BERT conformer stack) is a stub: requests carry
precomputed frame embeddings (``src_embeds``) for the encoder.  24L is
read as 24 encoder + 24 decoder layers (the published text-decoder depth).
"""
from repro_torch.configs.base import ArchCfg

CONFIG = ArchCfg(
    name="seamless-m4t-large-v2",
    family="audio",
    block="encdec",
    n_layers=24,          # decoder layers
    n_enc_layers=24,      # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    tie_embeddings=False,
    gated_mlp=False,   # standard ReLU FFN (d_ff = 8d)
    mlp_activation="relu",
)

"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1 ratio, xLSTM[7:1]).

48L d_model=2048 4H d_ff=0 (mixer-internal FFN only) vocab=50304
[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ArchCfg

CONFIG = ArchCfg(
    name="xlstm-1.3b",
    family="ssm",
    block="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=8,       # one sLSTM per 8 layers -> 7:1 mLSTM:sLSTM
)

"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff=0 per the card: xLSTM blocks carry their own internal up-projections
(mLSTM: pre-up-projection factor 2; sLSTM: post-up-projection factor 4/3),
so there is no separate FFN sublayer.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=6,             # xLSTM[7:1]-style mix: every 6th block is sLSTM
    source="arXiv:2405.04517",
))

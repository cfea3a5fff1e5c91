from .base import ModelConfig
# xlstm-350m [ssm]: mLSTM blocks with sLSTM every 6th layer.
# d_ff=0: no separate FFN (projection factor 2 inside the mLSTM block).
# [arXiv:2405.04517; unverified]
CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, slstm_every=6,
)
SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab_size=256, slstm_every=2,
)

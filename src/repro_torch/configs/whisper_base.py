from .base import ModelConfig
# whisper-base [audio]: enc-dec, conv frontend stubbed (the serving inputs
# carry precomputed frame embeddings).  [arXiv:2212.04356; unverified]
CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    rope_theta=0.0,  # learned/sinusoidal positions, no RoPE
)
SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16, rope_theta=0.0,
)

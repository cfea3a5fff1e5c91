from .base import ModelConfig
# gemma3-27b [dense]: 62L, 5:1 local(1024):global attention, 128k context.
# [hf:google/gemma-3-1b-pt; unverified]
CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab_size=262144, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    local_window=1024, local_per_global=5,
    tie_embeddings=True, logit_softcap=30.0,
)
SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    qk_norm=True, local_window=16, local_per_global=5,
    logit_softcap=30.0,
)

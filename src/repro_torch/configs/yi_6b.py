from .base import ModelConfig
# yi-6b [dense]: llama-arch GQA 32/4.  [arXiv:2403.04652; hf]
CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128,
    rope_theta=5e6,
)
SMOKE = ModelConfig(
    name="yi-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=8,
)

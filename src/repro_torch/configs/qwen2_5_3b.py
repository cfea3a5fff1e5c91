from .base import ModelConfig
# qwen2.5-3b [dense]: GQA 16/2, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
)
SMOKE = ModelConfig(
    name="qwen2.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, qkv_bias=True,
)

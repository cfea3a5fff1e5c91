from .base import ModelConfig
# qwen3-moe-235b-a22b [moe]: 94L, 128 experts top-8, 1536/expert.
# [hf:Qwen/Qwen3-30B-A3B; hf]
CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    n_experts=128, top_k=8,
)
SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab_size=256, head_dim=16, qk_norm=True,
    n_experts=8, top_k=2, capacity_factor=8.0,  # cf>=E/k: no drops
)

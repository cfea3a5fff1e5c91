from .base import ModelConfig
# phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend (stubbed).
# [hf:microsoft/Phi-3-vision-128k-instruct; hf]
CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    rope_theta=10000.0, n_patches=576, patch_embed_dim=1024,
)
SMOKE = ModelConfig(
    name="phi-3-vision-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    n_patches=8, patch_embed_dim=32,
)

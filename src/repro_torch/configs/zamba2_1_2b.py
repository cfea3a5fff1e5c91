from .base import ModelConfig
# zamba2-1.2b [hybrid]: Mamba2 backbone + one shared attention block
# applied every 6 layers.  [arXiv:2411.15242; hf]
CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    shared_attn_every=6,
    # the shared block's attention at 500k decode uses a sliding-window
    # cache (DESIGN.md arch-applicability)
    local_window=4096,
)
SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    ssm_state=8, ssm_head_dim=16, ssm_expand=2, ssm_groups=1,
    shared_attn_every=2, local_window=64,
)

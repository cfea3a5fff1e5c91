"""Unified architecture config: a copy of the reference's
``repro/configs/base.py::ModelConfig``.  The port keeps its own copy and
imports nothing of the reference package."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # attention
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    local_window: int | None = None      # sliding-window size for local layers
    local_per_global: int = 0            # gemma3: 5 local : 1 global
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    # hybrid (zamba2): one shared attention block applied every k layers
    shared_attn_every: int = 0
    # xlstm
    slstm_every: int = 0
    # enc-dec
    n_enc_layers: int = 0
    # vlm stub
    n_patches: int = 0
    patch_embed_dim: int = 1024
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    logit_softcap: float | None = None

    @property
    def head_dim_resolved(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding so embedding/lm-head shard evenly
        over the model axis (e.g. granite's 49155 -> 49408).  Logits beyond
        ``vocab_size`` are masked in the loss and sliced off at serving."""
        return -(-self.vocab_size // 256) * 256

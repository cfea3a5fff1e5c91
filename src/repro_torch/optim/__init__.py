"""Optimizer and learning-rate schedules, the port's counterpart of
``repro/optim`` (AdamW in fp32; the 8-bit AdamW is not ported yet)."""
from .adamw import AdamW, clip_by_global_norm
from .schedule import warmup_cosine, wsd

__all__ = ["AdamW", "clip_by_global_norm", "warmup_cosine", "wsd"]

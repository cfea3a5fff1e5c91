"""Optimizers and learning-rate schedules, the port's counterpart of
``repro/optim``: AdamW in fp32 and the 8-bit AdamW."""
from .adamw import AdamW, clip_by_global_norm
from .adamw8bit import AdamW8bit
from .schedule import warmup_cosine, wsd

__all__ = ["AdamW", "AdamW8bit", "clip_by_global_norm", "warmup_cosine",
           "wsd"]

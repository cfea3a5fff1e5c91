"""Learning-rate schedules: callables of the step (a 0-d integer tensor)
returning a 0-d fp32 tensor on the step's device, as
``repro/optim/schedule.py`` returns a traced scalar."""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``min_ratio * peak_lr`` at ``total_steps``."""
    def lr(step):
        step = _steps(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def wsd(peak_lr: float, warmup_steps: int, total_steps: int,
        decay_frac: float = 0.1):
    """Warmup-stable-decay: linear warmup, ``peak_lr`` held, then a linear
    decay to 0 over the last ``decay_frac`` of ``total_steps``."""
    decay_steps = int(total_steps * decay_frac)
    stable_end = total_steps - decay_steps

    def lr(step):
        step = _steps(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        dec = peak_lr * torch.clamp((total_steps - step)
                                    / max(decay_steps, 1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm,
                           torch.where(step < stable_end,
                                       torch.full_like(step, peak_lr), dec))
    return lr

"""Training runtime, the port's counterpart of ``repro/train``: the train
step, the loop with checkpoints and auto-resume, the watchdog."""
from . import checkpoint
from .trainer import (TrainConfig, Trainer, Watchdog, make_train_step,
                      param_dtypes)

__all__ = ["TrainConfig", "Trainer", "Watchdog", "checkpoint",
           "make_train_step", "param_dtypes"]

"""The port's model families (dense, moe, vlm and hybrid) behind one
``Model`` API."""
from .model import Model, build_model

__all__ = ["Model", "build_model"]

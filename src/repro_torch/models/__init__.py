"""The port's model families (dense so far) behind one ``Model`` API."""
from .model import Model, build_model

__all__ = ["Model", "build_model"]

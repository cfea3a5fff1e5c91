"""Token streams for training, the port's counterpart of ``repro/data``."""
from .pipeline import MMapTokens, Prefetcher, SyntheticTokens

__all__ = ["MMapTokens", "Prefetcher", "SyntheticTokens"]

"""Architecture registry: ``get_config(arch)`` / ``smoke_config(arch)``.

The port's own copy of ``repro/configs``.  It lists only the archs the
port can build; the others join as their families are ported.
"""
from importlib import import_module

from .base import ModelConfig

ARCHS = {
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen2.5-3b": "qwen2_5_3b",
    "zamba2-1.2b": "zamba2_1_2b",
}


def _norm(name: str) -> str:
    if name in ARCHS:
        return ARCHS[name]
    alt = name.replace("-", "_").replace(".", "_")
    if alt in ARCHS.values():
        return alt
    raise KeyError(f"unknown arch {name!r}; the port builds: {sorted(ARCHS)}")


def get_config(name: str) -> ModelConfig:
    return import_module(f".{_norm(name)}", __package__).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return import_module(f".{_norm(name)}", __package__).SMOKE


def list_archs():
    return sorted(ARCHS)

"""Architecture registry: ``get_config(arch)`` / ``smoke_config(arch)``.

The port's own copy of ``repro/configs``: all ten archs of the
reference, in its six families.
``qwen3-moe-235b-a22b`` (about 470 GB in bf16) fits no single card: its
``CONFIG`` is a faithful copy, served only as ``SMOKE`` or as a copy cut
in depth.
"""
from importlib import import_module

from .base import ModelConfig

ARCHS = {
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen2.5-3b": "qwen2_5_3b",
    "yi-6b": "yi_6b",
    "gemma3-27b": "gemma3_27b",
    "xlstm-350m": "xlstm_350m",
    "zamba2-1.2b": "zamba2_1_2b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "whisper-base": "whisper_base",
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

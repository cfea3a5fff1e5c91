"""Family dispatch: the port's ``Model`` API, dense family only.

The counterpart of ``repro/models/model.py``.  A ``Model`` exposes the
serving hooks the engine drives, for both KV layouts:

  model.init(seed, device=, dtype=)           - parameter dict
  model.prefill(params, batch, cache_len=)    - (logits, dense cache)
  model.decode(params, cache, tokens)         - (logits, dense cache)
  model.cache_expand(sub, batch)              - batch-1 prefill cache ->
                                                empty B-slot pool
  model.cache_slot_write(cache, sub, i)       - prefill-on-admit into slot i
  model.paged_cache_init(batch=, n_blocks=, block_size=, max_blocks=,
                         dtype=, device=)     - empty block-pool cache
  model.cache_dtype(params)                   - KV dtype of the pool
  model.prefill_paged(params, pc, batch, slot, chunk, prefill_len)
  model.decode_paged(params, pc, tokens)

``supports_prefill_len``: the prefill takes ``batch["prefill_len"]`` for
right-padded (bucketed) prompts.

Other families (moe, vlm, ssm, hybrid, encdec) raise
``NotImplementedError`` until their slices are ported.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from . import transformer
from .layers import init_params, param_count


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    templates: Any
    prefill: Callable
    decode: Callable
    cache_expand: Callable
    cache_slot_write: Callable
    paged_cache_init: Callable
    cache_dtype: Callable
    prefill_paged: Callable
    decode_paged: Callable
    supports_prefill_len: bool = True

    def init(self, seed: int = 0, *, device=None, dtype=torch.bfloat16):
        """Seeded random parameters on ``device`` (``cuda`` by default)."""
        return init_params(self.templates, seed,
                           device=resolve_device(device), dtype=dtype)

    @property
    def n_params(self) -> int:
        return param_count(self.templates)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            "port builds the dense family")
    return Model(
        cfg, transformer.decoder_templates(cfg),
        functools.partial(transformer.decoder_prefill, cfg=cfg),
        functools.partial(transformer.decoder_decode_step, cfg=cfg),
        transformer.decoder_cache_expand,
        transformer.decoder_cache_slot_write,
        functools.partial(transformer.decoder_paged_cache_init, cfg),
        transformer.decoder_cache_dtype,
        functools.partial(transformer.decoder_prefill_paged, cfg=cfg),
        functools.partial(transformer.decoder_decode_step_paged, cfg=cfg),
    )

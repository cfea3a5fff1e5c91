"""Family dispatch: the port's ``Model`` API, dense, moe, vlm and hybrid
families.

The counterpart of ``repro/models/model.py``.  A ``Model`` exposes the
serving hooks the engine drives:

  model.init(seed, device=, dtype=)           - parameter dict
  model.prefill(params, batch, cache_len=)    - (logits, dense cache)
  model.decode(params, cache, tokens)         - (logits, dense cache)
  model.cache_expand(sub, batch)              - batch-1 prefill cache ->
                                                empty B-slot pool
  model.cache_slot_write(cache, sub, i)       - prefill-on-admit into slot i
  model.cache_slot_reset(cache, i)            - zero slot i's state on free
                                                or preempt (scan families;
                                                None for the KV families,
                                                whose stale strips are
                                                masked by pos instead)

and, for the transformer families, the paged-KV hooks (None for the scan
families, whose state is O(1) per slot and has no block pool):

  model.paged_cache_init(batch=, n_blocks=, block_size=, max_blocks=,
                         dtype=, device=)     - empty block-pool cache
  model.cache_dtype(params)                   - KV dtype of the pool
  model.prefill_paged(params, pc, batch, slot, chunk, prefill_len)
  model.decode_paged(params, pc, tokens)

Two layout flags steer the engine's bookkeeping:

  bounded_cache        - ``cache_len`` bounds a request's cache writes (KV
                         strips).  False for hybrid (recurrent state plus a
                         ring that wraps): the engine skips the budget check.
  supports_prefill_len - the prefill takes ``batch["prefill_len"]`` for
                         right-padded (bucketed) prompts.  A scan prefill
                         folds every position into its state, so the engine
                         refuses ``bucket=`` for it.

moe and vlm share the dense family's hooks (``models.transformer``); a
vlm prefill also takes ``batch["patches"]``.  The other families (ssm,
encdec) raise ``NotImplementedError`` until their slices are ported.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from . import hybrid, transformer
from .layers import init_params, param_count


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    templates: Any
    prefill: Callable
    decode: Callable
    cache_expand: Callable
    cache_slot_write: Callable
    cache_slot_reset: Callable | None = None
    paged_cache_init: Callable | None = None
    cache_dtype: Callable | None = None
    prefill_paged: Callable | None = None
    decode_paged: Callable | None = None
    bounded_cache: bool = True
    supports_prefill_len: bool = True

    def init(self, seed: int = 0, *, device=None, dtype=torch.bfloat16):
        """Seeded random parameters on ``device`` (``cuda`` by default)."""
        return init_params(self.templates, seed,
                           device=resolve_device(device), dtype=dtype)

    @property
    def n_params(self) -> int:
        return param_count(self.templates)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return Model(
            cfg, transformer.decoder_templates(cfg),
            functools.partial(transformer.decoder_prefill, cfg=cfg),
            functools.partial(transformer.decoder_decode_step, cfg=cfg),
            transformer.decoder_cache_expand,
            transformer.decoder_cache_slot_write,
            paged_cache_init=functools.partial(
                transformer.decoder_paged_cache_init, cfg),
            cache_dtype=transformer.decoder_cache_dtype,
            prefill_paged=functools.partial(
                transformer.decoder_prefill_paged, cfg=cfg),
            decode_paged=functools.partial(
                transformer.decoder_decode_step_paged, cfg=cfg),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg, hybrid.hybrid_templates(cfg),
            functools.partial(hybrid.hybrid_prefill, cfg=cfg),
            functools.partial(hybrid.hybrid_decode_step, cfg=cfg),
            hybrid.hybrid_cache_expand,
            hybrid.hybrid_cache_slot_write,
            cache_slot_reset=hybrid.hybrid_cache_slot_reset,
            bounded_cache=False,    # O(1) state + a wrapping attention ring
            supports_prefill_len=False,
        )
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet; the port "
        "builds the dense, moe, vlm and hybrid families (ssm and encdec are "
        "still to come)")

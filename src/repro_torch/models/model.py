"""Family dispatch: the port's ``Model`` API over the reference's six
families, dense, moe, vlm, hybrid, ssm and encdec.

The counterpart of ``repro/models/model.py``.  A ``Model`` exposes the
training loss and the serving hooks the engine drives:

  model.init(seed, device=, dtype=)           - parameter dict
  model.loss(params, batch, remat=)           - (loss, {"loss", "accuracy"}):
                                                ``transformer.decoder_loss``
                                                (dense, moe, vlm),
                                                ``hybrid.hybrid_loss``,
                                                ``xlstm_lm.xlstm_loss`` (ssm)
                                                or ``encdec.encdec_loss``
                                                (its batch also carries
                                                ``frames``)
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

and, for the transformer families, the paged-KV hooks (None for the
slot-state families, hybrid, ssm and encdec, which serve on the dense slot
layout):

  model.paged_cache_init(batch=, n_blocks=, block_size=, max_blocks=,
                         dtype=, device=)     - empty block-pool cache
  model.cache_dtype(params)                   - KV dtype of the pool
  model.prefill_paged(params, pc, batch, slot, chunk, prefill_len)
  model.decode_paged(params, pc, tokens)

Two layout flags steer the engine's bookkeeping:

  bounded_cache        - ``cache_len`` bounds a request's cache writes (KV
                         strips, encdec's decoder strips included).  False
                         for ssm (state O(1) in context) and hybrid
                         (recurrent state plus a ring that wraps): the
                         engine skips the budget check.
  supports_prefill_len - the prefill takes ``batch["prefill_len"]`` for
                         right-padded (bucketed) prompts.  A slot-state
                         prefill folds every position into its state, so
                         the engine refuses ``bucket=`` for it.

moe and vlm share the dense family's hooks (``models.transformer``); a
vlm prefill also takes ``batch["patches"]``.  ssm (xlstm,
``models.xlstm_lm``), hybrid and encdec (``models.encdec``; its prefill
also takes ``batch["frames"]``) are the slot-state families: slot hooks
only, each slot's state zeroed on free.  Any other family raises
``ValueError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from . import encdec, hybrid, transformer, xlstm_lm
from .layers import init_params, param_count


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    templates: Any
    loss: Callable
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
            functools.partial(transformer.decoder_loss, cfg=cfg),
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
            functools.partial(hybrid.hybrid_loss, cfg=cfg),
            functools.partial(hybrid.hybrid_prefill, cfg=cfg),
            functools.partial(hybrid.hybrid_decode_step, cfg=cfg),
            hybrid.hybrid_cache_expand,
            hybrid.hybrid_cache_slot_write,
            cache_slot_reset=hybrid.hybrid_cache_slot_reset,
            bounded_cache=False,    # O(1) state + a wrapping attention ring
            supports_prefill_len=False,
        )
    if cfg.family == "ssm":
        return Model(
            cfg, xlstm_lm.xlstm_templates(cfg),
            functools.partial(xlstm_lm.xlstm_loss, cfg=cfg),
            functools.partial(xlstm_lm.xlstm_prefill, cfg=cfg),
            functools.partial(xlstm_lm.xlstm_decode_step, cfg=cfg),
            xlstm_lm.xlstm_cache_expand,
            xlstm_lm.xlstm_cache_slot_write,
            cache_slot_reset=xlstm_lm.xlstm_cache_slot_reset,
            bounded_cache=False,    # the state does not grow with context
            supports_prefill_len=False,
        )
    if cfg.family == "encdec":
        return Model(
            cfg, encdec.encdec_templates(cfg),
            functools.partial(encdec.encdec_loss, cfg=cfg),
            functools.partial(encdec.encdec_prefill, cfg=cfg),
            functools.partial(encdec.encdec_decode_step, cfg=cfg),
            encdec.encdec_cache_expand,
            encdec.encdec_cache_slot_write,
            cache_slot_reset=encdec.encdec_cache_slot_reset,
            # the decoder's self strips are cache_len wide: budget enforced
            supports_prefill_len=False,
        )
    raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); the "
                     "port builds dense, moe, vlm, hybrid, ssm and encdec")

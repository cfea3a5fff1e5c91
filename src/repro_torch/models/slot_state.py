"""Slot-addressable recurrent-state hooks for continuous batching.

The port's counterpart of ``repro/models/slot_state.py``.  The engine's
continuous scheduler needs three per-slot cache operations from a family:

  cache_expand(sub, batch)        batch-1 prefill cache -> empty B-slot pool
  cache_slot_write(cache, sub, i) write a batch-1 prefill cache into slot i
  cache_slot_reset(cache, i)      zero slot i's state on free / preempt

A scan family's cache is a flat dict of state leaves whose batch (slot)
axis is given per leaf by ``{leaf name: batch axis}``, plus ``pos``: a
scalar in a batch-1 prefill cache, a ``(B,)`` vector in the pool.  No leaf
couples two slots, so admitting, evicting or zeroing a request touches one
index of each leaf.  The pool's tensors are written in place, as the port's
dense hooks do; the hooks return the dict anyway.
"""
from __future__ import annotations

import torch


def make_slot_hooks(batch_axes: dict[str, int]):
    """(cache_expand, cache_slot_write, cache_slot_reset) for a cache dict
    whose leaf ``name`` carries its batch axis at ``batch_axes[name]``.
    ``pos`` must not be in the map: it is the per-slot position vector."""
    if "pos" in batch_axes:
        raise ValueError("pos is implicit (the per-slot position vector)")

    def cache_expand(sub, batch: int):
        """An empty ``batch``-slot pool shaped like the batch-1 prefill
        cache ``sub``: every state leaf zero, positions a (B,) zero vector;
        slots are filled by ``cache_slot_write`` on admission."""
        out = {}
        for name, ax in batch_axes.items():
            x = sub[name]
            out[name] = torch.zeros(x.shape[:ax] + (batch,) + x.shape[ax + 1:],
                                    dtype=x.dtype, device=x.device)
        out["pos"] = torch.zeros((batch,), dtype=torch.int32,
                                 device=sub["pos"].device)
        return out

    def cache_slot_write(cache, sub, slot: int):
        """Write the batch-1 prefill cache ``sub`` into slot ``slot``, in
        place (prefill-on-admit).  Every leaf of the slot is overwritten, so
        nothing of a previous occupant survives."""
        for name, ax in batch_axes.items():
            cache[name].select(ax, slot).copy_(sub[name].select(ax, 0))
        cache["pos"][slot] = sub["pos"].reshape(())
        return cache

    def cache_slot_reset(cache, slot: int):
        """Zero slot ``slot``'s state and position, in place (slot freed or
        its request preempted): no state of a finished request survives in
        the pool, and an idle slot's decode runs on zeros."""
        for name, ax in batch_axes.items():
            cache[name].select(ax, slot).zero_()
        cache["pos"][slot] = 0
        return cache

    return cache_expand, cache_slot_write, cache_slot_reset

"""Kernel dispatch, the port's counterpart of ``repro/kernels/ops.py``.

The implementation follows the tensor's device, and nothing else:

* a CPU tensor takes the plain PyTorch version;
* a CUDA tensor launches the hand-written kernel, or raises;
* any other device raises.

There is no environment override and no fallback: a CUDA tensor never
reaches a plain version through this module.
"""
from __future__ import annotations

from .paged_attention import (paged_decode_attention_cuda,
                              paged_decode_attention_plain,
                              paged_prefill_attention_cuda,
                              paged_prefill_attention_plain)


def _pick(x, plain, cuda, what: str, window):
    if window is not None:
        raise NotImplementedError(
            f"{what}(window={window}): sliding-window paged attention "
            "(gemma3's local layers) is not ported yet")
    kind = x.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return cuda
    raise ValueError(f"{what}: no implementation for device {x.device}")


def paged_decode_attention(q, k_pool, v_pool, block_table, kv_len, *,
                           scale=None, window=None):
    """Single-token GQA attention against a paged KV pool via a block
    table.  q: (B, Hq, 1, D); pools: (N, Hkv, bs, D); block_table: (B, M)
    int32; kv_len: (B,) int32.  Returns (B, Hq, 1, D)."""
    fn = _pick(q, paged_decode_attention_plain, paged_decode_attention_cuda,
               "paged_decode_attention", window)
    return fn(q, k_pool, v_pool, block_table, kv_len, scale=scale)


def paged_prefill_attention(q, k_pool, v_pool, block_table, q_start, *,
                            scale=None, window=None):
    """One prompt chunk's causal attention against a paged KV pool (the
    chunk's K/V must already sit in its block).  q: (B, Hq, Sq, D) at
    absolute positions ``q_start[b] + [0, Sq)``.  Returns (B, Hq, Sq, D)."""
    fn = _pick(q, paged_prefill_attention_plain,
               paged_prefill_attention_cuda, "paged_prefill_attention",
               window)
    return fn(q, k_pool, v_pool, block_table, q_start, scale=scale)

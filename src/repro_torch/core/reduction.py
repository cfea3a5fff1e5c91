"""The 3-step hierarchical reduction (paper contribution C3, §3
"Reductions"): a copy of the reference's ``repro/core/reduction.py``
without its mesh collectives, the single-array reduction on torch tensors
and the cycle functions (lines 129-162) in pure Python.

Ara2 reduces a vector in three phases: intra-lane (each lane reduces its
resident elements, the FPU pipeline registers as accumulators), inter-lane
(a log2(L)+1-step tree over the slide interconnect) and SIMD (a log-tree
within the final 64-bit word).  ``hierarchical_reduce`` mirrors that
structure on a tensor; ``reduction_drain_cycles`` is the paper's closed
form ``R*(1+log2(ceil(R))) - (ceil(R)-R) - 1`` for the intra-lane pipeline
drain.  (The reference's collectives in that module, ``allreduce_hd``,
``allreduce_rs_ag``, ``reduce_scatter_hd`` and ``allgather_hd``, are not
part of this copy; on the card the same three steps are the dot-product
kernel's thread, warp and block levels, ``kernels/csrc/dotproduct.cu``.)
"""
from __future__ import annotations

import math

import torch

from .vector_engine import log2i


def simd_tree_reduce(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Explicit log-step halving tree (phase 3).  Pads with zeros."""
    n = x.shape[axis]
    x = torch.movedim(x, axis, -1)
    p = 1 << (n - 1).bit_length() if n > 1 else 1
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def hierarchical_reduce(x: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """Full 3-step sum of a 1-D vector: stripe across lanes, intra-lane
    accumulate, inter-lane tree."""
    from .lanes import stripe
    lanes = stripe(x, n_lanes)           # (L, elems/lane)
    acc = torch.sum(lanes, dim=1)        # phase 1: intra-lane
    return simd_tree_reduce(acc, axis=0)  # phases 2+3: log tree


def reduction_drain_cycles(r: float) -> float:
    """Cycles to drain R pipeline-register partial sums into one:
    ``R*(1+log2(ceil(R))) - (ceil(R)-R) - 1``; for power-of-two R this is
    ``R*(1+log2(R)) - 1`` (paper §3)."""
    rc = math.ceil(r)
    if rc <= 1:
        return 0.0
    return r * (1 + math.log2(rc)) - (rc - r) - 1


def interlane_reduction_cycles(n_lanes: int, fpu_latency: int, slide_latency: int = 2) -> float:
    """(log2(L)+1) tree steps; the slide<->FPU dependency feedback pays both
    latencies at every step (paper §3)."""
    if n_lanes == 1:
        return 0.0
    return (log2i(n_lanes) + 1) * (fpu_latency + slide_latency)


def simd_reduction_cycles(ew_bits: int, fpu_latency: int) -> float:
    """Final intra-word tree: log2(64/EW) steps, each paying FPU latency."""
    steps = max(0, log2i(64 // ew_bits)) if ew_bits < 64 else 0
    return steps * fpu_latency


def vector_reduction_cycles(n_elems: int, n_lanes: int, ew_bits: int,
                            fpu_pipe: int) -> float:
    """End-to-end reduction latency: N/L streaming + intra-lane drain +
    inter-lane tree + SIMD tree."""
    n64 = n_elems * ew_bits // 64  # 64-bit packets (paper's N)
    stream = max(n64 / n_lanes, 1.0)
    return (stream
            + reduction_drain_cycles(fpu_pipe)
            + interlane_reduction_cycles(n_lanes, fpu_pipe)
            + simd_reduction_cycles(ew_bits, fpu_pipe))

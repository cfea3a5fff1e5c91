"""Power-of-two slide decomposition (paper contribution C2, §3 + Figs 2-3):
a copy of the reference's ``repro/core/slide.py`` without its mesh slides,
on torch tensors.

Ara2's insight: an interconnect supporting *arbitrary* slide amounts in one
step costs O(L^2) wiring; restricting single-step support to power-of-two
amounts and decomposing arbitrary slides into <= log2(L) micro-ops costs
O(L log L) and is what lets the unit scale.  ``slide`` and ``rotate`` run
that decomposition on a tensor; ``mux_count`` reproduces the Fig 3
interconnect-cost model (2:1 multiplexer count as an area/wiring proxy) for
the four slide-unit configurations the paper plots, including the ~70%
saving of the chosen design point.  (The reference's ``mesh_slide`` and
``mesh_halo_exchange``, shard rotations over a device mesh, are not part of
this copy.)
"""
from __future__ import annotations

import torch

from .vector_engine import log2i


def decompose_pow2(amount: int) -> list[int]:
    """Binary decomposition of a slide amount into power-of-two micro-ops.
    ``11 -> [8, 2, 1]``; sign is carried on each term."""
    sign = 1 if amount >= 0 else -1
    amount = abs(amount)
    return [sign * (1 << b) for b in range(amount.bit_length() - 1, -1, -1)
            if amount >> b & 1]


# ---------------------------------------------------------------------------
# Intra-array slides (vslideup/vslidedown semantics, zero fill).
# ---------------------------------------------------------------------------

def _shift1(x: torch.Tensor, amount: int, axis: int, fill) -> torch.Tensor:
    """One micro-op: shift by ``amount`` (any value) along ``axis``."""
    if amount == 0:
        return x
    n = x.shape[axis]
    out = torch.full_like(x, fill)
    k = min(abs(amount), n)
    if amount > 0:  # vslideup: element i -> i + amount
        out.narrow(axis, k, n - k).copy_(x.narrow(axis, 0, n - k))
    else:
        out.narrow(axis, 0, n - k).copy_(x.narrow(axis, k, n - k))
    return out


def slide(x: torch.Tensor, amount: int, axis: int = 0, fill=0) -> torch.Tensor:
    """Arbitrary-amount slide decomposed into power-of-two micro-ops.

    Functionally equal to a single shift; structurally it mirrors the Ara2
    hardware: each micro-op is a power-of-two shift the optimized SLDU
    supports natively."""
    for step in decompose_pow2(amount):
        x = _shift1(x, step, axis, fill)
    return x


def rotate(x: torch.Tensor, amount: int, axis: int = 0) -> torch.Tensor:
    """Circular slide via pow2 micro-ops."""
    n = x.shape[axis]
    amount %= n
    out = x
    for step in decompose_pow2(amount):
        out = torch.roll(out, step, dims=axis)
    return out


# ---------------------------------------------------------------------------
# Interconnect cost model (Fig 3) - 2:1 mux count as area/wiring proxy.
# ---------------------------------------------------------------------------

# Element widths whose re-encodings ("reshuffles") the SLDU must support, and
# the byte fan-in each re-encoding contributes per output byte.
_RESHUFFLE_EWS = (16, 32, 64)
_RESHUFFLE_FANIN_PER_EW = 8


def mux_count(n_lanes: int, mode: str = "slideP2_tmux") -> int:
    """Number of 2:1 multiplexers for a slide-unit interconnect over the
    ``B = 8 * L`` lane bytes.  An n-to-1 mux costs n-1 2:1 muxes.

    Modes (Fig 3):
      * ``all_to_all``    - arbitrary slides + same-cycle reshuffle: every
        output byte selects among all B input bytes.
      * ``slideP2_tmux``  - the Ara2 design point: power-of-two slides only,
        slide XOR reshuffle time-multiplexed (fan-in: 2*log2(B) slide sources
        + 8 re-encode sources per supported EW).
      * ``slideP2``       - power-of-two slides only, no reshuffle support.
      * ``slide1``        - slide-by-one only (+identity).
    """
    bytes_total = 8 * n_lanes
    lb = log2i(bytes_total)
    fanin = {
        "all_to_all": bytes_total,
        "slideP2_tmux": 2 * lb + _RESHUFFLE_FANIN_PER_EW * len(_RESHUFFLE_EWS),
        "slideP2": 2 * lb + 1,
        "slide1": 3,
    }[mode]
    return bytes_total * (max(fanin, 1) - 1)


def sldu_saving(n_lanes: int) -> float:
    """Predicted area/wiring saving of the optimized SLDU (paper: 'saving up
    to 70% of the estimated area and wires')."""
    return 1.0 - mux_count(n_lanes, "slideP2_tmux") / mux_count(n_lanes, "all_to_all")

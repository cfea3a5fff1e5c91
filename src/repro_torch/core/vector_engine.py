"""Ara2 machine model (paper contribution C1): a copy of the reference's
``repro/core/vector_engine.py``, pure Python.

``VectorEngineConfig`` is one Ara2 instance (L lanes, each with one 64-bit
FPU, a banked VRF slice and a share of the all-to-all units);
``ClusterConfig`` is a multi-core system of such engines.  They carry the
parameters the analytical performance model (:mod:`.perf_model`) reads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

# Ara2 ISA/microarchitecture constants (paper §2-§4).
RVV_NUM_VREGS = 32
# VLEN contribution per lane in bits (Table 1: "1024 VLEN per lane"; the VRF
# was reduced 4x w.r.t. Ara's 4096 b/lane, §6 Key insights).
VLEN_PER_LANE_BITS = 1024
# Each lane has 8 VRF banks (§5.3: "the effective number of banks used in each
# lane is reduced from eight ...").
BANKS_PER_LANE = 8
# Lane datapath width: one 64-bit element per lane per cycle (§3, segmented
# memory ops discussion).
LANE_DATAPATH_BITS = 64
# VLSU bandwidth is half the compute byte throughput (§6: 4*L B/cycle vs
# 8*L B/cycle).
VLSU_BYTES_PER_LANE_PER_CYCLE = 4
ALU_BYTES_PER_LANE_PER_CYCLE = 8
# CVA6 issue rate: cycles between two vfmacc dispatches in the matmul main
# loop.  RVV 1.0 dropped it from 5 to 4 (§7.1 "Issue rate limitation").
ISSUE_CYCLES_RVV10 = 4
ISSUE_CYCLES_RVV05 = 5
# FPU pipeline depth R per element width (§3 Reductions: "the number of FPU
# pipeline registers increases with the EW").  fpnew-calibrated.
FPU_PIPE_DEPTH = {64: 4, 32: 3, 16: 2}
# Memory latency from request to response (§4): 7 cycles for Ara2, 5 for CVA6.
ARA_MEM_LATENCY = 7
CVA6_MEM_LATENCY = 5


@dataclasses.dataclass(frozen=True)
class VectorEngineConfig:
    """One Ara2 instance: ``n_lanes`` lanes, one 64-bit FPU per lane."""

    n_lanes: int = 4
    vlen_per_lane_bits: int = VLEN_PER_LANE_BITS
    n_vregs: int = RVV_NUM_VREGS
    banks_per_lane: int = BANKS_PER_LANE
    issue_cycles: int = ISSUE_CYCLES_RVV10
    fpu_pipe_depth: Mapping[int, int] = dataclasses.field(
        default_factory=lambda: dict(FPU_PIPE_DEPTH)
    )

    def __post_init__(self):
        if self.n_lanes < 1 or self.n_lanes & (self.n_lanes - 1):
            raise ValueError(f"n_lanes must be a power of two, got {self.n_lanes}")

    # ---- architectural sizes -------------------------------------------------
    @property
    def vlen_bits(self) -> int:
        return self.vlen_per_lane_bits * self.n_lanes

    @property
    def vlen_bytes(self) -> int:
        return self.vlen_bits // 8

    @property
    def vrf_bytes(self) -> int:
        return self.n_vregs * self.vlen_bytes

    @property
    def vrf_bytes_per_lane(self) -> int:
        return self.vrf_bytes // self.n_lanes

    def max_elements(self, ew_bytes: int, lmul: int = 1) -> int:
        """Max elements per vector register group (vl at a given LMUL)."""
        return lmul * self.vlen_bytes // ew_bytes

    @property
    def n_fpus(self) -> int:
        return self.n_lanes  # one FPU per lane

    # ---- throughput bounds ---------------------------------------------------
    @property
    def peak_fma_flops_per_cycle(self) -> float:
        """Peak DP FLOP/cycle: one FMA (2 FLOP) per lane per cycle."""
        return 2.0 * self.n_lanes

    def peak_flops_per_cycle(self, ew_bytes: int) -> float:
        """SIMD-packed peak FLOP/cycle for a given element width."""
        return 2.0 * self.n_lanes * (8 // ew_bytes)

    @property
    def mem_bytes_per_cycle(self) -> float:
        return float(VLSU_BYTES_PER_LANE_PER_CYCLE * self.n_lanes)

    def bytes_per_lane(self, vector_bytes: float) -> float:
        """The paper's central knob (§5.1): per-PE work granularity."""
        return vector_bytes / self.n_lanes

    def fpu_pipe(self, ew_bits: int) -> int:
        return self.fpu_pipe_depth[ew_bits]


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """A multi-core Ara2 system (paper §7): ``n_cores`` engines + one CVA6 and
    one memory bank per engine."""

    n_cores: int = 1
    engine: VectorEngineConfig = dataclasses.field(default_factory=VectorEngineConfig)

    @property
    def n_fpus(self) -> int:
        return self.n_cores * self.engine.n_fpus

    @property
    def peak_fma_flops_per_cycle(self) -> float:
        return self.n_cores * self.engine.peak_fma_flops_per_cycle

    def describe(self) -> str:
        return f"{self.n_cores}x{self.engine.n_lanes}L"


def fixed_fpu_sweep(n_fpus: int) -> list[ClusterConfig]:
    """All (cores x lanes) configurations with a fixed FPU budget, the paper's
    §7 experiment frame (e.g. 16 FPUs: 1x16L, 2x8L, 4x4L, 8x2L)."""
    out = []
    lanes = 2
    while lanes <= n_fpus:
        cores = n_fpus // lanes
        if cores * lanes == n_fpus:
            out.append(ClusterConfig(cores, VectorEngineConfig(n_lanes=lanes)))
        lanes *= 2
    return sorted(out, key=lambda c: c.n_cores)


def log2i(x: int) -> int:
    if x <= 0 or x & (x - 1):
        raise ValueError(f"expected positive power of two, got {x}")
    return x.bit_length() - 1


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b

"""Ara2's analytical models and layout helpers, copied from the reference's
``repro/core``:

C1 lanes / bytes-per-lane  -> vector_engine, lanes
C2 pow2 slide decomposition -> slide
C3 3-step hierarchical reduction -> reduction
C5 ideality perf model      -> perf_model
C6 PPA / energy model       -> ppa

The models are pure Python; ``slide``, ``rotate``, ``stripe`` and the
reductions run on torch tensors, the VRF byte images on numpy arrays.  Not
copied: the reference's mesh collectives (``mesh_slide``,
``mesh_halo_exchange``, ``allreduce_*``, ``reduce_scatter_hd``,
``allgather_hd``) and its TPU constants (``TpuSpec``, ``TPU_V5E``).
"""
from .vector_engine import (VectorEngineConfig, ClusterConfig, fixed_fpu_sweep,
                            log2i, ceil_div, round_up)
from .perf_model import (KERNELS, KernelSpec, WhatIf, ideality, kernel_opc,
                         matmul_opc, matmul_cycles, util_curve,
                         issue_rate_limit_opc, pool_average_ideality,
                         dotproduct_speedup_vs_scalar)
from .slide import decompose_pow2, slide, rotate, mux_count, sldu_saving
from .reduction import (hierarchical_reduce, simd_tree_reduce,
                        reduction_drain_cycles, interlane_reduction_cycles,
                        simd_reduction_cycles, vector_reduction_cycles)
from .ppa import (TT_FREQ_GHZ, AREA_KGE, TABLE4, ENERGY_EFF_TABLE3,
                  system_area_kge, sldu_area_saving, system_power_w,
                  real_throughput_gflops, energy_efficiency_gflops_w)

"""Ara2's analytical models, copied from the reference's ``repro/core``
(pure Python): the machine model (C1, :mod:`.vector_engine`), the cycle
model of the 3-step reduction (C3, :mod:`.reduction`) and the ideality
performance model (C5, :mod:`.perf_model`).  The reference's ``lanes``,
``slide`` and ``ppa`` modules are not ported yet."""
from .vector_engine import (VectorEngineConfig, ClusterConfig, fixed_fpu_sweep,
                            log2i, ceil_div, round_up)
from .perf_model import (KERNELS, KernelSpec, WhatIf, ideality, kernel_opc,
                         matmul_opc, matmul_cycles, util_curve,
                         issue_rate_limit_opc, pool_average_ideality,
                         dotproduct_speedup_vs_scalar)
from .reduction import (reduction_drain_cycles, interlane_reduction_cycles,
                        simd_reduction_cycles, vector_reduction_cycles)

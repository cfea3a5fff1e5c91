"""The port's serving stack: the continuous-batching engine (dense and
paged), the multi-replica cluster (``ClusterEngine``: a router, one shared
block pool, preemption, sequential and threaded drivers), the block
allocator, scheduling policies, telemetry and utilization attribution
(``Attributor``: roofline verdicts and the FU-utilization rollup; see the
counterparts in ``repro/serving``)."""
from .attribution import (NULL_ATTR, VERDICTS, Attributor, MachineSpec,
                          NullAttributor, PhaseCost, dominant_verdict)
from .cluster import DRIVERS, ROUTER_POLICIES, ClusterEngine
from .engine import EngineStats, Request, Result, ServeEngine, TokenEvent
from .kvcache import (BlockAllocator, BlockPoolStats, PoolPressure,
                      blocks_needed, prefix_chain_keys)
from .slo import POLICIES, SchedPolicy, make_policy
from .telemetry import (MONOTONIC, NULL_TRACER, FakeClock, MetricsRegistry,
                        MonotonicClock, NullTracer, Tracer,
                        validate_lifecycle)

__all__ = ["NULL_ATTR", "VERDICTS", "Attributor", "MachineSpec",
           "NullAttributor", "PhaseCost", "dominant_verdict",
           "ClusterEngine", "DRIVERS", "ROUTER_POLICIES", "EngineStats", "Request", "Result", "ServeEngine", "TokenEvent",
           "BlockAllocator", "BlockPoolStats", "PoolPressure",
           "blocks_needed", "prefix_chain_keys", "POLICIES", "SchedPolicy",
           "make_policy", "MONOTONIC", "NULL_TRACER", "FakeClock",
           "MetricsRegistry", "MonotonicClock", "NullTracer", "Tracer",
           "validate_lifecycle"]

"""The port's serving stack: the paged continuous-batching engine, the
block allocator, scheduling policies and telemetry (see the counterparts
in ``repro/serving``)."""
from .engine import EngineStats, Request, Result, ServeEngine, TokenEvent
from .kvcache import (BlockAllocator, BlockPoolStats, PoolPressure,
                      blocks_needed, prefix_chain_keys)
from .slo import POLICIES, SchedPolicy, make_policy
from .telemetry import (MONOTONIC, NULL_TRACER, FakeClock, MetricsRegistry,
                        MonotonicClock, NullTracer, Tracer,
                        validate_lifecycle)

__all__ = ["EngineStats", "Request", "Result", "ServeEngine", "TokenEvent",
           "BlockAllocator", "BlockPoolStats", "PoolPressure",
           "blocks_needed", "prefix_chain_keys", "POLICIES", "SchedPolicy",
           "make_policy", "MONOTONIC", "NULL_TRACER", "FakeClock",
           "MetricsRegistry", "MonotonicClock", "NullTracer", "Tracer",
           "validate_lifecycle"]

"""Vectorized design-space exploration over the analytic CIM simulator:
batched allocate + simulate (``run_batch``), cartesian sweeps with shared
profile caching (``run_sweep``), the fused derive -> allocate -> eval
pipeline with K2 behind ``engine="kernel"`` (``run_fused_sweep``), the
sweeps' latency columns (``fabric=FabricEval(...)``, VT on the card), and
the Pareto frontiers (arrays-vs-throughput-vs-utilization, and
throughput-vs-p99-vs-utilization)."""

from .engine import AllocationBatch, allocate_batch, run_batch, to_allocation
from .fused import FusedPipeline, clear_fused_caches, get_fused_pipeline, run_fused_sweep
from .pareto import DEFAULT_OBJECTIVES, LATENCY_OBJECTIVES, pareto_frontier, pareto_mask
from .sweep import (
    FabricEval,
    SweepPoint,
    SweepResult,
    clear_caches,
    design_grid,
    get_captured,
    get_profiled,
    run_sweep,
)

__all__ = [
    "AllocationBatch",
    "allocate_batch",
    "run_batch",
    "to_allocation",
    "FusedPipeline",
    "clear_fused_caches",
    "get_fused_pipeline",
    "run_fused_sweep",
    "DEFAULT_OBJECTIVES",
    "LATENCY_OBJECTIVES",
    "pareto_frontier",
    "pareto_mask",
    "FabricEval",
    "SweepPoint",
    "SweepResult",
    "clear_caches",
    "design_grid",
    "get_captured",
    "get_profiled",
    "run_sweep",
]

"""Vectorized design-space exploration over the analytic CIM simulator:
batched allocate + simulate (``run_batch``), cartesian sweeps with shared
profile caching (``run_sweep``), the fused derive -> allocate -> eval
pipeline with K2 behind ``engine="kernel"`` (``run_fused_sweep``), the
sweeps' latency columns (``fabric=FabricEval(...)``, VT on the card), and
the multi-chip sweeps (``run_multichip_sweep`` and the fused (placement x
load) surface ``run_fused_multichip_sweep``), the fault sweep
(``run_fault_sweep``) and the Pareto frontiers over all of them."""

from .engine import AllocationBatch, allocate_batch, run_batch, to_allocation
from .faults import FaultPoint, FaultSweepResult, fault_grid, run_fault_sweep
from .fused import (
    FusedChipSweepResult,
    FusedPipeline,
    clear_fused_caches,
    get_fused_pipeline,
    run_fused_multichip_sweep,
    run_fused_sweep,
)
from .pareto import (
    DEFAULT_OBJECTIVES,
    FAULT_OBJECTIVES,
    LATENCY_OBJECTIVES,
    MULTICHIP_OBJECTIVES,
    pareto_frontier,
    pareto_mask,
)
from .sweep import (
    ChipSweepPoint,
    ChipSweepResult,
    FabricEval,
    SweepPoint,
    SweepResult,
    clear_caches,
    chip_grid,
    design_grid,
    get_captured,
    get_profiled,
    run_multichip_sweep,
    run_sweep,
)

__all__ = [
    "AllocationBatch",
    "allocate_batch",
    "run_batch",
    "to_allocation",
    "FaultPoint",
    "FaultSweepResult",
    "fault_grid",
    "run_fault_sweep",
    "FusedChipSweepResult",
    "FusedPipeline",
    "clear_fused_caches",
    "get_fused_pipeline",
    "run_fused_multichip_sweep",
    "run_fused_sweep",
    "DEFAULT_OBJECTIVES",
    "FAULT_OBJECTIVES",
    "LATENCY_OBJECTIVES",
    "MULTICHIP_OBJECTIVES",
    "pareto_frontier",
    "pareto_mask",
    "ChipSweepPoint",
    "ChipSweepResult",
    "FabricEval",
    "SweepPoint",
    "SweepResult",
    "clear_caches",
    "chip_grid",
    "design_grid",
    "get_captured",
    "get_profiled",
    "run_multichip_sweep",
    "run_sweep",
]

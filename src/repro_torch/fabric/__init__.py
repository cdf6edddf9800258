"""Discrete-event CIM fabric runtime (ported from the reference ``fabric``).

The analytic model (``core/cim/simulate.py``) answers "what is the
steady-state pipelined throughput of this allocation"; this package answers
the serving questions that need explicit time: tail latency under bursty
arrivals, behavior when the live input distribution drifts off the profile
(with online re-allocation from a reserve), and several networks sharing
one fabric.

Two equivalent engines: the event calendar (``FabricSim``, numpy on the
host, supports drift re-allocation, timelines and failure replay) and the
virtual-time scan (``VirtualTimeFabric``: one launch of the VT kernel on the
card for a whole batch of (allocation, trace) pairs, bit-identical to the
event engine), which powers latency-aware provisioning
(``provision_latency_aware``) and the sweeps' latency columns.  ``fleet``
replays long traces in O(lanes + sketch) memory: one streaming VT launch
per call or segment (``run_stream``, ``run_trace_segments``,
``run_trace_failures``).  Tenants may share a multi-chip fabric
(``allocate_shared(topology=)``).
"""

from .arrivals import (
    MMPP2,
    ClosedLoop,
    PoissonOpen,
    SinusoidalPoisson,
    TraceReplay,
    arrival_times,
)
from .dispatch import FabricSim
from .drift import DriftConfig, OnlineReallocator, shift_profile
from .events import EventCalendar, PoolStats, ServerPool
from .fleet import (
    FleetResult,
    SegmentedReplayResult,
    SegmentReport,
    run_stream,
    run_trace_failures,
    run_trace_segments,
    segment_growth_plan,
)
from .failures import (
    DegradePlan,
    FailureEvent,
    FailureTrace,
    RetryPolicy,
    degrade_plan,
    degrade_plan_from_allocs,
    failure_step_schedule,
    generate_failure_events,
    generate_failure_trace,
    lane_chips,
)
from .metrics import (
    FabricResult,
    FabricStats,
    LatencySketch,
    LatencyStats,
    ReallocationEvent,
    SketchConfig,
    latency_stats,
    steady_throughput,
)
from .telemetry import (
    NULL_TELEMETRY,
    Telemetry,
    get_telemetry,
    set_telemetry,
    telemetry_session,
)
from .tenancy import (
    SharedAllocation,
    Tenant,
    allocate_shared,
    fairness_report,
    run_tenants,
)
from .vtime import (
    CoarsenConfig,
    VTResult,
    VirtualTimeFabric,
    hash_service_indices,
    provision_latency_aware,
    refine_latency_aware,
    sample_service_indices,
)

__all__ = [
    "ClosedLoop",
    "MMPP2",
    "PoissonOpen",
    "SinusoidalPoisson",
    "TraceReplay",
    "arrival_times",
    "DegradePlan",
    "FailureEvent",
    "FailureTrace",
    "RetryPolicy",
    "degrade_plan",
    "degrade_plan_from_allocs",
    "failure_step_schedule",
    "generate_failure_events",
    "generate_failure_trace",
    "lane_chips",
    "FabricSim",
    "DriftConfig",
    "OnlineReallocator",
    "shift_profile",
    "FleetResult",
    "SegmentReport",
    "SegmentedReplayResult",
    "run_stream",
    "run_trace_failures",
    "run_trace_segments",
    "segment_growth_plan",
    "EventCalendar",
    "PoolStats",
    "ServerPool",
    "FabricResult",
    "FabricStats",
    "LatencySketch",
    "LatencyStats",
    "SketchConfig",
    "Telemetry",
    "NULL_TELEMETRY",
    "get_telemetry",
    "set_telemetry",
    "telemetry_session",
    "ReallocationEvent",
    "latency_stats",
    "steady_throughput",
    "SharedAllocation",
    "Tenant",
    "allocate_shared",
    "fairness_report",
    "run_tenants",
    "CoarsenConfig",
    "VTResult",
    "VirtualTimeFabric",
    "hash_service_indices",
    "provision_latency_aware",
    "refine_latency_aware",
    "sample_service_indices",
]

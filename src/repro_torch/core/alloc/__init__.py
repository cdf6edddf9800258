"""Replica allocation algorithms."""

from .greedy import (
    AllocationResult,
    BatchAllocationResult,
    erlang_c,
    greedy_allocate,
    greedy_allocate_batch,
    greedy_allocate_placed,
    greedy_release,
    place_extras,
    proportional_allocate,
    proportional_allocate_batch,
    queueing_allocate,
    queueing_delay,
)
from .pipeline_stages import bottleneck, partition_stages, stage_costs

__all__ = [
    "AllocationResult",
    "BatchAllocationResult",
    "erlang_c",
    "greedy_allocate",
    "greedy_allocate_batch",
    "greedy_allocate_placed",
    "greedy_release",
    "place_extras",
    "proportional_allocate",
    "proportional_allocate_batch",
    "queueing_allocate",
    "queueing_delay",
    "bottleneck",
    "partition_stages",
    "stage_costs",
]

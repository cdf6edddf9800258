"""Replica allocation algorithms."""

from .greedy import (
    AllocationResult,
    BatchAllocationResult,
    erlang_c,
    greedy_allocate,
    greedy_allocate_batch,
    proportional_allocate,
    proportional_allocate_batch,
    queueing_allocate,
    queueing_delay,
)

__all__ = [
    "AllocationResult",
    "BatchAllocationResult",
    "erlang_c",
    "greedy_allocate",
    "greedy_allocate_batch",
    "proportional_allocate",
    "proportional_allocate_batch",
    "queueing_allocate",
    "queueing_delay",
]

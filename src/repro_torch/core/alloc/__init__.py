"""Replica allocation algorithms."""

from .greedy import (
    AllocationResult,
    BatchAllocationResult,
    greedy_allocate,
    greedy_allocate_batch,
    proportional_allocate,
    proportional_allocate_batch,
)

__all__ = [
    "AllocationResult",
    "BatchAllocationResult",
    "greedy_allocate",
    "greedy_allocate_batch",
    "proportional_allocate",
    "proportional_allocate_batch",
]

"""Batched design-space evaluation."""

from .engine import AllocationBatch, allocate_batch, flat_unit_map, run_batch, to_allocation

__all__ = ["AllocationBatch", "allocate_batch", "flat_unit_map", "run_batch", "to_allocation"]

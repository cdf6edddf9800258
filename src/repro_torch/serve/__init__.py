"""Serving: the slot engine (per-slot cache positions) and the batching
counters (reference: ``src/repro/serve``)."""

from .engine import init_slot_state, prefill_slot, reset_slots, slot_decode_step
from .scheduler import (
    BatchingStats,
    WorkloadConfig,
    sample_lengths,
    simulate_continuous,
    simulate_static,
)

__all__ = [
    "init_slot_state", "prefill_slot", "reset_slots", "slot_decode_step",
    "BatchingStats", "WorkloadConfig", "sample_lengths",
    "simulate_continuous", "simulate_static",
]

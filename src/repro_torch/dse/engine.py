"""Batched (allocate, simulate) evaluation — the design-space sweep's inner
loop.

``allocate_batch`` mirrors ``core.cim.simulate.allocate`` policy for policy
but runs every config of a sweep at once: the proportional policies go
through the numpy largest-remainder routine on the host, the greedy
policies through the lock-step ``greedy_allocate_batch`` on the profile's
device, and ``latency_aware`` points through the scalar ``allocate`` one
config at a time (the queueing greedy is load-dependent).  Replica vectors
are element-wise those of the scalar allocator.  ``run_batch`` chains it
into ``BatchSimulator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.alloc.greedy import greedy_allocate_batch, proportional_allocate_batch
from ..core.cim.network import NetworkSpec
from ..core.cim.profile import NetworkProfile
from ..core.cim.simulate import (
    ALL_POLICIES,
    ARRAYS_PER_PE,
    CLOCK_HZ,
    Allocation,
    BatchSimResult,
    BatchSimulator,
    _block_means,
    allocate,
    blockwise_units,
    pack_profile,
)

__all__ = [
    "AllocationBatch",
    "allocate_batch",
    "flat_unit_map",
    "run_batch",
    "to_allocation",
]

_PROPORTIONAL = ("baseline", "weight_based", "weight_blockflow")
_LAYERWISE_FLOW = ("baseline", "weight_based", "perf_layerwise")


def flat_unit_map(
    L: int,
    B: int,
    l_idx: np.ndarray | None = None,
    blk_idx: np.ndarray | None = None,
) -> np.ndarray:
    """One-hot (N, L, B) map from a flat allocation-unit axis to the dense
    replica tensor.  ``l_idx is None`` builds the per-layer family (N = L
    units, each covering every block column of its layer); with
    ``l_idx``/``blk_idx`` (from ``NetworkSpec.block_table``) each unit owns
    exactly its (layer, block) cell.  ``dups = 1 + (r - 1) @ map``."""
    if l_idx is None:
        u = np.zeros((L, L, B))
        u[np.arange(L), np.arange(L), :] = 1.0
        return u
    l_idx = np.asarray(l_idx, dtype=np.int64)
    blk_idx = np.asarray(blk_idx, dtype=np.int64)
    u = np.zeros((l_idx.size, L, B))
    u[np.arange(l_idx.size), l_idx, blk_idx] = 1.0
    return u


@dataclass(frozen=True)
class AllocationBatch:
    """Structure-of-arrays ``Allocation`` for C configs on one network."""

    policies: np.ndarray  # (C,) str
    n_pes: np.ndarray  # (C,)
    dups_lb: torch.Tensor  # (C, L, Bmax) float64 replicas on the device (padded blocks = 1)
    layerwise: np.ndarray  # (C,) bool — barrier dataflow
    zskip: np.ndarray  # (C,) bool
    arrays_used: np.ndarray  # (C,) int64
    arrays_total: np.ndarray  # (C,) int64

    def __len__(self) -> int:
        return self.policies.shape[0]


def allocate_batch(
    spec: NetworkSpec,
    prof: NetworkProfile,
    policies,
    n_pes,
    arrays_per_pe: int = ARRAYS_PER_PE,
    latency_load_frac: float = 0.7,
) -> AllocationBatch:
    """Batched ``allocate``: one call for a whole (policy, PE-count) sweep.
    ``latency_aware`` points are provisioned for ``latency_load_frac`` of
    the blockwise throughput at their budget, as ``allocate``'s default."""
    policies = np.atleast_1d(np.asarray(policies, dtype=object))
    n_pes = np.atleast_1d(np.asarray(n_pes, dtype=np.int64))
    policies, n_pes = np.broadcast_arrays(policies, n_pes)
    unknown = sorted({p for p in policies if p not in ALL_POLICIES})
    if unknown:
        raise ValueError(f"unknown policies {unknown}; choose from {ALL_POLICIES}")
    C = policies.shape[0]
    total = n_pes * arrays_per_pe
    base_arrays = spec.n_arrays
    if np.any(total < base_arrays):
        worst = int(total.min())
        raise ValueError(f"{worst} arrays < minimum {base_arrays} for {spec.name}")
    free = (total - base_arrays).astype(np.float64)

    st = pack_profile(spec, prof)
    dev = st.cycles.device
    L, B = st.L, st.B
    layer_arrays = np.array([l.n_arrays for l in spec.layers], dtype=np.float64)
    dups_lb = torch.ones((C, L, B), dtype=torch.float64, device=dev)
    used = np.zeros(C, dtype=np.int64)

    prop = np.isin(policies, _PROPORTIONAL)
    if prop.any():
        macs = np.array([l.macs_per_image for l in spec.layers], dtype=np.float64)
        reps = proportional_allocate_batch(macs, layer_arrays, free[prop]).replicas.numpy()
        dups_lb[torch.as_tensor(np.flatnonzero(prop), device=dev)] = torch.as_tensor(
            reps[:, :, None], dtype=torch.float64, device=dev
        )
        used[prop] = base_arrays + ((reps - 1) @ layer_arrays).astype(np.int64)

    perf = policies == "perf_layerwise"
    if perf.any():
        exp_lat = (st.pm_mean[1] * st.ppi).cpu().numpy()
        res = greedy_allocate_batch(exp_lat, layer_arrays, free[perf], device=dev)
        dups_lb[torch.as_tensor(np.flatnonzero(perf), device=dev)] = (
            res.replicas[:, :, None].to(torch.float64)
        )
        reps = res.replicas.cpu().numpy()
        used[perf] = base_arrays + ((reps - 1) @ layer_arrays).astype(np.int64)

    block = policies == "blockwise"
    if block.any():
        base_lat, cost = blockwise_units(spec, _block_means(spec, st))
        res = greedy_allocate_batch(base_lat, cost, free[block], device=dev)
        table = torch.as_tensor(spec.block_table(), device=dev)  # layer, block, width
        rows = torch.as_tensor(np.flatnonzero(block), device=dev)
        dups_lb[rows[:, None], table[None, :, 0], table[None, :, 1]] = (
            res.replicas.to(torch.float64)
        )
        reps = res.replicas.cpu().numpy()
        used[block] = base_arrays + ((reps - 1) * cost).sum(axis=1).astype(np.int64)

    for i in np.flatnonzero(policies == "latency_aware"):
        a = allocate(
            spec, prof, "latency_aware", int(n_pes[i]), arrays_per_pe,
            load_frac=latency_load_frac,
        )
        for li, d in enumerate(a.block_dups):
            dups_lb[i, li, : d.size] = torch.as_tensor(d, dtype=torch.float64, device=dev)
        used[i] = a.arrays_used

    return AllocationBatch(
        policies=policies.astype(str),
        n_pes=n_pes.copy(),
        dups_lb=dups_lb,
        layerwise=np.isin(policies, _LAYERWISE_FLOW),
        zskip=policies != "baseline",
        arrays_used=used,
        arrays_total=total,
    )


def to_allocation(batch: AllocationBatch, i: int, spec: NetworkSpec) -> Allocation:
    """Extract config ``i`` as a scalar ``Allocation``."""
    policy = str(batch.policies[i])
    used = int(batch.arrays_used[i])
    total = int(batch.arrays_total[i])
    dups = batch.dups_lb[i].cpu().numpy()
    if policy in _LAYERWISE_FLOW:
        return Allocation(policy, dups[:, 0].astype(np.int64), None, used, total)
    block_dups = [
        dups[li, : l.n_blocks].astype(np.int64) for li, l in enumerate(spec.layers)
    ]
    return Allocation(policy, None, block_dups, used, total)


def run_batch(
    spec: NetworkSpec,
    prof: NetworkProfile,
    policies,
    n_pes,
    *,
    n_images: int = 64,
    clock_hz: float = CLOCK_HZ,
    arrays_per_pe: int = ARRAYS_PER_PE,
    simulator: BatchSimulator | None = None,
    latency_load_frac: float = 0.7,
) -> tuple[AllocationBatch, BatchSimResult]:
    """allocate_batch + BatchSimulator in one call, on the profile's device."""
    alloc = allocate_batch(spec, prof, policies, n_pes, arrays_per_pe, latency_load_frac)
    sim = simulator if simulator is not None else BatchSimulator(spec, prof)
    res = sim(alloc.dups_lb, alloc.layerwise, alloc.zskip, n_images, clock_hz)
    return alloc, res

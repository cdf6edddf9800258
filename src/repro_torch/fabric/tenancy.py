"""Multi-tenant fabrics: several networks sharing one array budget.

CIMPool's observation — fabric capacity is the scarce resource, and weights
from more than one model contend for it — lands here as a weighted-fair
extension of the paper's greedy allocator.  Every block of every tenant is a
unit; a tenant's blocks enter the shared greedy heap with their expected
latency scaled by the tenant's weight, so the allocator equalizes
*weighted* block latencies across tenants (weighted max-min fairness): a
weight-2 tenant's slowest block looks twice as urgent as a weight-1
tenant's equally-slow block and soaks up replicas until it is half as slow.

Tenants own disjoint arrays after allocation (a block is never shared), so
the event simulations are independent; only the allocation couples them.

On a multi-chip fabric (``allocate_shared(topology=...)``) tenants are
additionally *placed*: each tenant's blocks land on the shared chip->PE->
array tree sequentially (first-fit in layer order, extras penalty-greedy),
so a tenant whose mandatory copy spills across a link pays the transfer on
its own dataflow edges — the per-tenant ``Placement``s feed straight into
``run_tenants``' simulations.  Replica COUNTS stay the flat weighted-fair
greedy's (bit-identical with or without a topology); only locations and the
resulting transfer delays are added.

Ported from the reference ``fabric/tenancy.py``, on the host, the placed
path (``topology=``, through ``core.cim.topology.place_allocation``)
included.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.alloc.greedy import greedy_allocate
from ..core.cim.network import NetworkSpec
from ..core.cim.profile import NetworkProfile
from ..core.cim.simulate import (
    ARRAYS_PER_PE,
    Allocation,
    CLOCK_HZ,
    _layer_patch_cycles,
    blockwise_units,
    split_block_dups,
)
from .arrivals import ArrivalProcess
from .dispatch import FabricSim
from .metrics import FabricResult

__all__ = ["Tenant", "SharedAllocation", "allocate_shared", "run_tenants", "fairness_report"]


@dataclass(frozen=True)
class Tenant:
    name: str
    spec: NetworkSpec
    prof: NetworkProfile
    weight: float = 1.0


@dataclass(frozen=True)
class SharedAllocation:
    tenants: tuple[Tenant, ...]
    allocations: tuple[Allocation, ...]  # block-wise, one per tenant
    arrays_total: int
    arrays_used: int
    placements: tuple | None = None  # per-tenant Placement (multi-chip only)

    @property
    def leftover(self) -> int:
        return self.arrays_total - self.arrays_used


def allocate_shared(
    tenants: list[Tenant],
    n_pes: int,
    arrays_per_pe: int = ARRAYS_PER_PE,
    topology=None,
) -> SharedAllocation:
    """Weighted-fair block-wise allocation of one fabric across tenants.

    ``topology`` (a ``core.cim.topology.FabricTopology`` spanning the same
    array budget) additionally places every tenant on the chip tree —
    sequentially in tenant order, so earlier (typically heavier-weight)
    tenants pack closest to the host chip — and attaches the per-tenant
    ``Placement``s the simulations consume."""
    if len(tenants) < 1:
        raise ValueError("need at least one tenant")
    if any(t.weight <= 0 for t in tenants):
        raise ValueError("tenant weights must be positive")
    total = n_pes * arrays_per_pe
    if topology is not None and topology.total_arrays != total:
        raise ValueError(
            f"topology holds {topology.total_arrays} arrays but the fabric "
            f"budget is {total} ({n_pes} PEs x {arrays_per_pe})"
        )
    base = sum(t.spec.n_arrays for t in tenants)
    if total < base:
        raise ValueError(
            f"{total} arrays cannot hold the mandatory copy of every tenant "
            f"({base} arrays: {', '.join(t.spec.name for t in tenants)})"
        )
    lat_parts, cost_parts, sizes = [], [], []
    for t in tenants:
        cyc = _layer_patch_cycles(t.prof, zskip=True)
        lat, cost = blockwise_units(t.spec, [c.mean(axis=0) for c in cyc])
        lat_parts.append(lat * t.weight)
        cost_parts.append(cost)
        sizes.append(lat.size)
    res = greedy_allocate(
        np.concatenate(lat_parts), np.concatenate(cost_parts), total - base
    )
    allocs: list[Allocation] = []
    k = 0
    used_total = base
    for t, size, cost in zip(tenants, sizes, cost_parts):
        rep = res.replicas[k : k + size]
        used = int(t.spec.n_arrays + ((rep - 1) * cost).sum())
        used_total += used - t.spec.n_arrays
        allocs.append(
            Allocation("blockwise", None, split_block_dups(t.spec, rep), used, total)
        )
        k += size
    placements = None
    if topology is not None:
        from ..core.cim.topology import place_allocation

        free = np.full(topology.n_chips, float(topology.arrays_per_chip))
        pls = []
        for t, alloc in zip(tenants, allocs):
            pl = place_allocation(t.spec, alloc, topology, chip_free=free)
            free = free - pl.chip_arrays
            pls.append(pl)
        placements = tuple(pls)
    return SharedAllocation(
        tuple(tenants), tuple(allocs), total, int(used_total), placements
    )


def run_tenants(
    shared: SharedAllocation,
    procs: list[ArrivalProcess],
    *,
    seed: int = 0,
    clock_hz: float = CLOCK_HZ,
) -> list[FabricResult]:
    """Run every tenant's arrival process on its slice of the fabric.
    Slices are disjoint, so tenants simulate independently and exactly."""
    if len(procs) != len(shared.tenants):
        raise ValueError("one arrival process per tenant")
    pls = shared.placements or (None,) * len(shared.tenants)
    out = []
    for i, (t, alloc, proc, pl) in enumerate(
        zip(shared.tenants, shared.allocations, procs, pls)
    ):
        sim = FabricSim(
            t.spec, t.prof, alloc, seed=seed + i, clock_hz=clock_hz, placement=pl
        )
        res = sim.run(proc)
        res.tenant = t.name
        out.append(res)
    return out


def fairness_report(shared: SharedAllocation, results: list[FabricResult]) -> dict:
    """Per-tenant accounting + how close the allocator got to weighted
    fairness (ratio of weighted per-image service rates)."""
    per = {}
    shares = []
    pls = shared.placements or (None,) * len(shared.tenants)
    for t, alloc, r, pl in zip(shared.tenants, shared.allocations, results, pls):
        ips = r.images_per_sec
        shares.append(ips / t.weight)
        lat = r.latency_ms()
        per[t.name] = {
            "weight": t.weight,
            "arrays": alloc.arrays_used,
            "images_per_sec": ips,
            "latency_ms_p50": lat.p50,
            "latency_ms_p95": lat.p95,
            "latency_ms_p99": lat.p99,
            "mean_utilization": r.mean_utilization,
        }
        if pl is not None:
            per[t.name]["max_stage_transfer_cycles"] = pl.max_stage_transfer
            per[t.name]["chips"] = np.flatnonzero(pl.chip_arrays > 0).tolist()
    shares = np.asarray(shares)
    return {
        "tenants": per,
        "arrays_total": shared.arrays_total,
        "arrays_used": shared.arrays_used,
        # 1.0 = perfectly weighted-proportional throughput; the min/max ratio
        # of weight-normalized rates (networks differ in per-image work, so
        # this is a fabric-level, not SLA-level, fairness signal)
        "weighted_rate_balance": float(shares.min() / shares.max()) if shares.size else 1.0,
    }

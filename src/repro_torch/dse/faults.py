"""Fault-tolerance design sweep: spare fraction x failure rate.

The robustness counterpart of ``dse.sweep``: every point provisions a
design with part of its free arrays held back as hot spares
(``allocate(free_budget=free - reserve)`` — the spares never serve healthy
traffic), replays one seeded failure trace against it on the segmented
vtime engine (``fabric.failures.degrade_plan`` → ``fleet.run_trace_
segments``), and reports the three objectives the ``FAULT_OBJECTIVES``
frontier ranks: availability (capacity that stayed serviceable), p99 under
failure, and total arrays built.  More spares cost throughput up front and
buy availability when arrays die — the sweep makes the exchange rate a
measured curve instead of a guess.

Traces share one normalized arrival-gap sequence across points (common
random numbers, as in ``dse.sweep._fabric_eval``), and failure traces share
the sweep seed, so differences across points are spare/rate effects.
Ported from the reference ``dse/faults.py``; the replay runs on the port's
``fleet.run_trace_segments`` (the streaming VT launch on the card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core.cim.cost import ArrayConfig, DEFAULT_ARRAY
from ..core.cim.simulate import ARRAYS_PER_PE, CLOCK_HZ, allocate, simulate
from ..fabric.drift import DriftConfig
from ..fabric.failures import degrade_plan, generate_failure_trace
from ..fabric.fleet import run_trace_segments
from ..fabric.telemetry import get_telemetry
from .sweep import _spec_for, get_profiled

__all__ = ["FaultPoint", "FaultSweepResult", "fault_grid", "run_fault_sweep"]


@dataclass(frozen=True)
class FaultPoint:
    """One fault-tolerance design point: how many arrays to hold back as
    spares (``spare_fraction`` of the free budget) against a per-array
    hazard of ``rate_per_array`` failures per cycle."""

    network: str
    spare_fraction: float
    rate_per_array: float
    n_pes: int
    policy: str = "blockwise"
    repair_cycles: float | None = None
    array: ArrayConfig = DEFAULT_ARRAY


@dataclass
class FaultSweepResult:
    """Columnar fault-sweep outcome; row i <-> ``points[i]``.

    ``objectives``-compatible with ``pareto_frontier`` — pass
    ``FAULT_OBJECTIVES`` for the (availability, p99, arrays) frontier.
    """

    points: list[FaultPoint]
    availability: np.ndarray  # (C,) in [0, 1]
    p50_cycles: np.ndarray
    p99_cycles: np.ndarray
    arrays_used: np.ndarray
    arrays_total: np.ndarray
    spare_arrays: np.ndarray  # (C,) reserve held back per point
    n_killed: np.ndarray
    n_repaired: np.ndarray
    total_stall_cycles: np.ndarray
    elapsed_s: float

    def __len__(self) -> int:
        return len(self.points)

    def objectives(self, names: tuple[str, ...]) -> np.ndarray:
        cols = {
            "spare_fraction": np.asarray(
                [p.spare_fraction for p in self.points], dtype=np.float64
            ),
            "rate_per_array": np.asarray(
                [p.rate_per_array for p in self.points], dtype=np.float64
            ),
        }
        out = []
        for n in names:
            v = cols.get(n)
            if v is None:
                v = np.asarray(getattr(self, n), dtype=np.float64)
            out.append(v)
        return np.stack(out, axis=1)

    def rows(self) -> list[dict]:
        out = []
        for i, p in enumerate(self.points):
            out.append(
                {
                    "network": p.network,
                    "policy": p.policy,
                    "n_pes": p.n_pes,
                    "spare_fraction": float(p.spare_fraction),
                    "rate_per_array": float(p.rate_per_array),
                    "repair_cycles": p.repair_cycles,
                    "availability": float(self.availability[i]),
                    "p50_ms": float(self.p50_cycles[i] / CLOCK_HZ * 1e3),
                    "p99_ms": float(self.p99_cycles[i] / CLOCK_HZ * 1e3),
                    "arrays_used": int(self.arrays_used[i]),
                    "arrays_total": int(self.arrays_total[i]),
                    "spare_arrays": int(self.spare_arrays[i]),
                    "n_killed": int(self.n_killed[i]),
                    "n_repaired": int(self.n_repaired[i]),
                    "total_stall_cycles": float(self.total_stall_cycles[i]),
                }
            )
        return out


def fault_grid(
    networks=("vgg11",),
    spare_fractions=(0.0, 0.1, 0.25),
    rates=(1e-9, 1e-8),
    policy: str = "blockwise",
    pe_multiplier: float = 2.0,
    repair_cycles: float | None = None,
    arrays_per_pe: int = ARRAYS_PER_PE,
    arrays=(DEFAULT_ARRAY,),
) -> list[FaultPoint]:
    """spare-fraction x failure-rate grid at a fixed silicon budget per
    network (``pe_multiplier`` times the minimum design)."""
    points = []
    for net in networks:
        for arr in arrays:
            spec = _spec_for(net, arr)
            n_pes = max(
                spec.min_pes(arrays_per_pe),
                int(np.ceil(spec.min_pes(arrays_per_pe) * pe_multiplier)),
            )
            for sf in spare_fractions:
                for rate in rates:
                    points.append(
                        FaultPoint(
                            net, float(sf), float(rate), n_pes, policy,
                            repair_cycles, arr,
                        )
                    )
    return points


def run_fault_sweep(
    points: list[FaultPoint],
    *,
    n_requests: int = 200,
    load_frac: float = 0.6,
    seed: int = 0,
    drift: DriftConfig = DriftConfig(),
    weibull_shape: float = 1.0,
    chip_burst_rate: float = 0.0,
    burst_kill_frac: float = 0.5,
    topology=None,
    min_survivors: int = 1,
    profile_images: int = 1,
    sample_patches: int = 128,
    arrays_per_pe: int = ARRAYS_PER_PE,
    device: str | torch.device = "cuda",
) -> FaultSweepResult:
    """Replay one seeded failure trace against every design point.

    Per point: hold back ``floor(free * spare_fraction)`` arrays from the
    allocator (they idle as hot spares), offer Poisson traffic at
    ``load_frac`` of the degraded design's analytic throughput over a
    horizon set by the trace itself, generate the point's failure trace over
    that horizon, compile it to a ``DegradePlan`` (spares re-place lost
    replicas, reprogramming charges ``drift`` stalls), and replay on the
    streaming segmented vtime engine.  Availability comes from the plan
    (deterministic — it needs no simulation), the percentiles from the
    replayed sketches.  Each segment is one streaming VT launch on
    ``device`` (its plain version on the CPU).
    """
    from ..fabric.vtime import VirtualTimeFabric

    C = len(points)
    avail = np.zeros(C)
    pcts = np.zeros((C, 2))
    used = np.zeros(C, dtype=np.int64)
    total = np.zeros(C, dtype=np.int64)
    spares = np.zeros(C, dtype=np.int64)
    killed = np.zeros(C, dtype=np.int64)
    repaired = np.zeros(C, dtype=np.int64)
    stalls = np.zeros(C)

    dev = resolve_device(device)
    prof_kw = dict(
        profile_images=profile_images, sample_patches=sample_patches, seed=seed, device=dev
    )
    gaps = np.random.default_rng(seed).exponential(1.0, size=n_requests)
    tel = get_telemetry()
    tel.gauge("dse.faults.points", C)
    elapsed = 0.0
    vts: dict[tuple, VirtualTimeFabric] = {}
    for i, p in enumerate(points):
        spec, prof = get_profiled(p.network, p.array, **prof_kw)
        free = p.n_pes * arrays_per_pe - spec.n_arrays
        if free < 0:
            raise ValueError(
                f"point {i}: {p.n_pes} PEs cannot hold {p.network}"
            )
        reserve = int(free * p.spare_fraction)
        alloc = allocate(
            spec, prof, p.policy, p.n_pes, arrays_per_pe,
            free_budget=free - reserve,
        )
        cap = simulate(spec, prof, alloc).images_per_sec
        rate = load_frac * cap / CLOCK_HZ
        times = np.cumsum(gaps) / rate
        horizon = float(times[-1])
        t0 = time.perf_counter()
        trace = generate_failure_trace(
            spec, alloc,
            horizon=horizon, seed=seed,
            rate_per_array=p.rate_per_array,
            weibull_shape=weibull_shape,
            repair_cycles=p.repair_cycles,
            topology=topology,
            chip_burst_rate=chip_burst_rate,
            burst_kill_frac=burst_kill_frac,
            min_survivors=min_survivors,
        )
        plan = degrade_plan(
            spec, prof, alloc, trace,
            spare_arrays=reserve, drift=drift, min_survivors=min_survivors,
        )
        key = (p.network, p.array)
        if key not in vts:
            vts[key] = VirtualTimeFabric(spec, prof, device=dev)
        res = run_trace_segments(
            vts[key], list(plan.allocs), times, plan.boundaries,
            drift=drift, seed=seed, stream=True,
            percentiles=(50.0, 99.0),
        )
        elapsed += time.perf_counter() - t0
        avail[i] = plan.availability()
        pcts[i] = res.percentiles[0]
        used[i] = alloc.arrays_used
        total[i] = alloc.arrays_total
        spares[i] = reserve
        killed[i] = plan.n_killed
        repaired[i] = plan.n_repaired
        stalls[i] = plan.total_stall_cycles
        tel.gauge("dse.faults.points_done", i + 1)

    return FaultSweepResult(
        points=list(points),
        availability=avail,
        p50_cycles=pcts[:, 0],
        p99_cycles=pcts[:, 1],
        arrays_used=used,
        arrays_total=total,
        spare_arrays=spares,
        n_killed=killed,
        n_repaired=repaired,
        total_stall_cycles=stalls,
        elapsed_s=elapsed,
    )

"""Seeded fabric failure injection + SLO-defending graceful degradation.

Copied from the reference ``fabric/failures.py`` (numpy only).  The
segmented replay (``fleet.run_trace_failures``) and ``core.cim.topology``
named below are the port's own modules.

The paper's fixed eNVM crossbars make failures expensive: a dead array takes
its replica's weights with it, and re-placing the lost capacity costs real
reprogramming stalls.  This module makes the failure axis first-class for
both fabric engines:

  * ``FailureTrace`` / ``generate_failure_trace`` — a seeded failure model:
    every replica lane carries an independent Weibull renewal hazard
    (``weibull_shape=1`` is the exponential special case, scale =
    ``1 / (rate_per_array * lane_width)``), chips fail together via a
    per-chip Poisson burst process whose blast radius is the lanes homed on
    that chip (``FabricTopology.arrays_per_chip`` defines the failure
    domain), and an optional deterministic ``repair_cycles`` MTTR brings a
    dead lane back.  Events are totally ordered and reproducible from
    ``seed`` alone.
  * ``degrade_plan`` — compiles a trace into the SHARED artifact both
    engines consume: a segment trajectory of block-wise allocations cut at
    every failure/repair time.  A failure removes the lane with the largest
    next-free time (the multiset rule both engines implement identically: in
    the packed kernel the sorted positions ``[dups_new, dups_old)`` — the
    largest finite free-times — are set to ``+inf``, the existing
    absent-server convention; in the event engine ``ServerPool.kill`` pops
    the largest ``avail``).  Survivor re-placement draws like-for-like
    capacity from a hot-spare pool via warm-started
    ``greedy_allocate(initial_replicas=...)``; repairs and replacements are
    net growth and charge ``DriftConfig.stall`` reprogramming freezes
    exactly as segmented replay boundaries do.  ``FabricSim(failures=plan)``
    and ``fleet.run_trace_segments(plan.allocs, ..., plan.boundaries)`` are
    bit-identical under the same plan (the correctness spine, pinned in
    tests/test_failures.py on VGG11 and ResNet18).
  * ``RetryPolicy`` — event-engine-only serving policy on top of the shared
    semantics: requests reaching a zero-survivor block stall until its next
    repair/re-place and are shed (NaN completion) when the wait exceeds
    ``timeout_cycles`` or the request has already stalled ``max_retries``
    times.  The bit-identity contract deliberately excludes this path (the
    packed kernel reports ``+inf`` for dead blocks); pinned traces keep at
    least one survivor per block.

Jobs dispatched before a failure DRAIN: both engines fix a job's completion
at dispatch time (work-conserving FIFO, no preemption), so a lane that dies
busy still finishes its queue — ``ServerPool.kill`` reports how many lanes
died busy and the dispatcher counts them as retried-on-survivor work.

``failure_step_schedule`` exports the same seeded schedule to the training
runner (``runtime.fault.FaultInjector.from_trace``), so training-side and
fabric-side fault tests draw from one generator.
"""

from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field

import numpy as np

from ..core.alloc.greedy import greedy_allocate
from ..core.cim.network import NetworkSpec
from ..core.cim.profile import NetworkProfile
from ..core.cim.simulate import (
    Allocation,
    _layer_patch_cycles,
    blockwise_units,
    split_block_dups,
)
from .drift import DriftConfig
from .telemetry import get_telemetry

__all__ = [
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
]


@dataclass(frozen=True)
class FailureEvent:
    """One lane transition: flat block ``unit`` loses (``repair=False``) or
    regains (``repair=True``) replica lane ``lane`` at ``time`` cycles.
    ``chip`` is the failure domain the lane is homed on (burst attribution;
    0 for a single-chip fabric)."""

    time: float
    unit: int
    lane: int
    repair: bool = False
    chip: int = 0


@dataclass(frozen=True)
class FailureTrace:
    """A totally-ordered, seed-reproducible sequence of failure/repair
    events over ``[0, horizon)`` cycles, against the flat block units of one
    block-wise allocation (``n_units`` blocks)."""

    events: tuple[FailureEvent, ...]
    horizon: float
    seed: int = 0
    n_units: int = 0

    def __post_init__(self):
        times = [e.time for e in self.events]
        if any(b < a for a, b in zip(times, times[1:])):
            raise ValueError("failure events must be sorted by time")

    @property
    def n_failures(self) -> int:
        return sum(not e.repair for e in self.events)

    @property
    def n_repairs(self) -> int:
        return sum(e.repair for e in self.events)

    @property
    def seam_times(self) -> np.ndarray:
        """Sorted unique event times — the segment boundaries a degrade
        plan cuts the request stream at."""
        return np.unique(np.asarray([e.time for e in self.events]))

    def mttr(self) -> float:
        """Mean time-to-repair over repaired lanes (cycles); ``inf`` when
        failures were never repaired, ``nan`` with no failures at all."""
        pend: dict[tuple[int, int], float] = {}
        gaps = []
        for ev in self.events:
            key = (ev.unit, ev.lane)
            if ev.repair:
                t0 = pend.pop(key, None)
                if t0 is not None:
                    gaps.append(ev.time - t0)
            else:
                pend[key] = ev.time
        if gaps:
            return float(np.mean(gaps))
        return math.inf if pend else math.nan


def lane_chips(dups, widths, arrays_per_chip: int | None = None) -> list[np.ndarray]:
    """Home chip of every replica lane, packed in (unit, lane) order.

    Lanes occupy consecutive array ranges (``widths[j]`` arrays each) and a
    lane's chip is where its first array lands — the same linear packing
    ``FabricTopology`` tiles arrays with, so ``arrays_per_chip`` from a
    topology carves the lanes into its chip failure domains.  ``None``
    (single chip) homes everything on chip 0."""
    dups = np.asarray(dups, dtype=np.int64)
    widths = np.asarray(widths, dtype=np.int64)
    if dups.shape != widths.shape:
        raise ValueError(f"dups {dups.shape} vs widths {widths.shape}")
    if arrays_per_chip is None:
        arrays_per_chip = max(int((dups * widths).sum()), 1)
    if arrays_per_chip < 1:
        raise ValueError(f"arrays_per_chip must be positive, got {arrays_per_chip}")
    out = []
    off = 0
    for j in range(dups.size):
        w = int(widths[j])
        chips = np.empty(int(dups[j]), dtype=np.int64)
        for i in range(int(dups[j])):
            chips[i] = off // arrays_per_chip
            off += w
        out.append(chips)
    return out


_FAIL, _REPAIR, _BURST = 0, 1, 2


def generate_failure_events(
    dups,
    widths,
    *,
    horizon: float,
    seed: int = 0,
    rate_per_array: float = 0.0,
    weibull_shape: float = 1.0,
    repair_cycles: float | None = None,
    arrays_per_chip: int | None = None,
    chip_burst_rate: float = 0.0,
    burst_kill_frac: float = 0.5,
    min_survivors: int = 1,
) -> tuple[FailureEvent, ...]:
    """Seeded failure/repair schedule against flat block units.

    Per-lane hazards are Weibull renewals with scale ``1 / (rate_per_array *
    widths[j])`` — shape 1 is exponential, shape > 1 wear-out, shape < 1
    infant mortality.  The renewal clock runs in wall time: a hazard firing
    while its lane is already dead (burst casualty) is absorbed.  Chip
    bursts arrive Poisson per chip at ``chip_burst_rate`` and kill
    ``ceil(burst_kill_frac * alive-on-chip)`` lanes homed on that chip, in
    deterministic (unit, lane) order.  With ``repair_cycles`` every kill
    schedules its lane's repair a fixed MTTR later (dropped past the
    horizon: the lane stays dead).  ``min_survivors`` is a floor per unit:
    failures that would breach it are absorbed, so a degraded block always
    keeps that many replicas — 1 keeps both engines finite, 0 permits
    zero-survivor episodes (event-engine ``RetryPolicy`` territory).

    Deterministic in all arguments: the RNG is consumed only in a fixed
    pre-generation order, and the chronological walk breaks time ties by
    generation order."""
    dups = np.asarray(dups, dtype=np.int64)
    widths = np.asarray(widths, dtype=np.int64)
    if dups.shape != widths.shape or dups.ndim != 1:
        raise ValueError(f"dups {dups.shape} vs widths {widths.shape}")
    if np.any(dups < 1) or np.any(widths < 1):
        raise ValueError("every unit needs >= 1 replica of >= 1 array")
    if not horizon > 0:
        raise ValueError(f"horizon must be positive, got {horizon}")
    if rate_per_array < 0 or chip_burst_rate < 0:
        raise ValueError("failure rates must be nonnegative")
    if not weibull_shape > 0:
        raise ValueError(f"weibull_shape must be positive, got {weibull_shape}")
    if not 0.0 < burst_kill_frac <= 1.0:
        raise ValueError(f"burst_kill_frac must be in (0, 1], got {burst_kill_frac}")
    if repair_cycles is not None and not repair_cycles > 0:
        raise ValueError(f"repair_cycles must be positive, got {repair_cycles}")
    if min_survivors < 0:
        raise ValueError(f"min_survivors must be >= 0, got {min_survivors}")

    rng = np.random.default_rng(seed)
    chips = lane_chips(dups, widths, arrays_per_chip)
    n = int(dups.size)
    seq = itertools.count()
    heap: list[tuple[float, int, int, int, int, int]] = []

    # fixed draw order (unit-major, lane-minor, then chips) = determinism
    if rate_per_array > 0:
        for j in range(n):
            scale = 1.0 / (rate_per_array * float(widths[j]))
            for i in range(int(dups[j])):
                t = 0.0
                while True:
                    t += scale * float(rng.weibull(weibull_shape))
                    if t >= horizon:
                        break
                    heapq.heappush(heap, (t, next(seq), _FAIL, j, i, int(chips[j][i])))
    if chip_burst_rate > 0:
        n_chips = int(max(int(c.max()) for c in chips if c.size) + 1) if n else 1
        for c in range(n_chips):
            t = 0.0
            while True:
                t += float(rng.exponential(1.0 / chip_burst_rate))
                if t >= horizon:
                    break
                heapq.heappush(heap, (t, next(seq), _BURST, c, -1, c))

    alive = [set(range(int(d))) for d in dups]
    events: list[FailureEvent] = []

    def kill(t: float, j: int, i: int, chip: int) -> None:
        alive[j].discard(i)
        events.append(FailureEvent(t, j, i, False, chip))
        if repair_cycles is not None and t + repair_cycles < horizon:
            heapq.heappush(
                heap, (t + repair_cycles, next(seq), _REPAIR, j, i, chip)
            )

    while heap:
        t, _, kind, j, i, chip = heapq.heappop(heap)
        if kind == _REPAIR:
            alive[j].add(i)
            events.append(FailureEvent(t, j, i, True, chip))
        elif kind == _FAIL:
            if i in alive[j] and len(alive[j]) > min_survivors:
                kill(t, j, i, chip)
        else:  # chip burst: j is the chip id
            targets = [
                (jj, ii)
                for jj in range(n)
                for ii in sorted(alive[jj])
                if chips[jj][ii] == j
            ]
            quota = int(math.ceil(burst_kill_frac * len(targets)))
            killed = 0
            for jj, ii in targets:
                if killed >= quota:
                    break
                if len(alive[jj]) > min_survivors:
                    kill(t, jj, ii, j)
                    killed += 1
    return tuple(events)


def generate_failure_trace(
    spec: NetworkSpec,
    alloc: Allocation,
    *,
    horizon: float,
    seed: int = 0,
    rate_per_array: float = 0.0,
    weibull_shape: float = 1.0,
    repair_cycles: float | None = None,
    topology=None,
    chip_burst_rate: float = 0.0,
    burst_kill_frac: float = 0.5,
    min_survivors: int = 1,
) -> FailureTrace:
    """``generate_failure_events`` against a (spec, block-wise allocation)
    pair; ``topology`` (a ``core.cim.topology.FabricTopology``) supplies
    ``arrays_per_chip`` so chip bursts respect the real failure domains."""
    if alloc.block_dups is None:
        raise ValueError("failure injection requires a block-wise allocation")
    dups = np.concatenate(
        [np.asarray(d, dtype=np.int64) for d in alloc.block_dups]
    )
    widths = np.concatenate(
        [
            np.full(l.n_blocks, l.arrays_per_block, dtype=np.int64)
            for l in spec.layers
        ]
    )
    events = generate_failure_events(
        dups,
        widths,
        horizon=horizon,
        seed=seed,
        rate_per_array=rate_per_array,
        weibull_shape=weibull_shape,
        repair_cycles=repair_cycles,
        arrays_per_chip=None if topology is None else topology.arrays_per_chip,
        chip_burst_rate=chip_burst_rate,
        burst_kill_frac=burst_kill_frac,
        min_survivors=min_survivors,
    )
    tel = get_telemetry()
    tel.count("fabric.failures.generated", sum(not e.repair for e in events))
    tel.count("fabric.failures.repairs_generated", sum(e.repair for e in events))
    return FailureTrace(events, float(horizon), int(seed), int(dups.size))


@dataclass(frozen=True)
class RetryPolicy:
    """Event-engine serving policy for zero-survivor blocks (outside the
    bit-identity contract): a request hitting a dead block waits for its
    next repair/re-place; it is shed (NaN completion) when that wait
    exceeds ``timeout_cycles``, when the block will never revive, or after
    the request has already stalled ``max_retries`` times."""

    timeout_cycles: float = math.inf
    max_retries: int = 8

    def __post_init__(self):
        if not self.timeout_cycles >= 0:
            raise ValueError(f"timeout_cycles must be >= 0, got {self.timeout_cycles}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")


@dataclass(frozen=True)
class DegradePlan:
    """Segmented degradation trajectory — the ONE artifact both fabric
    engines consume (``FabricSim(failures=plan)`` /
    ``fleet.run_trace_segments(plan.allocs, ..., plan.boundaries)``), which
    is what makes their results bit-identical under a failure trace.

    ``allocs[s]`` holds during ``[boundaries[s-1], boundaries[s])``;
    ``arrays_added[s]`` / ``stall_cycles[s]`` are the reprogrammed arrays
    (positive dup diffs only — survivors keep their weights) and the
    resulting fabric-wide freeze charged entering segment ``s``;
    ``arrays_online[s]`` is the live replica capacity, the availability
    integrand."""

    allocs: tuple[Allocation, ...]
    boundaries: np.ndarray  # (S-1,) cycles, nondecreasing
    arrays_added: np.ndarray  # (S,) int; [0] == 0
    stall_cycles: np.ndarray  # (S,)
    arrays_online: np.ndarray  # (S,) arrays holding live replicas
    drift: DriftConfig
    trace: FailureTrace
    spare_arrays: float = 0.0
    spare_left: float = 0.0
    n_killed: int = 0
    n_repaired: int = 0
    replaced_arrays: float = 0.0
    dropped_failures: int = field(default=0)  # kills absorbed by the floor

    @property
    def n_segments(self) -> int:
        return len(self.allocs)

    def flat_dups(self, s: int) -> np.ndarray:
        """Flat per-block replica counts of segment ``s``."""
        return np.concatenate(
            [np.asarray(d, dtype=np.int64) for d in self.allocs[s].block_dups]
        )

    @property
    def total_stall_cycles(self) -> float:
        return float(np.sum(self.stall_cycles))

    def availability(self, horizon: float | None = None) -> float:
        """Capacity availability over ``[0, horizon]``: live-array-cycles
        actually serviceable (reprogramming freezes subtracted) over the
        healthy fabric's array-cycles.  1.0 = no capacity lost; deterministic
        from the plan alone, so spare-fraction sweeps never need the event
        engine."""
        h = float(self.trace.horizon if horizon is None else horizon)
        if not h > 0:
            raise ValueError(f"horizon must be positive, got {h}")
        base = float(self.arrays_online[0])
        if base <= 0:
            return 0.0
        starts = np.concatenate([[0.0], self.boundaries])
        ends = np.concatenate([self.boundaries, [h]])
        length = np.maximum(np.minimum(ends, h) - np.minimum(starts, h), 0.0)
        eff = np.maximum(length - self.stall_cycles, 0.0)
        return float(min(1.0, float(self.arrays_online @ eff) / (base * h)))


def _plan_capacity(cur: np.ndarray, cost: np.ndarray) -> int:
    return int(round(float(cur @ cost)))


def degrade_plan(
    spec: NetworkSpec,
    prof: NetworkProfile,
    alloc: Allocation,
    trace: FailureTrace,
    *,
    spare_arrays: float = 0.0,
    drift: DriftConfig = DriftConfig(),
    zskip: bool | None = None,
    min_survivors: int = 1,
) -> DegradePlan:
    """Compile a failure trace into the shared segment trajectory.

    Every distinct event time becomes a seam.  Kills decrement the unit's
    replica count (clamped at ``min_survivors`` — the generator enforces the
    floor on original lanes, but spare re-placement can shift which unit is
    thinnest, so the clamp re-checks); repairs increment it.  When capacity
    was lost and hot spares remain, ``greedy_allocate(initial_replicas=
    survivors)`` re-places up to the arrays just killed — like-for-like
    budget, so spares restore the highest-latency blocks first, which is the
    paper's allocation rule applied to the degraded fabric.  Repairs and
    re-placements are net growth at the seam and charge
    ``drift.stall(arrays_added)`` exactly as ``run_trace_segments`` computes
    it from the dup diffs — the two books must agree for the engines to
    stay bit-identical.  Corollary: a seam whose kills are fully re-placed
    onto the SAME units leaves the replica counts unchanged and is dropped
    (no cut, no stall) — like-for-like hot-spare swap is modeled as
    seamless, a deliberate simplification both engines share."""
    if alloc.block_dups is None:
        raise ValueError("degrade_plan requires a block-wise allocation")
    if spare_arrays < 0:
        raise ValueError(f"spare_arrays must be >= 0, got {spare_arrays}")
    if min_survivors < 0:
        raise ValueError(f"min_survivors must be >= 0, got {min_survivors}")
    if zskip is None:
        zskip = alloc.policy != "baseline"
    cyc = _layer_patch_cycles(prof, zskip)
    base_lat, cost = blockwise_units(spec, [c.mean(axis=0) for c in cyc])
    cur = np.concatenate(
        [np.asarray(d, dtype=np.int64) for d in alloc.block_dups]
    )
    if trace.n_units and trace.n_units != cur.size:
        raise ValueError(
            f"trace covers {trace.n_units} units, allocation has {cur.size}"
        )
    total = int(alloc.arrays_total)

    allocs = [alloc]
    bounds: list[float] = []
    added = [0]
    stalls = [0.0]
    online = [_plan_capacity(cur, cost)]
    spare_left = float(spare_arrays)
    n_killed = n_repaired = dropped = 0
    replaced = 0.0

    for t, group in itertools.groupby(trace.events, key=lambda e: e.time):
        prev = cur.copy()
        lost = 0.0
        for ev in group:
            j = int(ev.unit)
            if not 0 <= j < cur.size:
                raise ValueError(f"event unit {j} outside [0, {cur.size})")
            if ev.repair:
                cur[j] += 1
                n_repaired += 1
            elif cur[j] > min_survivors:
                cur[j] -= 1
                n_killed += 1
                lost += float(cost[j])
            else:
                dropped += 1
        if lost > 0.0 and spare_left > 0.0:
            res = greedy_allocate(
                base_lat, cost, min(spare_left, lost), initial_replicas=cur
            )
            spare_left -= res.spent
            replaced += res.spent
            cur = res.replicas
        if np.array_equal(cur, prev):
            continue  # fully-absorbed seam: no allocation change, no cut
        diff = cur - prev
        add = int(round(float(np.maximum(diff, 0) @ cost)))
        used = _plan_capacity(cur, cost)
        bounds.append(float(t))
        added.append(add)
        stalls.append(drift.stall(add) if add > 0 else 0.0)
        online.append(used)
        allocs.append(
            Allocation(
                alloc.policy,
                None,
                split_block_dups(spec, cur.copy()),
                used,
                max(total, used),
            )
        )

    plan = DegradePlan(
        allocs=tuple(allocs),
        boundaries=np.asarray(bounds, dtype=np.float64),
        arrays_added=np.asarray(added, dtype=np.int64),
        stall_cycles=np.asarray(stalls, dtype=np.float64),
        arrays_online=np.asarray(online, dtype=np.int64),
        drift=drift,
        trace=trace,
        spare_arrays=float(spare_arrays),
        spare_left=spare_left,
        n_killed=n_killed,
        n_repaired=n_repaired,
        replaced_arrays=replaced,
        dropped_failures=dropped,
    )
    tel = get_telemetry()
    tel.gauge("fabric.failures.availability", plan.availability())
    mttr = trace.mttr()
    if math.isfinite(mttr):
        tel.observe("fabric.failures.mttr_cycles", mttr)
    return plan


def degrade_plan_from_allocs(
    spec: NetworkSpec,
    allocs,
    boundaries,
    *,
    drift: DriftConfig = DriftConfig(),
    horizon: float | None = None,
) -> DegradePlan:
    """Wrap a hand-built allocation trajectory (e.g. an explicit shrink) in
    a ``DegradePlan`` so the event engine can replay it via
    ``FabricSim(failures=...)`` — the seam bookkeeping (positive-diff
    reprogram arrays, stalls, online capacity) is derived exactly as
    ``degrade_plan`` and ``run_trace_segments`` derive it."""
    allocs = list(allocs)
    if not allocs:
        raise ValueError("need at least one allocation")
    bounds = np.asarray(boundaries, dtype=np.float64)
    if bounds.size != len(allocs) - 1:
        raise ValueError(
            f"{len(allocs)} allocations need {len(allocs) - 1} boundaries, "
            f"got {bounds.size}"
        )
    if np.any(np.diff(bounds) < 0):
        raise ValueError("boundaries must be nondecreasing")
    widths = np.concatenate(
        [
            np.full(l.n_blocks, l.arrays_per_block, dtype=np.int64)
            for l in spec.layers
        ]
    )
    flats = []
    for a in allocs:
        if a.block_dups is None:
            raise ValueError("degrade plans require block-wise allocations")
        flats.append(
            np.concatenate([np.asarray(d, dtype=np.int64) for d in a.block_dups])
        )
    added = [0]
    stalls = [0.0]
    online = [_plan_capacity(flats[0], widths.astype(np.float64))]
    for s in range(1, len(flats)):
        diff = flats[s] - flats[s - 1]
        add = int(np.maximum(diff, 0) @ widths)
        added.append(add)
        stalls.append(drift.stall(add) if add > 0 else 0.0)
        online.append(_plan_capacity(flats[s], widths.astype(np.float64)))
    h = float(horizon) if horizon is not None else float(bounds[-1]) if bounds.size else 0.0
    return DegradePlan(
        allocs=tuple(allocs),
        boundaries=bounds,
        arrays_added=np.asarray(added, dtype=np.int64),
        stall_cycles=np.asarray(stalls, dtype=np.float64),
        arrays_online=np.asarray(online, dtype=np.int64),
        drift=drift,
        trace=FailureTrace((), max(h, 1.0), 0, int(widths.size)),
    )


def failure_step_schedule(trace: FailureTrace, cycles_per_step: float) -> dict[int, int]:
    """Map a fabric failure trace onto training steps: step
    ``floor(time / cycles_per_step)`` absorbs each fail event.  The shared
    schedule type ``runtime.fault.FaultInjector.from_trace`` consumes, so
    training-side and fabric-side fault tests draw from one seeded
    generator."""
    if not cycles_per_step > 0:
        raise ValueError(f"cycles_per_step must be positive, got {cycles_per_step}")
    out: dict[int, int] = {}
    for ev in trace.events:
        if not ev.repair:
            s = int(ev.time // cycles_per_step)
            out[s] = out.get(s, 0) + 1
    return out

"""Fleet-scale trace replay: streaming sketches + segmented re-allocation.

Ported from the reference ``fabric/fleet.py``.  The fabric collapses to a
scan over requests (``vtime``); this module makes that scan a what-if
oracle over millions of requests, without a (configs, requests) latency
matrix:

  * ``run_stream``: the virtual-time recurrence with O(lanes + sketch)
    carry.  Service indices come from the counter hash
    (``hash_service_indices``); per-request latencies fold into a
    ``fabric.metrics`` log-bucket sketch plus exact min / max and Welford
    moments.  Bucket counts, min / max and makespan are bit-identical to
    ``FabricSim(service_sampling="hash")`` and to the reference's replay.
  * ``run_trace_segments``: splits a long open-loop trace at control
    boundaries, carries free-lane state across them and applies each
    segment's allocation, charging the event engine's reprogramming stall
    at each boundary (``FabricSim.apply_growth``); shrunk lanes go to
    ``+inf``.  With no allocation change and no stall it is bit-identical
    to one unsegmented stream.
  * ``segment_growth_plan``: the allocation trajectory from per-boundary
    array budgets (negative: ``greedy_release``), warm-started through
    ``greedy_allocate(initial_replicas=...)``.
  * ``run_trace_failures``: a seeded ``FailureTrace`` compiled to a
    ``DegradePlan`` and replayed here, bit-identical to
    ``FabricSim(failures=plan)``.

Each ``run_stream`` call, and each segment of ``run_trace_segments``, is
one launch of the streaming VT entry (``kernels.vtime_scan.vtime_stream``)
on the fabric's device, every config of the call in it; on a CPU fabric
(``VirtualTimeFabric(device="cpu")``) the entry runs its plain version.
The boundaries are applied between launches on the device's tensors
(``_apply_boundary``).  ``window`` blocks the reference's request scan and
changes no bit; the launch takes every request in order and ignores it.

``CoarsenConfig`` (from ``vtime``) optionally trades a small pessimistic
tail bias for macro-jobs; its plans come from ``chunk_plan`` at the
reference's padded lane width of each group.  Every default is exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.cim.network import NetworkSpec
from ..core.cim.profile import NetworkProfile
from ..core.cim.simulate import (
    Allocation,
    CLOCK_HZ,
    _layer_patch_cycles,
    blockwise_units,
    split_block_dups,
)
from .arrivals import ArrivalProcess, ClosedLoop, arrival_times
from .drift import DriftConfig
from .metrics import LatencySketch, LatencyStats, SketchConfig
from .vtime import CoarsenConfig, VirtualTimeFabric, _hash_salt, chunk_plan, service_indices
from ..kernels.vtime_scan import StreamState, stream_dense, stream_flat, stream_state, vtime_stream

__all__ = [
    "FleetResult",
    "SegmentReport",
    "SegmentedReplayResult",
    "run_stream",
    "run_trace_failures",
    "run_trace_segments",
    "segment_growth_plan",
]


# ------------------------------------------------------------ launch inputs
def _group_plans(vt: VirtualTimeFabric, groups, n_cfg: int, coarsen) -> np.ndarray:
    """(C, L, 2) macro-job plans: each config's group's ``chunk_plan`` at
    the group's padded lane width per layer (the reference's
    ``g.frees[li].shape[-1]``)."""
    ppi = [int(l.patches_per_image) for l in vt.spec.layers]
    plans = np.zeros((n_cfg, len(ppi), 2), dtype=np.int64)
    plans[..., 0] = 1
    if coarsen is None:
        return plans
    for g in groups:
        for li in range(len(ppi)):
            plans[g.rows, li] = chunk_plan(ppi[li], g.frees[li].shape[-1], coarsen)
    return plans


def _stream_inputs(vt: VirtualTimeFabric, allocs, seed: int):
    """Packed tables, per-config variant and lanes (``vt.vt_inputs``), and
    the hash salts and patches of one streaming launch over ``allocs``."""
    inp = vt.vt_inputs(allocs)
    salts = [_hash_salt(seed, li) for li in range(len(inp.dims))]
    return inp.tables, inp.variant, inp.lanes, salts, [p for _, p in inp.dims]


def _xfer_tensor(vt: VirtualTimeFabric, placements):
    if placements is None:
        return None
    x = np.stack([np.asarray(p.stage_transfer, dtype=np.float64) for p in placements])
    return torch.as_tensor(x, device=vt.device)


def _sketches(cfg: SketchConfig, carry: StreamState) -> tuple:
    counts = carry.counts.cpu().numpy()
    mom = carry.moments.cpu().numpy()
    return tuple(
        LatencySketch.from_state(cfg, (counts[k], *mom[k])) for k in range(counts.shape[0])
    )


# ----------------------------------------------------------------- results
@dataclass(frozen=True)
class FleetResult:
    """Streaming replay outcome: per-config sketches instead of (C, N)
    latency matrices — memory O(C x buckets) at any trace length."""

    sketches: tuple  # (C,) LatencySketch
    percentile_qs: tuple
    makespan: np.ndarray  # (C,) cycles (max completion)
    n_requests: int
    clock_hz: float = CLOCK_HZ
    window: int = 1
    arrivals: np.ndarray | None = None  # (C, N) materialize=True only
    completions: np.ndarray | None = None  # (C, N) materialize=True only

    def __len__(self) -> int:
        return len(self.sketches)

    @property
    def percentiles(self) -> np.ndarray:  # (C, Q) sketch-estimated, cycles
        return np.stack(
            [s.percentiles(self.percentile_qs) for s in self.sketches]
        )

    def percentile(self, q: float) -> np.ndarray:  # (C,)
        return self.percentiles[:, self.percentile_qs.index(q)]

    @property
    def p99(self) -> np.ndarray:
        return self.percentile(99.0)

    def latency(self, i: int) -> LatencyStats:
        return self.sketches[i].stats

    @property
    def exact_percentiles(self) -> np.ndarray:  # (C, Q), materialize=True only
        """Exact ``np.percentile`` over materialized latencies — the
        reference the sketch percentiles are pinned against."""
        if self.completions is None:
            raise ValueError("exact percentiles need run_stream(materialize=True)")
        lat = self.completions - self.arrivals
        return np.percentile(lat, self.percentile_qs, axis=1).T

    @property
    def requests_per_sec(self) -> np.ndarray:  # (C,) simulated service rate
        span = np.maximum(self.makespan, 1e-300)
        return np.where(
            self.makespan > 0, self.n_requests / span * self.clock_hz, 0.0
        )


@dataclass(frozen=True)
class SegmentReport:
    """One control interval: the re-allocation charged on entry + volume."""

    start: float  # cycles (0.0 for the first segment)
    n_requests: int
    arrays_added: np.ndarray  # (C,) eNVM arrays reprogrammed at entry
    stall_cycles: np.ndarray  # (C,) fabric freeze charged at entry


@dataclass(frozen=True)
class SegmentedReplayResult:
    """Whole-trace outcome of ``run_trace_segments``.

    ``sketches`` accumulate IN-KERNEL across segments (the sketch state is
    scan carry, handed from segment to segment), so they equal the
    unsegmented streaming sketches bit-for-bit when no allocation changes.
    Materializing mode (``stream=False``) also fills ``arrivals`` /
    ``completions`` for exact-percentile validation at test scale."""

    sketches: tuple  # (C,) LatencySketch over the whole trace
    percentile_qs: tuple
    segments: tuple  # (S,) SegmentReport
    makespan: np.ndarray  # (C,)
    n_requests: int
    clock_hz: float = CLOCK_HZ
    arrivals: np.ndarray | None = None  # (C, N) stream=False only
    completions: np.ndarray | None = None  # (C, N) stream=False only

    @property
    def percentiles(self) -> np.ndarray:  # (C, Q)
        return np.stack(
            [s.percentiles(self.percentile_qs) for s in self.sketches]
        )

    def percentile(self, q: float) -> np.ndarray:
        return self.percentiles[:, self.percentile_qs.index(q)]

    @property
    def p99(self) -> np.ndarray:
        return self.percentile(99.0)

    def latency(self, i: int) -> LatencyStats:
        return self.sketches[i].stats

    @property
    def total_stall_cycles(self) -> np.ndarray:  # (C,)
        return np.sum([s.stall_cycles for s in self.segments], axis=0)


# -------------------------------------------------------------- run_stream
def run_stream(
    vt: VirtualTimeFabric,
    allocs,
    proc: ArrivalProcess | list,
    *,
    seed: int = 0,
    window: int = 8,
    percentiles: tuple = (50.0, 95.0, 99.0),
    sketch: SketchConfig = SketchConfig(),
    coarsen: CoarsenConfig | None = None,
    placements: list | None = None,
    materialize: bool = False,
) -> FleetResult:
    """Streaming batched replay: ``VirtualTimeFabric.run_batch`` semantics
    with O(lanes + sketch) memory per config and hash-derived service times.

    Service indices come from ``hash_service_indices(seed, layer, request,
    patch)`` rather than the presampled tensors, so results are a different
    (equally valid) draw than ``run_batch(seed=...)`` — the cross-engine pin
    is ``FabricSim(service_sampling="hash")``, which consumes the identical
    hash.  ``window`` blocks the request scan (bit-identical per the vtime
    proof); ``coarsen`` opts into macro-job chunking (documented pessimistic
    bias); percentiles come from the sketch within ``sketch.rel_error``.

    ``materialize`` additionally keeps the full (C, N) arrival/completion
    matrices — the exact-percentile baseline path (O(C x N) memory, what
    the sketch exists to avoid at fleet scale; same hashed service draws).
    The whole call is one streaming VT launch on the fabric's device.
    """
    allocs = list(allocs)
    if not allocs:
        raise ValueError("need at least one allocation")
    if placements is not None and len(placements) != len(allocs):
        raise ValueError(f"{len(placements)} placements for {len(allocs)} allocations")
    procs = proc if isinstance(proc, list) else [proc] * len(allocs)
    if len(procs) != len(allocs):
        raise ValueError(f"{len(procs)} arrival processes for {len(allocs)} allocations")
    closed = isinstance(procs[0], ClosedLoop)
    if any(isinstance(p, ClosedLoop) != closed for p in procs):
        raise ValueError("cannot mix closed- and open-loop processes in one batch")
    if closed:
        concurrency = procs[0].concurrency
        if any(
            p.concurrency != concurrency or p.n_requests != procs[0].n_requests
            for p in procs
        ):
            raise ValueError("closed-loop batch needs identical (n_requests, concurrency)")
        n = procs[0].n_requests
        times = np.zeros((len(allocs), n))
    else:
        concurrency = None
        tlist = [arrival_times(p) for p in procs]
        n = tlist[0].size
        if any(t.size != n for t in tlist):
            raise ValueError("all arrival traces in a batch need the same length")
        times = np.stack(tlist).astype(np.float64) if n else np.zeros((len(allocs), 0))

    c_total = len(allocs)
    sketches: list = [LatencySketch.from_latencies([], sketch)] * c_total
    makespan = np.zeros(c_total)
    arr = comp = None
    if materialize:
        arr, comp = np.zeros((c_total, n)), np.zeros((c_total, n))
    if n:
        tables, variant, lanes, salts, patches = _stream_inputs(vt, allocs, seed)
        groups = vt._groups(allocs, placements) if coarsen is not None else ()
        dev = vt.device
        carry = stream_state(lanes, lanes, n_bins=sketch.n_bins,
                             ring_len=concurrency or 1, device=dev)
        carry, ys = vtime_stream(
            tables, variant, lanes, carry,
            n_requests=n, patches=patches, salts=salts,
            plans=_group_plans(vt, groups, c_total, coarsen),
            arrivals=None if closed else torch.as_tensor(times, device=dev),
            concurrency=concurrency, xfer=_xfer_tensor(vt, placements),
            emit=materialize, sketch=(sketch.bins_per_octave, sketch.min_exp),
        )
        sketches = list(_sketches(sketch, carry))
        makespan = carry.horizon.cpu().numpy()
        if materialize:
            arr, comp = (y.cpu().numpy() for y in ys)
    return FleetResult(
        tuple(sketches), tuple(percentiles), makespan, int(n), vt.clock_hz,
        int(window), arrivals=arr, completions=comp,
    )


# ------------------------------------------------------- segmented replay
def segment_growth_plan(
    spec: NetworkSpec,
    prof: NetworkProfile,
    alloc: Allocation,
    budgets,
    *,
    zskip: bool | None = None,
) -> list[Allocation]:
    """Allocation trajectory for ``run_trace_segments``: at each control
    boundary grant ``budgets[s]`` additional arrays to the blocks with the
    highest expected drain time, warm-started from the previous segment's
    replicas via ``greedy_allocate(initial_replicas=...)`` — the controller
    hook named in the ROADMAP.  A NEGATIVE budget shrinks instead (degraded
    capacity after a failure): ``greedy_release`` frees at least ``-b``
    arrays from the blocks whose latency suffers least, the exact inverse
    of the grant rule.  Returns ``len(budgets) + 1`` allocations (the input
    first)."""
    from ..core.alloc.greedy import greedy_allocate, greedy_release

    if alloc.block_dups is None:
        raise ValueError("segment_growth_plan requires a block-wise allocation")
    if zskip is None:
        zskip = alloc.policy != "baseline"
    cyc = _layer_patch_cycles(prof, zskip)
    base_lat, cost = blockwise_units(spec, [c.mean(axis=0) for c in cyc])
    cur = np.concatenate(
        [np.asarray(d, dtype=np.int64) for d in alloc.block_dups]
    )
    used, total = int(alloc.arrays_used), int(alloc.arrays_total)
    out = [alloc]
    for b in budgets:
        if float(b) < 0:
            res = greedy_release(base_lat, cost, -float(b), replicas=cur)
        else:
            res = greedy_allocate(base_lat, cost, float(b), initial_replicas=cur)
        cur = res.replicas
        used += int(round(res.spent))
        out.append(
            Allocation(
                alloc.policy, None, split_block_dups(spec, cur), used,
                max(total, used),
            )
        )
    return out


def _segment_pack(vt: VirtualTimeFabric, segs):
    """Every segment's lane width per layer (the most replicas over the
    segments, rounded up to ``lane_quantum``: the reference's one compiled
    shape for all segments) and per-segment per-layer (C, B) dup arrays."""
    n_layers = len(vt.spec.layers)
    dups = [
        [
            np.stack([np.asarray(a.block_dups[li], dtype=np.int64) for a in seg])
            for li in range(n_layers)
        ]
        for seg in segs
    ]  # (S)(L)(C, B)
    q = max(1, int(vt.lane_quantum))
    lane_widths = [-(-max(int(d[li].max()) for d in dups) // q) * q for li in range(n_layers)]
    return lane_widths, dups


def _apply_boundary(frees, dups_old, dups_new, arrays_added, t_free):
    """Event-engine seam semantics on packed lanes, per layer (C, B, D)
    float64 tensors on the fabric's device: for
    configs that reprogram (``arrays_added > 0``, positive dup diffs only)
    every existing lane freezes until ``t_free`` (= boundary + stall) and
    the grown lanes come online at ``t_free``, exactly
    ``FabricSim.apply_growth``.  Blocks that SHRINK (failures: survivors <
    previous replicas) lose their latest-free lanes (sorted positions
    ``[dups_new, dups_old)`` go to ``+inf``, the absent-server convention;
    ``ServerPool.kill`` removes the same multiset on the event side).
    Unchanged configs pass through untouched."""
    out = []
    for li, lanes in enumerate(frees):
        dev = lanes.device
        hit = torch.as_tensor(np.asarray(arrays_added) > 0, device=dev)
        tf = torch.as_tensor(np.asarray(t_free, dtype=np.float64), device=dev)[:, None, None]
        old = torch.as_tensor(np.asarray(dups_old[li], dtype=np.int64), device=dev)[:, :, None]
        new = torch.as_tensor(np.asarray(dups_new[li], dtype=np.int64), device=dev)[:, :, None]
        clamp = hit[:, None, None] & torch.isfinite(lanes)
        lanes = torch.where(clamp, torch.maximum(lanes, tf), lanes)
        d = torch.arange(lanes.shape[-1], device=dev)
        lanes = torch.where((d >= old) & (d < new), tf, lanes)
        lanes = torch.where((d >= new) & (d < old), float("inf"), lanes)
        lanes = torch.sort(lanes, dim=-1).values
        out.append(lanes)
    return tuple(out)


def run_trace_segments(
    vt: VirtualTimeFabric,
    allocs_by_segment,
    proc: ArrivalProcess | np.ndarray,
    boundaries,
    *,
    drift: DriftConfig = DriftConfig(),
    seed: int = 0,
    window: int = 8,
    percentiles: tuple = (50.0, 95.0, 99.0),
    sketch: SketchConfig = SketchConfig(),
    coarsen: CoarsenConfig | None = None,
    stream: bool = True,
) -> SegmentedReplayResult:
    """Segmented warm-start replay of one long open-loop trace.

    The trace is split at ``boundaries`` (cycles, nondecreasing); segment
    ``s`` runs under ``allocs_by_segment[s]`` (one ``Allocation`` or a
    C-list per segment), with free-lane state carried across boundaries and
    each config's reprogramming stall — ``drift.stall(arrays_added)``, from
    net-NEW replicas only — charged to every lane at entry.  Allocations may
    grow or shrink at a seam: shrinking a block kills its latest-free lanes
    (``+inf``, the absent-server convention), which is how seeded failure
    traces replay here (``fabric.failures.degrade_plan`` /
    ``run_trace_failures``); a shrink-to-identical plan stays bit-identical
    to the unsegmented replay.

    ``stream=True`` (default) keeps sketch + lane state in-carry; with
    identical allocations and zero stalls it is bit-identical to the
    unsegmented ``run_stream``.  ``stream=False`` materializes per-request
    completions (presampled service draws, exactly ``run_batch``'s) for
    validation at test scale — identical allocations reproduce
    ``run_batch`` completions bit-for-bit.

    Each segment is one streaming VT launch on the fabric's device
    (presampled indices when ``stream=False``), the lane state staying
    there between launches.  The reference pads segments to ``pad_to``
    requests so that they share compiled kernels; padded requests change
    nothing and nothing is compiled per length here, so there is no
    padding.
    """
    if isinstance(proc, ClosedLoop):
        raise ValueError("segmented replay is open-loop only (trace/Poisson arrivals)")
    times = (
        np.asarray(proc, dtype=np.float64)
        if isinstance(proc, np.ndarray)
        else arrival_times(proc)
    )
    bounds = np.asarray(boundaries, dtype=np.float64)
    if bounds.ndim != 1:
        raise ValueError("boundaries must be a 1-D sequence of cycle times")
    if bounds.size and np.any(np.diff(bounds) < 0):
        raise ValueError("boundaries must be nondecreasing")
    segs = [
        list(seg) if isinstance(seg, (list, tuple)) else [seg]
        for seg in allocs_by_segment
    ]
    n_seg = len(segs)
    if n_seg != bounds.size + 1:
        raise ValueError(
            f"{n_seg} segment allocations need {n_seg - 1} boundaries, got {bounds.size}"
        )
    c_total = len(segs[0])
    if any(len(seg) != c_total for seg in segs):
        raise ValueError("every segment needs the same number of allocations")
    zskip = segs[0][0].policy != "baseline"
    for seg in segs:
        for a in seg:
            if a.block_dups is None:
                raise ValueError("segmented replay requires block-wise allocations")
            if (a.policy != "baseline") != zskip:
                raise ValueError("all segment allocations must share zero-skipping")

    lane_widths, dups = _segment_pack(vt, segs)
    n_layers = len(vt.spec.layers)
    widths = np.asarray(
        [vt.spec.layers[li].arrays_per_block for li in range(n_layers)],
        dtype=np.int64,
    )
    added = np.zeros((n_seg, c_total), dtype=np.int64)
    for s in range(1, n_seg):
        for li in range(n_layers):
            diff = dups[s][li] - dups[s - 1][li]  # (C, B)
            # positive diffs only: shrunk lanes (failures) lose their
            # replica without reprogramming anything, so only net-new
            # replicas charge the drift stall
            added[s] += np.maximum(diff, 0).sum(axis=1) * widths[li]
    stalls = np.zeros((n_seg, c_total))
    for s in range(1, n_seg):
        stalls[s] = [
            drift.stall(int(a)) if a > 0 else 0.0 for a in added[s]
        ]

    n = times.size
    cuts = np.searchsorted(times, bounds, side="left")
    starts = np.concatenate([[0], cuts]).astype(np.int64)
    ends = np.concatenate([cuts, [n]]).astype(np.int64)
    reports = tuple(
        SegmentReport(
            0.0 if s == 0 else float(bounds[s - 1]),
            int(ends[s] - starts[s]),
            added[s].astype(np.float64),
            stalls[s].copy(),
        )
        for s in range(n_seg)
    )

    return _segments(
        vt, segs, lane_widths, dups, added, stalls, bounds, times, starts, ends,
        reports, seed, sketch, coarsen, stream, percentiles,
    )


def _materialized_result(vt, times, completions, sketch, percentiles, reports):
    c_total, n = completions.shape
    arrivals = np.broadcast_to(times, (c_total, n)).copy()
    sketches = tuple(
        LatencySketch.from_latencies(completions[k] - times, sketch)
        for k in range(c_total)
    )
    makespan = completions.max(axis=1) if n else np.zeros(c_total)
    return SegmentedReplayResult(
        sketches, tuple(percentiles), reports, makespan, int(n), vt.clock_hz,
        arrivals=arrivals, completions=completions,
    )


def _segments(
    vt, segs, lane_widths, dups, added, stalls, bounds, times, starts, ends, reports,
    seed, sketch, coarsen, stream, percentiles,
):
    """``run_trace_segments``' launches: one streaming VT launch per
    segment, the carry (lanes, sketch, horizon) left on the device between
    launches and each boundary applied there.  A pool's lane slots are its
    most replicas over the segments."""
    c_total, n_layers = len(segs[0]), len(vt.spec.layers)
    dev = vt.device
    tables, variant, _, salts, patches = _stream_inputs(vt, segs[0], seed)
    blocks = [l.n_blocks for l in vt.spec.layers]
    per_seg = [np.concatenate([d[li] for li in range(n_layers)], axis=1) for d in dups]
    slots = np.max(np.stack(per_seg), axis=0)  # (C, pools)
    plans = np.zeros((c_total, n_layers, 2), dtype=np.int64)
    plans[..., 0] = 1
    if coarsen is not None and stream:
        for li in range(n_layers):
            plans[:, li] = chunk_plan(patches[li], lane_widths[li], coarsen)
    carry = stream_state(slots, per_seg[0], n_bins=sketch.n_bins, device=dev)
    idx = None if stream else service_indices(seed, vt.dims, times.size, dev)
    comps = []
    times_t = torch.as_tensor(times, device=dev)
    for s in range(len(segs)):
        if s:
            dense = stream_dense(carry.state, slots, blocks)
            dense = _apply_boundary(dense, dups[s - 1], dups[s], added[s], bounds[s - 1] + stalls[s])
            carry = carry._replace(state=stream_flat(dense, slots, blocks))
        lo, hi = int(starts[s]), int(ends[s])
        if hi == lo:
            continue
        carry, ys = vtime_stream(
            tables, variant, slots, carry, n_requests=hi - lo, patches=patches,
            salts=None if idx is not None else salts, idx=idx,
            plans=plans, r0=lo, arrivals=times_t[lo:hi].expand(c_total, hi - lo),
            emit=not stream, sketch=(sketch.bins_per_octave, sketch.min_exp),
        )
        if ys is not None:
            comps.append(ys[1])
    if not stream:
        completions = (torch.cat(comps, dim=1).cpu().numpy() if comps
                       else np.zeros((c_total, 0)))
        return _materialized_result(vt, times, completions, sketch, percentiles, reports)
    return SegmentedReplayResult(
        _sketches(sketch, carry), tuple(percentiles), reports,
        carry.horizon.cpu().numpy(), int(times.size), vt.clock_hz,
    )


def run_trace_failures(
    vt: VirtualTimeFabric,
    prof: NetworkProfile,
    alloc: Allocation,
    proc: ArrivalProcess | np.ndarray,
    failures,
    *,
    spare_arrays: float = 0.0,
    drift: DriftConfig = DriftConfig(),
    min_survivors: int = 1,
    **kwargs,
) -> SegmentedReplayResult:
    """Replay one trace under a seeded failure trace on the vtime engine.

    ``failures`` is a ``fabric.failures.FailureTrace`` (compiled to a
    ``DegradePlan`` here) or an already-built ``DegradePlan``.  Thin sugar
    over ``degrade_plan`` + ``run_trace_segments``: every failure/repair
    time becomes a segment seam, survivors are re-placed from the
    ``spare_arrays`` hot pool via warm-started greedy, and reprogramming
    stalls are charged in-kernel.  ``FabricSim(failures=plan)`` replays the
    same plan bit-identically (the cross-engine contract)."""
    from .failures import FailureTrace, degrade_plan

    if isinstance(failures, FailureTrace):
        plan = degrade_plan(
            vt.spec, prof, alloc, failures,
            spare_arrays=spare_arrays, drift=drift, min_survivors=min_survivors,
        )
    else:
        plan = failures
    return run_trace_segments(
        vt, list(plan.allocs), proc, plan.boundaries, drift=plan.drift, **kwargs
    )

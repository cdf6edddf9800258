"""FabricSim: execute a (NetworkSpec, NetworkProfile, Allocation) triple on
the discrete-event core.

Copied from the reference ``fabric/dispatch.py``: the engine runs on the
host in numpy, reading the profile's cycle tensors once into float64 numpy
(``core.cim.simulate._layer_patch_cycles``).  ``placement=`` takes a
``core.cim.topology.Placement`` or any object with a ``stage_transfer``
vector; ``service_sampling="hash"`` draws the indices ``fleet``'s streaming
replay hashes.

Mapping onto pools follows the dataflow of the allocation:

  * layer-wise (``layer_dups``): one pool per layer; a server is a full
    duplicate of the layer's block grid; a job is a patch whose service time
    is the gather/accumulate barrier ``max_b cycles[p, b]``.
  * block-wise (``block_dups``): one pool per block; a server is one block
    replica; a patch becomes one independent job per block.

A request (image) traverses layers in sequence: all of its patch jobs for
layer ``l`` are enqueued when it enters the stage, and it enters ``l+1``
when the last of them completes.  Layers occupy disjoint arrays, so
consecutive requests pipeline across stages exactly as in the paper; the
steady-state throughput of a saturated closed loop converges to the analytic
``simulate()`` bottleneck (tests assert agreement within 10%).

Per-patch service times are drawn (with replacement) from the profiled
per-(patch, block) cycle sample — or, for drift studies, from a second
"live" profile that the dispatcher samples while the monitor still expects
the original one.  Draws are presampled request-major at the start of a run
(``vtime.sample_service_indices``), so the virtual-time engines consume
identical randomness and reproduce this engine bit for bit.

Multi-chip fabrics add one term: a ``Placement`` (``core.cim.topology``)
carries a per-stage entry transfer delay — the cycles a request's
activations spend crossing inter-chip links to reach the stage's farthest
replica — and the dispatcher simply dispatches stage ``s`` at ``t +
stage_transfer[s]``.  The virtual-time kernel adds the identical IEEE
operation at the identical point, so the engines stay bit-identical with
transfer delays enabled; a single-chip placement has all-zero transfers and
reproduces the flat engine exactly.

Failure injection (``failures=``, a ``fabric.failures.DegradePlan``) replays
a seeded failure trace on this engine: each failure/repair seam cuts the
request stream by ARRIVAL index (``searchsorted(times, boundary)`` — the
identical cut segmented replay makes) and is applied to a stage's pools
lazily, right before the first post-seam request dispatches there (valid
because pools are non-overtaking FIFO per stage).  A shrink kills the
latest-free lanes (``ServerPool.kill`` — the multiset the packed kernel
sends to ``+inf``); growth/repair freezes the stage until ``boundary +
DriftConfig.stall`` and brings lanes online then, exactly ``apply_growth``.
Jobs already dispatched to a killed lane drain (completion fixed at
dispatch, both engines).  Under the same plan this engine and
``fleet.run_trace_segments`` are bit-identical (pinned in tests).  On top —
outside the bit-identity contract — a ``RetryPolicy`` governs zero-survivor
blocks: requests stall until the block's next repair/re-place and are shed
(NaN completion) past ``timeout_cycles`` or ``max_retries`` stalls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..core.cim.network import NetworkSpec
from ..core.cim.profile import NetworkProfile
from ..core.cim.simulate import Allocation, CLOCK_HZ, _layer_patch_cycles
from .arrivals import ArrivalProcess, ClosedLoop, arrival_times
from .events import EventCalendar, ServerPool
from .failures import DegradePlan, RetryPolicy
from .metrics import FabricResult, FabricStats
from .telemetry import get_telemetry
from .vtime import _hash_salt, hash_service_indices, sample_service_indices

__all__ = ["FabricSim"]


@dataclass
class _Stage:
    blockwise: bool
    pools: list[ServerPool]
    services: np.ndarray  # (S,) barrier times or (S, B) per-block samples
    ppi: int
    # layer-wise only: true busy array-cycles per patch (sum over blocks x
    # block width).  The pool's own accounting charges the barrier max to
    # every array, which would hide exactly the intra-layer waste the
    # analytic model's utilization (paper Fig 9) measures.
    busy_sample: np.ndarray | None = None
    busy: float = 0.0


class FabricSim:
    def __init__(
        self,
        spec: NetworkSpec,
        prof: NetworkProfile,
        alloc: Allocation,
        *,
        seed: int = 0,
        live_prof: NetworkProfile | None = None,
        reallocator=None,
        clock_hz: float = CLOCK_HZ,
        record_timeline: bool = False,
        placement=None,
        stats: bool = False,
        service_sampling: str = "presample",
        failures: DegradePlan | None = None,
        retry: RetryPolicy | None = None,
    ):
        if service_sampling not in ("presample", "hash"):
            raise ValueError(
                f"service_sampling must be 'presample' or 'hash', got {service_sampling!r}"
            )
        self.spec = spec
        self.alloc = alloc
        self.clock_hz = clock_hz
        self.reallocator = reallocator
        self.collect_stats = bool(stats)
        # "presample" draws (N, ppi) index tensors through
        # sample_service_indices (the seed-for-seed contract with
        # VirtualTimeFabric.run_batch); "hash" derives the same indices the
        # streaming fleet kernel hashes in-kernel (fleet.run_stream), so the
        # event engine stays the bit-identity reference at fleet seeds too
        self.service_sampling = service_sampling
        self._seed = int(seed)
        # per-stage request entry transfer (core.cim.topology.Placement);
        # None = flat single-chip fabric, zero added work on the hot path
        self._xfer = (
            None
            if placement is None
            else np.asarray(placement.stage_transfer, dtype=np.float64)
        )
        if self._xfer is not None and self._xfer.shape != (len(spec.layers),):
            raise ValueError(
                f"placement covers {self._xfer.shape[0]} stages, "
                f"spec has {len(spec.layers)} layers"
            )
        self.rng = np.random.default_rng(seed)
        zskip = alloc.policy != "baseline"
        cyc = _layer_patch_cycles(live_prof or prof, zskip)
        self.stages: list[_Stage] = []
        for i, layer in enumerate(spec.layers):
            if alloc.layer_dups is not None:
                pools = [
                    ServerPool(
                        int(alloc.layer_dups[i]),
                        width=layer.n_arrays,
                        record_starts=record_timeline,
                        stats=stats,
                    )
                ]
                services = cyc[i].max(axis=1)  # per-patch barrier
                busy_sample = cyc[i].sum(axis=1) * layer.arrays_per_block
                self.stages.append(
                    _Stage(False, pools, services, layer.patches_per_image, busy_sample)
                )
            else:
                dups = alloc.block_dups[i]
                pools = [
                    ServerPool(
                        int(dups[b]),
                        width=layer.arrays_per_block,
                        record_starts=record_timeline,
                        stats=stats,
                    )
                    for b in range(layer.n_blocks)
                ]
                self.stages.append(_Stage(True, pools, cyc[i], layer.patches_per_image))
        if reallocator is not None:
            if alloc.block_dups is None:
                raise ValueError("online re-allocation requires a block-wise allocation")
            reallocator.bind(self)
        self.failures = failures
        self.retry = retry if retry is not None else RetryPolicy()
        self._fail_bounds: np.ndarray | None = None
        if failures is not None:
            if alloc.block_dups is None:
                raise ValueError("failure injection requires a block-wise allocation")
            if reallocator is not None:
                raise ValueError(
                    "failure injection and online re-allocation both rewrite "
                    "pool shapes — use one or the other"
                )
            first = np.concatenate(
                [np.asarray(d) for d in failures.allocs[0].block_dups]
            )
            cur = np.concatenate([np.asarray(d) for d in alloc.block_dups])
            if not np.array_equal(first, cur):
                raise ValueError(
                    "the degrade plan's first segment must match the running "
                    "allocation"
                )
            self._fail_bounds = np.asarray(failures.boundaries, dtype=np.float64)
            self._fail_tfree = self._fail_bounds + np.asarray(
                failures.stall_cycles[1:], dtype=np.float64
            )
            self._fail_added = np.asarray(failures.arrays_added[1:], dtype=np.int64)
            self._seg_dups = [a.block_dups for a in failures.allocs]
            self._phantom: set[tuple[int, int]] = set()
            self._n_retried_busy = 0
            self._n_shed = 0

    # ------------------------------------------------------------- internals
    def _next_revival(self, stage_idx: int, b: int, seam: int) -> float:
        """When a zero-survivor block next regains a replica: the ``t_free``
        of the first seam after ``seam`` whose plan gives it lanes again
        (repair or spare re-place), ``inf`` if it never revives."""
        for s in range(seam + 1, len(self._fail_bounds)):
            if int(self._seg_dups[s + 1][stage_idx][b]) > 0:
                return float(self._fail_tfree[s])
        return math.inf

    def _apply_seam(self, stage_idx: int, seam: int) -> None:
        """Apply failure seam ``seam`` to one stage's pools: freeze-if-grown
        first, then per-block net kill/grow — the same order (and therefore
        the same free-time multisets) as ``fleet._apply_boundary``'s
        clamp-then-shrink on the packed lanes."""
        st = self.stages[stage_idx]
        boundary = float(self._fail_bounds[seam])
        t_free = float(self._fail_tfree[seam])
        if self._fail_added[seam] > 0:
            # reprogramming freezes word lines fabric-wide; each stage
            # applies its share lazily, before its first post-seam dispatch
            for p in st.pools:
                p.freeze_until(t_free)
        if not st.blockwise:
            return
        old = self._seg_dups[seam][stage_idx]
        new = self._seg_dups[seam + 1][stage_idx]
        for b, pool in enumerate(st.pools):
            diff = int(new[b]) - int(old[b])
            if (stage_idx, b) in self._phantom:
                if int(new[b]) > 0:
                    # the phantom placeholder becomes the first revived lane
                    if diff - 1 > 0:
                        pool.grow(diff - 1, t_free)
                    self._phantom.discard((stage_idx, b))
                continue
            if diff > 0:
                pool.grow(diff, t_free)
            elif diff < 0:
                self._n_retried_busy += pool.kill(-diff, boundary)
                if int(new[b]) == 0:
                    # park a placeholder lane at the block's next revival so
                    # FIFO queueing across the dead window falls out naturally
                    pool.grow(1, self._next_revival(stage_idx, b, seam))
                    self._phantom.add((stage_idx, b))

    def _dispatch_stage(self, stage_idx: int, t: float, req: int) -> float:
        if self._fail_bounds is not None:
            nxt = self._seam_next[stage_idx]
            while nxt < self._fail_cuts.size and req >= self._fail_cuts[nxt]:
                self._apply_seam(stage_idx, nxt)
                nxt += 1
            self._seam_next[stage_idx] = nxt
            if self._phantom:
                for b in range(len(self.stages[stage_idx].pools)):
                    if (stage_idx, b) not in self._phantom:
                        continue
                    pool = self.stages[stage_idx].pools[b]
                    start = min(pool.avail)
                    wait = (start if start > t else t) - t
                    if (
                        wait > self.retry.timeout_cycles
                        or self._stall_count[req] >= self.retry.max_retries
                    ):
                        self._n_shed += 1
                        return math.nan
                    self._stall_count[req] += 1
                    break  # one stall charge per stage entry
        if self._xfer is not None:
            # the request's activations cross the NoC/links before any of the
            # stage's jobs can start — same op, same place as vtime's kernel
            t = t + self._xfer[stage_idx]
        st = self.stages[stage_idx]
        idx = self._svc_idx[stage_idx][req]
        svc = st.services[idx]
        if not st.blockwise:
            st.busy += float(st.busy_sample[idx].sum())
            return st.pools[0].dispatch(t, svc)
        done = t
        for b, pool in enumerate(st.pools):
            c = pool.dispatch(t, svc[:, b])
            if c > done:
                done = c
        if self.reallocator is not None:
            self.reallocator.observe(stage_idx, svc.mean(axis=0), t)
        return done

    def current_block_dups(self) -> np.ndarray:
        """Flattened replica counts per block (block-wise stages only)."""
        return np.asarray(
            [p.n_servers for st in self.stages for p in st.pools if st.blockwise],
            dtype=np.int64,
        )

    def apply_growth(self, added: np.ndarray, t_free: float) -> None:
        """Bring ``added[j]`` extra replicas of flat block ``j`` online at
        ``t_free``; every pool stalls until then (array reprogramming freezes
        word lines fabric-wide).  Jobs already enqueued drain on the old
        configuration — re-programming overlaps with the drain."""
        k = 0
        for st in self.stages:
            for p in st.pools:
                p.freeze_until(t_free)
                if st.blockwise:
                    if added[k]:
                        p.grow(int(added[k]), t_free)
                    k += 1

    # ------------------------------------------------------------------ run
    def run(self, proc: ArrivalProcess) -> FabricResult:
        L = len(self.stages)
        cal = EventCalendar()
        times = arrival_times(proc)
        n = proc.n_requests if times is None else times.size
        if self._fail_bounds is not None:
            if times is None:
                raise ValueError(
                    "failure injection is open-loop only (trace/Poisson "
                    "arrivals), matching segmented replay"
                )
            # seams cut the request stream by ARRIVAL index — the identical
            # cut run_trace_segments makes, so the engines stay in lock-step
            self._fail_cuts = np.searchsorted(times, self._fail_bounds, side="left")
            self._seam_next = [0] * L
            self._stall_count = np.zeros(n, dtype=np.int64)
            self._phantom.clear()
        # request-major presampling (layer-major draw order): the same
        # helper, seed and order the virtual-time paths use, so per-request
        # service times are identical across engines regardless of the
        # calendar's interleaving; "hash" evaluates the fleet kernel's
        # counter hash instead (vectorized over requests — same bits the
        # streaming scan derives one request at a time)
        if self.service_sampling == "hash":
            self._svc_idx = [
                hash_service_indices(
                    np, _hash_salt(self._seed, li), np.arange(n),
                    st.ppi, st.services.shape[0],
                ).astype(np.int64)
                for li, st in enumerate(self.stages)
            ]
        else:
            self._svc_idx = sample_service_indices(
                self.rng, [(st.services.shape[0], st.ppi) for st in self.stages], n
            )
        arrivals = np.zeros(n)
        completions = np.zeros(n)
        if self.collect_stats:
            stage_entry = np.zeros((n, L))
            stage_exit = np.zeros((n, L))
        next_admit = 0
        if times is None:
            assert isinstance(proc, ClosedLoop)
            k = min(proc.concurrency, n)
            for r in range(k):
                cal.push(0.0, r, 0)
            next_admit = k
        else:
            for r in range(n):
                arrivals[r] = times[r]
                cal.push(times[r], r, 0)
        # Under a failure plan the contract is the request-ordered scan: a
        # seam that grows capacity can let a later request physically reach a
        # downstream stage first, but the plan semantics (and the vtime
        # kernel) assign lanes strictly by arrival index.  So with failures
        # active each stage buffers early arrivals and dispatches in request
        # order (head-of-line FIFO); without failures the calendar order IS
        # the index order (non-overtaking) and the buffer is bypassed.
        ordered = self._fail_bounds is not None
        if ordered:
            pend: list[dict[int, float]] = [{} for _ in range(L)]
            nxt_r = [0] * L
            is_shed = np.zeros(n, dtype=bool)

            def _drain(s: int) -> None:
                while True:
                    j = nxt_r[s]
                    if j < n and is_shed[j]:
                        nxt_r[s] += 1
                        continue
                    if j not in pend[s]:
                        return
                    tj = pend[s].pop(j)
                    dj = self._dispatch_stage(s, tj, j)
                    if self.collect_stats:
                        stage_entry[j, s] = tj
                        stage_exit[j, s] = dj
                    if dj != dj:  # shed on a dead block: NaN, no push
                        completions[j] = math.nan
                        is_shed[j] = True
                    else:
                        cal.push(dj, j, s + 1)
                    nxt_r[s] += 1

        while len(cal):
            t, r, s = cal.pop()
            if s == L:
                completions[r] = t
                if times is None and next_admit < n:
                    arrivals[next_admit] = t
                    cal.push(t, next_admit, 0)
                    next_admit += 1
                continue
            if ordered:
                pend[s][r] = t
                # a dispatch here can unblock any downstream stage (and a
                # shed must advance every later stage past the dead index)
                for s2 in range(s, L):
                    _drain(s2)
                continue
            done = self._dispatch_stage(s, t, r)
            if self.collect_stats:
                # entry = when the request became ready for the stage, BEFORE
                # the inter-chip transfer — residence = xfer + wait + service
                stage_entry[r, s] = t
                stage_exit[r, s] = done
            if done != done:  # shed on a dead block: NaN completion, no push
                completions[r] = math.nan
                continue
            cal.push(done, r, s + 1)

        layer_busy = np.array(
            [
                sum(p.busy for p in st.pools) if st.blockwise else st.busy
                for st in self.stages
            ]
        )
        layer_arrays = np.array(
            [sum(p.n_servers * p.width for p in st.pools) for st in self.stages],
            dtype=np.float64,
        )
        if self._fail_bounds is not None and completions.size:
            # shed requests leave NaN completions; the horizon is the last
            # SERVED completion (all-NaN degenerates to 0)
            served = completions[completions == completions]
            horizon = float(served.max()) if served.size else 0.0
        else:
            horizon = float(completions.max()) if completions.size else 0.0
        layer_capacity = np.array(
            [sum(p.capacity_cycles(horizon) for p in st.pools) for st in self.stages]
        )
        if self._fail_bounds is not None:
            tel = get_telemetry()
            tel.gauge("fabric.failures.availability", self.failures.availability())
            tel.count("fabric.failures.killed", self.failures.n_killed)
            tel.count("fabric.failures.repaired", self.failures.n_repaired)
            tel.count("fabric.failures.retried_busy_lanes", self._n_retried_busy)
            tel.count("fabric.failures.shed_requests", self._n_shed)
        stats = None
        if self.collect_stats:
            xfer = (
                np.zeros(L) if self._xfer is None else self._xfer * float(n)
            )  # every request crosses each stage's entry links exactly once
            stats = FabricStats(
                layer_service=np.array(
                    [sum(p.stats.svc_cycles for p in st.pools) for st in self.stages]
                ),
                layer_queue_wait=np.array(
                    [sum(p.stats.queue_wait for p in st.pools) for st in self.stages]
                ),
                layer_xfer=xfer,
                layer_reprogram=np.array(
                    [
                        sum(p.stats.frozen_cycles * p.width for p in st.pools)
                        for st in self.stages
                    ]
                ),
                layer_jobs=np.array(
                    [sum(p.stats.jobs for p in st.pools) for st in self.stages],
                    dtype=np.int64,
                ),
                replica_busy=tuple(
                    tuple(np.asarray(p.stats.server_busy) for p in st.pools)
                    for st in self.stages
                ),
                stage_entry=stage_entry,
                stage_exit=stage_exit,
                layer_occupied=np.array(
                    [sum(p.busy for p in st.pools) for st in self.stages]
                ),
            )
        return FabricResult(
            policy=self.alloc.policy,
            clock_hz=self.clock_hz,
            arrivals=arrivals,
            completions=completions,
            layer_busy=layer_busy,
            layer_arrays=layer_arrays,
            layer_capacity=layer_capacity,
            reallocations=(
                list(self.reallocator.events) if self.reallocator is not None else []
            ),
            stats=stats,
        )

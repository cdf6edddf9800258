"""Discrete-event core: FIFO server pools + a global event calendar.

Copied from the reference ``fabric/events.py`` (numpy only).

The analytic model in ``core/cim/simulate.py`` collapses time into
steady-state closed forms; this module keeps it explicit.  The fabric is a
set of *server pools* — one pool per block (block-wise dataflow) or one pool
per layer (layer-wise dataflow, where a server is a full layer duplicate and
a "job" is a patch whose service time is the per-patch barrier
``max_b cycles[p, b]``).

Two exact optimizations keep pure-Python simulation tractable at ResNet18
scale (~1.3e5 patch-block jobs per image):

  * Pools are *work-conserving FIFO with no preemption*, so a job's
    completion time is fixed the moment it is enqueued — later arrivals
    cannot affect earlier jobs.  We therefore resolve a whole batch of jobs
    eagerly at dispatch time ("lazy lookahead") instead of scheduling one
    event per job.  The global calendar only carries request x stage events.
  * Dispatches happen in nondecreasing simulated time (the calendar pops in
    time order), so per-pool FIFO order is preserved across requests.

Single-server pools (the common case at small designs) vectorize to a
cumulative sum; multi-server pools scan server free-times with a
deterministic earliest-free / lowest-index rule.  Both are bit-identical to
the packed virtual-time kernel in ``vtime.py`` (asserted in tests), which is
the same logic as dense array algebra (the port's numpy engine, its
plain torch recurrence and the VT kernel on the card).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

__all__ = ["PoolStats", "ServerPool", "EventCalendar"]


@dataclass
class PoolStats:
    """Per-pool accumulators for the telemetry layer (``stats=True``).

    Units are JOB-cycles (one job on one replica for one cycle), except
    ``frozen_cycles`` which is replica-cycles lost to reprogramming freezes;
    multiply by the pool's ``width`` for array-cycles.  ``server_busy`` is
    per replica lane, the input to replica-level load-imbalance reporting.
    It is a plain float list — scalar ``+=`` on a list element is an order
    of magnitude cheaper than on an ndarray cell, and the dispatch hot loop
    touches it per job batch; convert with ``np.asarray`` when reporting.
    """

    server_busy: list[float]  # (D,) busy cycles per replica lane
    svc_cycles: float = 0.0  # total service cycles dispatched
    queue_wait: float = 0.0  # cycles jobs spent waiting for a free replica
    frozen_cycles: float = 0.0  # replica-cycles lost to freeze_until stalls
    jobs: int = 0


def _earliest_free(avail: list[float]) -> int:
    """Earliest-free server, ties -> lowest index.

    The deterministic tie-break (rather than heap order) keeps the pool's
    evolution a pure function of the free-time *multiset*, which is what the
    packed virtual-time kernel (``vtime.dispatch_step``, sorted lanes)
    simulates — so the two engines agree bit-for-bit."""
    return min(range(len(avail)), key=avail.__getitem__)


class ServerPool:
    """``n`` identical replicas of one compute unit with a shared FIFO queue.

    ``width`` = crossbar arrays per replica (for utilization accounting).
    Server state is just each replica's next-free time; ``busy`` accumulates
    busy array-cycles.
    """

    __slots__ = (
        "avail",
        "width",
        "busy",
        "jobs",
        "record_starts",
        "starts",
        "durations",
        "servers",
        "stats",
        "_online",
    )

    def __init__(
        self,
        n_servers: int,
        width: int = 1,
        record_starts: bool = False,
        stats: bool = False,
    ):
        if n_servers < 1:
            raise ValueError("a pool needs at least one server")
        self.avail: list[float] = [0.0] * n_servers
        self.width = int(width)
        self.busy = 0.0
        self.jobs = 0
        self.record_starts = record_starts
        self.starts: list[np.ndarray] = []
        self.durations: list[np.ndarray] = []
        self.servers: list[np.ndarray] = []  # lane index per job (record_starts)
        self.stats = PoolStats([0.0] * n_servers) if stats else None
        self._online: list[tuple[float, int]] = [(0.0, n_servers)]

    @property
    def n_servers(self) -> int:
        return len(self.avail)

    def dispatch(self, t_ready: float, services: np.ndarray) -> float:
        """FIFO-dispatch a batch of jobs, all ready at ``t_ready``.

        Returns the completion time of the batch (max over jobs) and
        advances the replica free-times.  Exact: equivalent to running one
        event per job.
        """
        s = np.asarray(services, dtype=np.float64)
        m = s.size
        if m == 0:
            return t_ready
        tot = float(s.sum())
        self.busy += tot * self.width
        self.jobs += m
        observe = self.record_starts or self.stats is not None
        if len(self.avail) == 1:
            start0 = self.avail[0] if self.avail[0] > t_ready else t_ready
            # cumsum over [start0, s...] accumulates left-to-right, the same
            # op order as the per-job recurrence — bit-identical to vtime's
            # step scan (a plain `start0 + cumsum(s)` would round differently)
            ends = np.cumsum(np.concatenate(((start0,), s)))[1:]
            if observe:
                if self.record_starts:
                    self.starts.append(np.concatenate(((start0,), ends[:-1])))
                    self.durations.append(s)
                    self.servers.append(np.zeros(m, dtype=np.int64))
                if self.stats is not None:
                    ps = self.stats
                    ps.jobs += m
                    ps.svc_cycles += tot
                    # sum(starts) - m*t_ready without materializing starts
                    if m == 1:
                        ps.queue_wait += start0 - t_ready
                    else:
                        ps.queue_wait += (
                            start0 + float(ends[:-1].sum()) - m * t_ready
                        )
                    ps.server_busy[0] += tot
            self.avail[0] = float(ends[-1])
            return self.avail[0]
        avail = self.avail
        last = 0.0
        if self.record_starts:
            st_l: list[float] = []
            lane_l: list[int] = []
            put_st = st_l.append
            put_lane = lane_l.append
            for sv in s.tolist():
                i = _earliest_free(avail)
                a = avail[i]
                if a < t_ready:
                    a = t_ready
                put_st(a)
                put_lane(i)
                e = a + sv
                if e > last:
                    last = e
                avail[i] = e
            lane = np.array(lane_l, dtype=np.int64)
            self.starts.append(np.array(st_l))
            self.durations.append(s)
            self.servers.append(lane)
            if self.stats is not None:
                ps = self.stats
                ps.jobs += m
                ps.svc_cycles += tot
                ps.queue_wait += float(sum(st_l)) - m * t_ready
                sb = ps.server_busy
                for i, v in enumerate(
                    np.bincount(lane, weights=s, minlength=len(sb)).tolist()
                ):
                    sb[i] += v
        elif observe:
            # stats-only: one float add per job; per-lane busy falls out of
            # the free-time deltas afterwards.  All jobs in this batch share
            # t_ready, so a lane's idle gap (the clamp) can occur at most
            # once — on its first job — hence busy = final - max(init, t).
            avail0 = list(avail)
            qw = 0.0
            for sv in s.tolist():
                i = _earliest_free(avail)
                a = avail[i]
                if a < t_ready:
                    a = t_ready
                qw += a
                e = a + sv
                if e > last:
                    last = e
                avail[i] = e
            ps = self.stats
            ps.jobs += m
            ps.svc_cycles += tot
            ps.queue_wait += qw - m * t_ready
            sb = ps.server_busy
            for i, a0 in enumerate(avail0):
                b = avail[i] - (a0 if a0 > t_ready else t_ready)
                if b > 0.0:
                    sb[i] += b
        else:
            for sv in s.tolist():
                i = _earliest_free(avail)
                a = avail[i]
                if a < t_ready:
                    a = t_ready
                e = a + sv
                if e > last:
                    last = e
                avail[i] = e
        return last

    def grow(self, extra: int, t_free: float) -> None:
        """Add ``extra`` replicas that come online at ``t_free``."""
        self.avail.extend([float(t_free)] * int(extra))
        self._online.append((float(t_free), int(extra)))
        if self.stats is not None:
            self.stats.server_busy.extend([0.0] * int(extra))

    def kill(self, k: int, t: float) -> int:
        """Remove the ``k`` LATEST-free replicas at time ``t`` (failures).

        Killing the largest free-times is the multiset rule the packed
        virtual-time kernel implements by setting the top sorted lane
        positions to ``+inf`` (``fleet._apply_boundary``) — both engines
        must retire the same lanes for bit-identity to hold.  Jobs already
        dispatched to a killed lane DRAIN (their completion was fixed at
        dispatch; no preemption in either engine) — the return value counts
        how many killed lanes were still busy at ``t``, i.e. carried work a
        live fabric would have had to retry on survivors.  ``kill`` may
        empty the pool; dispatching on an empty pool is the caller's
        responsibility to prevent (``FabricSim`` parks a phantom lane)."""
        k = int(k)
        if k > len(self.avail):
            raise ValueError(f"cannot kill {k} of {len(self.avail)} servers")
        busy = 0
        for _ in range(k):
            i = max(range(len(self.avail)), key=self.avail.__getitem__)
            if self.avail[i] > t:
                busy += 1
            self.avail.pop(i)
            if self.stats is not None:
                self.stats.server_busy.pop(i)
        self._online.append((float(t), -k))
        return busy

    def capacity_cycles(self, horizon: float) -> float:
        """Array-cycles of capacity over [0, horizon], counting replicas
        added mid-run only from the moment they came online."""
        return self.width * sum(
            n * max(0.0, horizon - t) for t, n in self._online
        )

    def freeze_until(self, t: float) -> None:
        """Stall the pool (e.g. while arrays are being reprogrammed)."""
        if self.stats is not None:
            # replica-cycles the freeze takes away: each lane that would have
            # been free before ``t`` cannot serve until ``t``
            self.stats.frozen_cycles += sum(
                t - a for a in self.avail if a < t
            )
        self.avail = [a if a > t else float(t) for a in self.avail]

    def occupancy(self, bucket: float, horizon: float) -> np.ndarray:
        """Mean busy replicas per time bucket (requires record_starts).

        Exact: every job interval is split over the buckets it overlaps, so
        ``occupancy(...) * bucket`` integrates to total busy cycles."""
        n = int(np.ceil(horizon / bucket)) + 1
        out = np.zeros(n)
        if not self.starts:
            return out
        B = float(bucket)
        a = np.concatenate(self.starts)
        d = np.concatenate(self.durations)
        b = a + d
        i0 = np.minimum((a / B).astype(np.int64), n - 1)
        i1 = np.minimum((b / B).astype(np.int64), n - 1)
        same = i0 == i1
        np.add.at(out, i0[same], d[same])
        sp = ~same
        np.add.at(out, i0[sp], (i0[sp] + 1) * B - a[sp])
        np.add.at(out, i1[sp], b[sp] - i1[sp] * B)
        # full buckets strictly between i0 and i1, via a difference array
        diff = np.zeros(n + 1)
        np.add.at(diff, i0[sp] + 1, B)
        np.add.at(diff, i1[sp], -B)
        out += np.cumsum(diff)[:n]
        return out / B

    def timeline(self, bucket: float, horizon: float) -> np.ndarray:
        """Busy array-cycles per time bucket (requires record_starts)."""
        n = int(np.ceil(horizon / bucket)) + 1
        out = np.zeros(n)
        if not self.starts:
            return out
        st = np.concatenate(self.starts)
        du = np.concatenate(self.durations)
        idx = np.minimum((st / bucket).astype(np.int64), n - 1)
        np.add.at(out, idx, du * self.width)
        return out


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    req: int = field(compare=False)
    stage: int = field(compare=False)


class EventCalendar:
    """Time-ordered heap of (request, stage) entry events."""

    __slots__ = ("_heap", "_seq")

    def __init__(self):
        self._heap: list[_Event] = []
        self._seq = 0

    def push(self, time: float, req: int, stage: int) -> None:
        heapq.heappush(self._heap, _Event(float(time), self._seq, req, stage))
        self._seq += 1

    def pop(self) -> tuple[float, int, int]:
        ev = heapq.heappop(self._heap)
        return ev.time, ev.req, ev.stage

    def __len__(self) -> int:
        return len(self._heap)

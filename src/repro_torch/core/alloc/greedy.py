"""Greedy latency-proportional replica allocation (Section III-B).

The paper's loop grants a replica to the unit with the highest expected
latency until the slowest unit can no longer be afforded.  Copied from the
reference ``core/alloc/greedy.py``:

  * ``greedy_allocate`` — the heapq loop, on the host, verbatim;
  * ``proportional_allocate`` / ``proportional_allocate_batch`` — the
    prior-work policies, numpy on the host (their unstable ``argsort`` tie
    order must be numpy's to match);
  * ``greedy_batch_kernel`` / ``greedy_allocate_batch`` — the lock-step
    batched greedy over C configs, in torch float64 on the device;
  * ``greedy_event_schedule`` / ``GreedyEventSchedule`` — the whole greedy
    as one sorted grant-event table that answers every budget, numpy on the
    host (the fused sweep's ``"torch"`` engine).

  * ``erlang_c`` / ``queueing_delay`` / ``queueing_allocate`` — the
    ``latency_aware`` policy's tail-weighted queueing allocator, numpy
    float64 on the host, verbatim.

  * ``greedy_release`` — the reverse greedy that frees replicas (the fleet's
    shrinking seams), ``greedy_allocate_placed`` / ``PlacedAllocationResult``
    — the communication-aware greedy over a chip-partitioned fabric — and
    ``place_extras`` (chips for counts fixed elsewhere), numpy on the host,
    verbatim; ``core.cim.topology`` calls them.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from ... import resolve_device

__all__ = [
    "AllocationResult",
    "BatchAllocationResult",
    "GreedyEventSchedule",
    "PlacedAllocationResult",
    "erlang_c",
    "greedy_allocate",
    "greedy_allocate_batch",
    "greedy_allocate_placed",
    "greedy_batch_kernel",
    "greedy_event_schedule",
    "greedy_release",
    "place_extras",
    "proportional_allocate",
    "proportional_allocate_batch",
    "queueing_allocate",
    "queueing_delay",
]


@dataclass(frozen=True)
class AllocationResult:
    """Replica counts chosen by the allocator.

    Attributes:
      replicas:    int array, replicas granted per unit (>= 1 each).
      latency:     float array, resulting expected latency per unit
                   (base_latency / replicas).
      spent:       total cost consumed.
      leftover:    budget remaining when the loop stopped.
    """

    replicas: np.ndarray
    latency: np.ndarray
    spent: float
    leftover: float

    @property
    def makespan(self) -> float:
        return float(self.latency.max()) if self.latency.size else 0.0


def greedy_allocate(
    base_latency: np.ndarray,
    unit_cost: np.ndarray,
    budget: float,
    *,
    initial_replicas: np.ndarray | None = None,
    spare_fraction: float = 0.0,
    audit=None,
) -> AllocationResult:
    """Grant replicas to the unit with the highest expected latency.

    ``base_latency``: expected latency of each unit with a single replica;
    ``unit_cost``: cost of one more replica of each unit; ``budget``: total
    cost available for *additional* replicas; ``initial_replicas``:
    optionally start from an existing allocation.  Stops when the current
    slowest unit can no longer be afforded, the paper's stopping rule.
    ``spare_fraction`` of ``budget`` is withheld as a hot-spare reserve
    (``fabric.failures.degrade_plan`` spends it) and comes back in
    ``leftover``; ``audit`` (an ``obs.AllocationAudit``) receives one entry
    per grant and one for the stopping rule.
    """
    if not 0.0 <= spare_fraction <= 1.0:
        raise ValueError(f"spare_fraction must be in [0, 1], got {spare_fraction}")
    reserve = float(budget) * spare_fraction
    base_latency = np.asarray(base_latency, dtype=np.float64)
    unit_cost = np.asarray(unit_cost, dtype=np.float64)
    if base_latency.shape != unit_cost.shape:
        raise ValueError(
            f"base_latency {base_latency.shape} vs unit_cost {unit_cost.shape}"
        )
    n = base_latency.size
    replicas = (
        np.ones(n, dtype=np.int64)
        if initial_replicas is None
        else np.asarray(initial_replicas, dtype=np.int64).copy()
    )
    if n == 0:
        return AllocationResult(replicas, base_latency.copy(), 0.0, float(budget))
    if np.any(replicas < 1):
        raise ValueError("every unit needs at least one replica")

    # Max-heap keyed by current expected latency.
    heap = [(-base_latency[i] / replicas[i], i) for i in range(n)]
    heapq.heapify(heap)
    spent = 0.0
    remaining = float(budget) - reserve
    while heap:
        neg_lat, i = heapq.heappop(heap)
        if unit_cost[i] > remaining:
            # the slowest unit cannot be afforded: the allocation is final
            # (cheaper, faster units would not reduce the makespan)
            if audit is not None:
                audit.stop("budget", i, unit_cost[i], remaining)
            heapq.heappush(heap, (neg_lat, i))
            break
        remaining -= unit_cost[i]
        spent += unit_cost[i]
        replicas[i] += 1
        new_lat = base_latency[i] / replicas[i]
        if audit is not None:
            audit.grant(i, unit_cost[i], -neg_lat, new_lat, remaining)
        heapq.heappush(heap, (-new_lat, i))

    latency = base_latency / replicas
    return AllocationResult(replicas, latency, spent, remaining + reserve)


def greedy_release(
    base_latency: np.ndarray,
    unit_cost: np.ndarray,
    release: float,
    *,
    replicas: np.ndarray,
) -> AllocationResult:
    """Reverse greedy: free at least ``release`` cost from ``replicas``.

    The exact inverse of ``greedy_allocate``'s grant rule: repeatedly remove
    one replica from the unit whose latency grows the LEAST by losing it —
    the unit with the smallest ``base_i / (r_i - 1)`` among those with more
    than one replica (ties to the lower index, mirroring the grant heap).
    Used by segmented replay (``fleet.segment_growth_plan``) when a seam's
    budget shrinks — degraded capacity after failures.  Stops once the freed
    cost reaches ``release`` or every unit is down to its mandatory copy.

    Returns an ``AllocationResult`` whose ``spent`` is the (negative) freed
    cost — so warm-started callers can keep one running budget across grow
    and shrink seams; ``leftover`` is the overshoot past ``release`` (>= 0,
    replicas free whole cost units).
    """
    base_latency = np.asarray(base_latency, dtype=np.float64)
    unit_cost = np.asarray(unit_cost, dtype=np.float64)
    if base_latency.shape != unit_cost.shape:
        raise ValueError(
            f"base_latency {base_latency.shape} vs unit_cost {unit_cost.shape}"
        )
    replicas = np.asarray(replicas, dtype=np.int64).copy()
    if replicas.shape != base_latency.shape:
        raise ValueError(
            f"replicas {replicas.shape} vs base_latency {base_latency.shape}"
        )
    if np.any(replicas < 1):
        raise ValueError("every unit needs at least one replica")
    if release < 0:
        raise ValueError(f"release must be >= 0, got {release}")

    # Min-heap keyed by the latency each unit would have after losing one
    # replica; stale entries are detected by re-deriving the key.
    heap = [
        (base_latency[i] / (replicas[i] - 1), i)
        for i in range(base_latency.size)
        if replicas[i] > 1
    ]
    heapq.heapify(heap)
    freed = 0.0
    while heap and freed < release:
        lat, i = heapq.heappop(heap)
        if replicas[i] <= 1 or lat != base_latency[i] / (replicas[i] - 1):
            continue
        replicas[i] -= 1
        freed += unit_cost[i]
        if replicas[i] > 1:
            heapq.heappush(heap, (base_latency[i] / (replicas[i] - 1), i))
    latency = base_latency / replicas
    return AllocationResult(replicas, latency, -freed, max(freed - release, 0.0))


@dataclass(frozen=True)
class PlacedAllocationResult:
    """Replica counts AND locations chosen by the placement-aware greedy.

    Attributes:
      replicas:      int array, replicas granted per unit (>= 1 each).
      latency:       float array, effective expected latency per unit =
                     base_latency / replicas + current comm penalty.
      spent:         total cost consumed.
      leftover:      budget remaining when the loop stopped.
      replica_chips: per unit, int array of the chip each replica sits on
                     (entry 0 is the mandatory copy's home chip).
      penalty:       per-unit comm penalty at the final placement (the max
                     over the unit's replica chips — a stage dispatches all
                     its jobs at entry, so the farthest replica gates it).
    """

    replicas: np.ndarray
    latency: np.ndarray
    spent: float
    leftover: float
    replica_chips: list[np.ndarray]
    penalty: np.ndarray

    @property
    def makespan(self) -> float:
        return float(self.latency.max()) if self.latency.size else 0.0


def greedy_allocate_placed(
    base_latency: np.ndarray,
    unit_cost: np.ndarray,
    budget: float,
    *,
    home_chip: np.ndarray,
    unit_penalty: np.ndarray,
    chip_free: np.ndarray,
    initial_replicas: np.ndarray | None = None,
    audit=None,
) -> PlacedAllocationResult:
    """Communication-aware ``greedy_allocate`` over a chip-partitioned fabric.

    The paper's greedy treats the fabric as one flat pool; here every replica
    must land on a specific chip with finite free capacity, and a replica
    placed off the unit's data source costs its stage a transfer delay on the
    dataflow edge (a stage dispatches all its jobs at request entry, so the
    farthest replica's transfer gates the whole unit).  The penalty scores
    the PLACEMENT side of every move: each grant goes on the affordable chip
    that least raises the unit's max penalty (ties -> lower raw penalty,
    then lower chip id), so grant-order interleaving packs the replicas of
    hot stages onto their source chips before cold stages fragment them —
    measurably fewer crossings than placing the same counts sequentially
    after the fact.

    Ranking (and therefore the replica COUNTS) stays the paper's pure drain
    latency ``base_i / r_i``, deliberately penalty-free, for two reasons.
    Transfers pipeline across requests — they delay each request but consume
    no pool capacity — so the throughput-optimal counts are exactly the flat
    greedy's; and a transfer penalty is a per-request constant replication
    cannot remove, so folding it into the rank pours replicas into taxed
    stages to "compensate" a latency no replica removes while the true
    bottleneck pools saturate (the communication-blind failure mode,
    inverted — we measured p99 blowing up 40x that way).  Load-dependent
    penalty/queueing trade-offs belong to the ``latency_aware`` policy,
    which prices the stage entry transfer into its delay score
    (``queueing_allocate(extra_delay=)``).

    Args:
      home_chip:    (N,) chip of each unit's mandatory first copy (replica 0).
      unit_penalty: (N, K) comm penalty, in latency units, of serving unit
        ``i`` from chip ``k`` — typically ``transfer_cycles(src_i, k, bytes_i)``.
      chip_free:    (K,) free capacity per chip AFTER mandatory copies; the
        caller's array is copied, not consumed.

    With one chip the chip choice is trivial and the loop performs
    bit-for-bit the same float comparisons as ``greedy_allocate`` — the flat
    allocator is recovered exactly as the single-chip special case (pinned
    by the golden-equivalence suite).  Stops, as in the paper, when the
    current slowest unit can no longer be afforded — by budget *or* by chip
    capacity.  Returned ``latency`` is the effective per-unit latency
    (drain + final penalty).
    """
    base_latency = np.asarray(base_latency, dtype=np.float64)
    unit_cost = np.asarray(unit_cost, dtype=np.float64)
    if base_latency.shape != unit_cost.shape:
        raise ValueError(
            f"base_latency {base_latency.shape} vs unit_cost {unit_cost.shape}"
        )
    n = base_latency.size
    home = np.asarray(home_chip, dtype=np.int64)
    pen = np.asarray(unit_penalty, dtype=np.float64)
    free = np.asarray(chip_free, dtype=np.float64).copy()
    K = free.size
    if pen.shape != (n, K):
        raise ValueError(f"unit_penalty {pen.shape} != ({n}, {K})")
    if home.shape != (n,):
        raise ValueError(f"home_chip has shape {home.shape}, expected ({n},)")
    replicas = (
        np.ones(n, dtype=np.int64)
        if initial_replicas is None
        else np.asarray(initial_replicas, dtype=np.int64).copy()
    )
    if n == 0:
        return PlacedAllocationResult(
            replicas, base_latency.copy(), 0.0, float(budget), [], np.zeros(0)
        )
    if np.any(replicas < 1):
        raise ValueError("every unit needs at least one replica")
    # initial replicas (the mandatory copy + any warm start) sit at home —
    # and warm-start extras consume their home chip's capacity (chip_free is
    # defined as free AFTER mandatory copies only)
    chips = [home[i] * np.ones(replicas[i], dtype=np.int64) for i in range(n)]
    np.subtract.at(free, home, (replicas - 1) * unit_cost)
    if np.any(free < 0):
        bad = int(np.flatnonzero(free < 0)[0])
        raise ValueError(
            f"warm-start replicas oversubscribe chip {bad} by {-free[bad]} arrays"
        )
    cur_pen = pen[np.arange(n), home]

    heap = [(-base_latency[i] / replicas[i], i) for i in range(n)]
    heapq.heapify(heap)
    spent = 0.0
    remaining = float(budget)
    chip_ids = np.arange(K)
    while heap:
        neg_lat, i = heapq.heappop(heap)
        ok = free >= unit_cost[i]
        if unit_cost[i] > remaining or not ok.any():
            # the paper's stopping rule, extended: the slowest unit cannot be
            # afforded (budget) or physically placed (capacity) — final.
            if audit is not None:
                reason = "budget" if unit_cost[i] > remaining else "capacity"
                audit.stop(reason, i, unit_cost[i], remaining)
            heapq.heappush(heap, (neg_lat, i))
            break
        # cheapest chip in (new max penalty, raw penalty, id) order
        cand = chip_ids[ok]
        new_max = np.maximum(cur_pen[i], pen[i, cand])
        k = cand[np.lexsort((cand, pen[i, cand], new_max))[0]]
        free[k] -= unit_cost[i]
        remaining -= unit_cost[i]
        spent += unit_cost[i]
        replicas[i] += 1
        chips[i] = np.append(chips[i], k)
        cur_pen[i] = max(cur_pen[i], pen[i, k])
        new_lat = base_latency[i] / replicas[i]
        if audit is not None:
            audit.grant(i, unit_cost[i], -neg_lat, new_lat, remaining, chip=k)
        heapq.heappush(heap, (-new_lat, i))

    latency = base_latency / replicas + cur_pen
    return PlacedAllocationResult(
        replicas, latency, spent, remaining, chips, cur_pen
    )


def place_extras(
    replicas: np.ndarray,
    unit_cost: np.ndarray,
    *,
    home_chip: np.ndarray,
    unit_penalty: np.ndarray,
    chip_free: np.ndarray,
) -> list[np.ndarray]:
    """Assign chips to replica counts chosen WITHOUT placement awareness.

    The proportional policies (and the queueing allocator, whose wavefront
    moves are not per-replica) fix replica counts first; this places each
    unit's extra replicas greedily on the affordable chip with the lowest
    (penalty, id), walking units in index order (deterministic).  Used by
    ``core.cim.topology.allocate_placed`` for every policy that does not go
    through ``greedy_allocate_placed``.  Raises if capacity cannot hold the
    counts (callers budget extras from total free arrays, so this only
    triggers when fragmentation across chips is pathological).
    """
    replicas = np.asarray(replicas, dtype=np.int64)
    cost = np.asarray(unit_cost, dtype=np.float64)
    home = np.asarray(home_chip, dtype=np.int64)
    pen = np.asarray(unit_penalty, dtype=np.float64)
    free = np.asarray(chip_free, dtype=np.float64).copy()
    chip_ids = np.arange(free.size)
    out: list[np.ndarray] = []
    for i in range(replicas.size):
        chips = [int(home[i])]
        for _ in range(int(replicas[i]) - 1):
            ok = free >= cost[i]
            if not ok.any():
                raise ValueError(
                    f"no chip can hold another replica of unit {i} "
                    f"(cost {cost[i]}, free {free})"
                )
            cand = chip_ids[ok]
            k = cand[np.lexsort((cand, pen[i, cand]))[0]]
            free[k] -= cost[i]
            chips.append(int(k))
        out.append(np.asarray(chips, dtype=np.int64))
    return out


@dataclass(frozen=True)
class BatchAllocationResult:
    """Structure-of-arrays ``AllocationResult`` for C configs, as tensors on
    the device the batch ran on."""

    replicas: torch.Tensor  # (C, N) int64
    latency: torch.Tensor  # (C, N) float64
    spent: torch.Tensor  # (C,) float64
    leftover: torch.Tensor  # (C,) float64

    @property
    def makespan(self) -> torch.Tensor:  # (C,)
        if self.latency.shape[1] == 0:
            return self.latency.new_zeros(len(self))
        return self.latency.amax(dim=1)

    def __len__(self) -> int:
        return self.replicas.shape[0]


def greedy_batch_kernel(base, cost, budget, r0):
    """The lock-step batched greedy: (C, N) float64 ``base`` latencies and
    ``cost`` per replica, (C,) ``budget``, (C, N) ``r0`` initial replicas ->
    (replicas (C, N) float64, leftover (C,)).

    1.  *Bulk water-fill by bisection.*  For a makespan target ``lam`` the
        state ``r_i = max(r0_i, ceil(base_i / lam))`` is one the scalar
        greedy passes through if its cost fits the budget.  80 bisection
        steps find the tightest affordable one, then back off by 1e-9
        relative so grants within roundoff of the boundary go to phase 2.
    2.  *Lock-step residual loop.*  Grant the argmax-latency unit of every
        config one replica per step; a config stops the moment its argmax
        is unaffordable.  ``torch.argmax`` returns the first maximum, the
        scalar heap's tie order.  The loop ends when every config is done.

    Each line is one elementwise or reduction op in float64 (no fused
    multiply-add), the arithmetic of the reference, so the bisection sees
    the same values.
    """
    C, N = base.shape

    def r_of(lam):
        return torch.maximum(r0, torch.ceil(base / lam[:, None]))

    def spend_of(r):
        return ((r - r0) * cost).sum(dim=1)

    lat0 = base / r0
    hi = torch.clamp(lat0.amax(dim=1), min=1e-300)  # degenerate all-zero rows
    min_cost = cost.amin(dim=1)
    # strictly below the final greedy makespan -> provably infeasible
    lo = hi / (2.0 * (2.0 + torch.clamp(budget, min=0.0) / min_cost))
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        feasible = spend_of(r_of(mid)) <= budget
        lo, hi = torch.where(feasible, lo, mid), torch.where(feasible, mid, hi)
    r = r_of(hi * (1.0 + 1e-9))
    rem = budget - spend_of(r)

    idx = torch.arange(N, device=base.device)
    done = torch.zeros(C, dtype=torch.bool, device=base.device)
    while not bool(done.all()):
        lat = base / r
        i = lat.argmax(dim=1)
        ci = torch.gather(cost, 1, i[:, None])[:, 0]
        ok = (ci <= rem) & ~done
        r = r + ((idx[None, :] == i[:, None]) & ok[:, None])
        rem = rem - torch.where(ok, ci, 0.0)
        done = done | ~ok
    return r, rem


def greedy_allocate_batch(
    base_latency,
    unit_cost,
    budgets,
    *,
    initial_replicas=None,
    device: str | torch.device = "cuda",
) -> BatchAllocationResult:
    """Vectorized ``greedy_allocate`` over C configs on ``device``.

    ``base_latency`` / ``unit_cost`` / ``initial_replicas`` broadcast from
    (N,) to (C, N); ``budgets`` is (C,).  Replica counts are element-wise
    those of the scalar allocator; ``spent`` / ``leftover`` agree to float
    roundoff.  Runs in float64.
    """
    dev = resolve_device(device)
    budgets = np.atleast_1d(np.asarray(budgets, dtype=np.float64))
    C = budgets.shape[0]
    base = np.atleast_1d(np.asarray(base_latency, dtype=np.float64))
    cost = np.atleast_1d(np.asarray(unit_cost, dtype=np.float64))
    if base.shape[-1] != cost.shape[-1]:
        raise ValueError(f"base_latency {base.shape} vs unit_cost {cost.shape}")
    N = base.shape[-1]
    base = np.broadcast_to(base, (C, N))
    cost = np.broadcast_to(cost, (C, N))
    if np.any(cost <= 0):
        raise ValueError("unit_cost must be strictly positive")
    if initial_replicas is None:
        r0 = np.ones((C, N))
    else:
        r0 = np.broadcast_to(np.asarray(initial_replicas, dtype=np.float64), (C, N))
        if np.any(r0 < 1):
            raise ValueError("every unit needs at least one replica")

    def on_dev(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)

    base_t, cost_t, budget_t, r0_t = on_dev(base), on_dev(cost), on_dev(budgets), on_dev(r0)
    if N == 0:
        return BatchAllocationResult(
            torch.ones((C, 0), dtype=torch.int64, device=dev),
            base_t, torch.zeros(C, dtype=torch.float64, device=dev), budget_t,
        )
    r, rem = greedy_batch_kernel(base_t, cost_t, budget_t, r0_t)
    spent = ((r - r0_t) * cost_t).sum(dim=1)
    return BatchAllocationResult(r.to(torch.int64), base_t / r, spent, rem)


@dataclass(frozen=True)
class GreedyEventSchedule:
    """The greedy grant sequence as a static, budget-independent table.

    The scalar heap loop is fully determined before it runs: unit ``i``'s
    grant at replica count ``r`` has priority ``base_i / r``, priorities of
    one unit strictly decrease in ``r``, ties across units resolve to the
    lower index (heapq tuple order == ``argmax`` first-max), and the loop
    stops at the FIRST grant it cannot afford.  So the whole run is a walk
    down ONE sorted event list, and the stopping point for budget ``W`` is
    the longest prefix whose cumulative cost is <= ``W``.

    Exact, not approximate: priorities are the float64 quotients the heap
    compares, so sorting by ``(-key, unit)`` reproduces every comparison;
    with integer-valued costs and budgets every partial sum is an exact
    float64 integer below 2**53, so ``cum_cost[e] <= W`` is the heap's
    ``cost_i <= remaining`` test bit for bit; costs are positive, so
    ``searchsorted(cum_cost, W, side="right")`` IS the stopping rule.

    Attributes:
      unit: (E,) int64 — receiving unit of each event, priority order.
      key:  (E,) float64 — event priorities, non-increasing.
      cum_cost: (E,) float64 — cumulative cost through each event.
      r0:   (N,) int64 — warm-start replicas (grants count from here).
      max_budget: largest budget this table is complete for.
      base: (N,) float64 — the priorities' numerators.
    """

    unit: np.ndarray
    key: np.ndarray
    cum_cost: np.ndarray
    r0: np.ndarray
    max_budget: float
    base: np.ndarray

    @property
    def n_units(self) -> int:
        return self.r0.size

    def __len__(self) -> int:
        return self.unit.size

    def replicas_at(self, budgets: np.ndarray) -> BatchAllocationResult:
        """Replica counts for C budgets (CPU tensors) — element-wise those
        of ``greedy_allocate`` (or the lock-step batch kernel) per budget.
        Distinct stopping points are answered from one incremental walk over
        the event list."""
        b = np.atleast_1d(np.asarray(budgets, dtype=np.float64))
        if b.size and b.max() > self.max_budget:
            raise ValueError(
                f"budget {b.max()} exceeds schedule coverage {self.max_budget}"
            )
        if np.any(b != np.floor(b)):
            raise ValueError("exact prefix arithmetic needs integral budgets")
        n = self.n_units
        m = np.searchsorted(self.cum_cost, b, side="right")
        uniq, inv = np.unique(m, return_inverse=True)
        snaps = np.empty((uniq.size, n), dtype=np.int64)
        counts = self.r0.copy()
        prev = 0
        for j, stop in enumerate(uniq):
            if stop > prev:
                counts = counts + np.bincount(self.unit[prev:stop], minlength=n)
                prev = int(stop)
            snaps[j] = counts
        replicas = snaps[inv]
        spent = (
            np.where(m > 0, self.cum_cost[np.maximum(m - 1, 0)], 0.0)
            if len(self)
            else np.zeros(b.size)
        )
        return _host_result(replicas, self.base / replicas, spent, b - spent)


def greedy_event_schedule(
    base_latency: np.ndarray,
    unit_cost: np.ndarray,
    max_budget: float,
    *,
    initial_replicas: np.ndarray | None = None,
) -> GreedyEventSchedule:
    """Build the sorted grant-event table covering budgets up to
    ``max_budget`` (numpy, on the host).

    Events are generated per unit down to an estimated water level (with a
    4x margin), sorted by ``(-priority, unit)``, and truncated at the first
    event no ``<= max_budget`` run can afford.  A coverage check regenerates
    with more events per unit whenever the truncation point could have been
    preceded by an ungenerated event; it terminates because at most
    ``max_budget / min(cost)`` events are ever affordable.
    """
    base = np.atleast_1d(np.asarray(base_latency, dtype=np.float64))
    cost = np.atleast_1d(np.asarray(unit_cost, dtype=np.float64))
    if base.shape != cost.shape:
        raise ValueError(f"base_latency {base.shape} vs unit_cost {cost.shape}")
    if np.any(cost <= 0):
        raise ValueError("unit_cost must be strictly positive")
    if np.any(cost != np.floor(cost)):
        raise ValueError("exact prefix arithmetic needs integral unit costs")
    n = base.size
    r0 = (
        np.ones(n, dtype=np.int64)
        if initial_replicas is None
        else np.asarray(initial_replicas, dtype=np.int64).copy()
    )
    if np.any(r0 < 1):
        raise ValueError("every unit needs at least one replica")
    W = float(max_budget)
    if W != np.floor(W):
        raise ValueError("exact prefix arithmetic needs an integral max_budget")
    if n == 0 or W < np.min(cost):
        return GreedyEventSchedule(
            np.zeros(0, dtype=np.int64), np.zeros(0), np.zeros(0), r0, W, base
        )
    # at most floor(W / cost_i) grants of unit i fit ANY affordable prefix
    cap = np.floor(W / cost).astype(np.int64) + 1
    # water-level estimate: greedy stops near lam with
    # sum_i cost_i * base_i / lam ~= W; generate 4x past it
    lam = float(np.dot(cost, base / r0)) / max(W, 1.0) / 4.0
    if lam > 0:
        K = np.floor(base / (r0 * lam)).astype(np.int64) + 1
        K = np.clip(K, 1, cap)
    else:
        K = cap
    while True:
        units = np.repeat(np.arange(n, dtype=np.int64), K)
        offs = np.concatenate([[0], np.cumsum(K)[:-1]])
        reps = r0[units] + (np.arange(units.size) - np.repeat(offs, K))
        key = base[units] / reps
        order = np.lexsort((units, -key))
        units, key = units[order], key[order]
        cum = np.cumsum(cost[units])
        stop = int(np.searchsorted(cum, W, side="right"))
        if stop == units.size:
            if np.all(K >= cap):  # every affordable event already generated
                break
            K = np.minimum(K * 2, cap)
            continue
        # complete iff every unit's next UNgenerated event ranks after the
        # first rejected one, i.e. strictly below its priority
        next_key = base / (r0 + K)
        short = (next_key >= key[stop]) & (K < cap)
        if not short.any():
            break
        K = np.minimum(np.where(short, K * 2, K), cap)
    return GreedyEventSchedule(units[:stop], key[:stop], cum[:stop], r0, W, base)


def erlang_c(replicas: np.ndarray, offered: np.ndarray) -> np.ndarray:
    """Erlang-C wait probability P(wait) for M/M/c units, vectorized.

    ``replicas``: (N,) int servers per unit; ``offered``: (N,) offered load
    in erlangs (a = lambda * mean_service).  Units at or beyond saturation
    (a >= c) return 1.0 (the delay formula turns infinite there anyway).
    Computed through the numerically stable Erlang-B recurrence
    ``B(k) = a B(k-1) / (k + a B(k-1))``, run lock-step across units and
    frozen at each unit's own replica count.
    """
    c = np.asarray(replicas, dtype=np.int64)
    a = np.asarray(offered, dtype=np.float64)
    if np.any(c < 1):
        raise ValueError("every unit needs at least one replica")
    B = np.ones_like(a)
    for k in range(1, int(c.max()) + 1):
        aB = a * B
        B = np.where(k <= c, aB / (k + aB), B)
    rho = a / c
    out = B / np.maximum(1.0 - rho * (1.0 - B), 1e-300)
    return np.where(rho >= 1.0, 1.0, np.minimum(out, 1.0))


def queueing_delay(
    replicas: np.ndarray,
    job_rate: np.ndarray,
    mean_service: np.ndarray,
    service_scv: np.ndarray,
    arrival_scv: np.ndarray | float = 1.0,
) -> np.ndarray:
    """Expected queueing wait per job for G/G/c units (Allen-Cunneen).

    ``Wq = P(wait) / (c/s - lambda) * (Ca^2 + Cs^2) / 2`` with the per-unit
    service squared-CV measured from the profile — the input-distribution
    awareness the paper's throughput allocator does not have.  ``arrival_scv``
    is the arrival-process dispersion: 1 for Poisson jobs, ~the batch size
    for Poisson batch arrivals (requests dumping a whole patch batch at
    once).  Saturated units (rho >= 1) return +inf.  Exact for M/M/c; the
    standard approximation otherwise (M/D/c comes out as the familiar half
    of the M/M/c wait).
    """
    c = np.asarray(replicas, dtype=np.float64)
    lam = np.asarray(job_rate, dtype=np.float64)
    s = np.asarray(mean_service, dtype=np.float64)
    scv = np.asarray(service_scv, dtype=np.float64)
    ca2 = np.asarray(arrival_scv, dtype=np.float64)
    a = lam * s
    slack = c / np.maximum(s, 1e-300) - lam  # (c - a) / s
    pw = erlang_c(np.maximum(np.rint(c), 1).astype(np.int64), a)
    wq = pw / np.maximum(slack, 1e-300) * (ca2 + scv) / 2.0
    return np.where(a >= c, np.inf, wq)


def queueing_allocate(
    job_rate: np.ndarray,
    mean_service: np.ndarray,
    service_scv: np.ndarray,
    unit_cost: np.ndarray,
    budget: float,
    *,
    batch_size: np.ndarray | float = 1.0,
    group: np.ndarray | None = None,
    tail_weight: float = 4.6,
    initial_replicas: np.ndarray | None = None,
    extra_delay: np.ndarray | None = None,
) -> AllocationResult:
    """Greedy replica allocation by tail-weighted request delay at a load.

    Where ``greedy_allocate`` equalizes expected *throughput* latencies (the
    paper's objective — only the bottleneck matters), this allocator targets
    the latency a *request* sees at an offered load.  Each unit is a FIFO
    server pool receiving ``job_rate`` jobs per cycle in request-batches of
    ``batch_size``; with ``c`` replicas its delay score is

        D(c) = Shat + tail_weight * Wq(c),    Shat = s * max(batch / c, 1)

    ``Shat`` is the drain of the request's own batch (nearly deterministic —
    it concentrates over the batch), while ``Wq`` is the wait behind prior
    requests — for batch >= c the pool serves one "super-job" per request
    with no Erlang pooling gain (M/G/1 Pollaczek-Khinchine), below that the
    job-level Erlang-C wait applies.  The queueing term is the *variable*
    part of the delay, so a p99 objective weights it by roughly the tail
    ratio of an exponential-like wait: ``tail_weight ~ -ln(1 - 0.99) = 4.6``.

    The objective is ``sum over groups of max_in_group D`` — with ``group``
    = pipeline stage, a stage's latency is its slowest pool's, and stages
    add along the request path (contrast throughput, where only the global
    bottleneck matters).  At high utilization the Wq guard pins the
    allocation to the paper's utilization-equalizing greedy; at low
    utilization it spends the slack bottleneck headroom on shortening the
    whole request path instead.

    ``extra_delay`` (per-unit, additive) folds a replica-count-independent
    delay into the score — the communication penalty of the unit's placement
    on a multi-chip fabric (the stage's entry transfer on its dataflow
    edge).  A stage parked far from its data source scores slower, so the
    wavefront spends replicas shortening the compute of the stages the
    topology already taxes.  ``None`` leaves the score arithmetic untouched
    (the flat single-chip special case, bit-identical to before the hook).

    Greedy loop with *wavefront* moves: per group, the candidate is one
    extra replica for every member within 5% of the group's max (granting
    only the argmax of a near-tied wide stage would barely move its max, so
    single-unit moves systematically starve wide stages).  Grants go to the
    best positive gain per cost; a stabilization pre-phase first buys every
    pool below saturation.  Stops when the budget is out, nothing gains, or
    the best wavefront cannot be afforded (the paper's stopping rule).
    Returns an ``AllocationResult`` whose ``latency`` is the per-unit score
    ``D`` at the final replica counts.
    """
    lam = np.asarray(job_rate, dtype=np.float64)
    s = np.asarray(mean_service, dtype=np.float64)
    scv = np.asarray(service_scv, dtype=np.float64)
    cost = np.asarray(unit_cost, dtype=np.float64)
    if not (lam.shape == s.shape == scv.shape == cost.shape):
        raise ValueError(
            f"shape mismatch: rate {lam.shape}, service {s.shape}, "
            f"scv {scv.shape}, cost {cost.shape}"
        )
    if np.any(cost <= 0):
        raise ValueError("unit_cost must be strictly positive")
    n = lam.size
    batch = np.broadcast_to(np.asarray(batch_size, dtype=np.float64), (n,))
    grp = np.arange(n) if group is None else np.asarray(group, dtype=np.int64)
    if grp.shape != (n,):
        raise ValueError(f"group has shape {grp.shape}, expected ({n},)")
    replicas = (
        np.ones(n, dtype=np.int64)
        if initial_replicas is None
        else np.asarray(initial_replicas, dtype=np.int64).copy()
    )
    if n == 0:
        return AllocationResult(replicas, s.copy(), 0.0, float(budget))
    if np.any(replicas < 1):
        raise ValueError("every unit needs at least one replica")

    if extra_delay is not None:
        extra_delay = np.asarray(extra_delay, dtype=np.float64)
        if extra_delay.shape != (n,):
            raise ValueError(
                f"extra_delay has shape {extra_delay.shape}, expected ({n},)"
            )

    def score(reps, mem=slice(None)):
        """Delay score for the unit subset ``mem`` at replica counts
        ``reps`` (shaped like the subset) — candidate moves only re-score
        their own wave."""
        reps = np.asarray(reps, dtype=np.float64)
        s_, lam_, scv_, batch_ = s[mem], lam[mem], scv[mem], batch[mem]
        shat = s_ * np.maximum(batch_ / reps, 1.0)
        rho = lam_ * s_ / reps
        cv2 = scv_ / np.maximum(batch_, 1.0)
        wq = rho * shat * (1.0 + cv2) / 2.0 / np.maximum(1.0 - rho, 1e-300)
        sub = batch_ < reps  # more lanes than a whole batch: Erlang pooling
        if sub.any():
            wq_er = queueing_delay(
                np.maximum(np.rint(reps), 1).astype(np.int64), lam_, s_, scv_,
                arrival_scv=batch_,  # jobs still land in request-bursts
            )
            wq = np.where(sub, wq_er, wq)
        d = np.where(rho >= 1.0, np.inf, shat + float(tail_weight) * wq)
        if extra_delay is not None:
            d = d + extra_delay[mem]
        return d

    spent, remaining = 0.0, float(budget)

    # pre-phase: buy stability (rho < 1) for the most overloaded unit first
    while True:
        rho = lam * s / replicas
        i = int(np.argmax(rho))
        if rho[i] < 1.0 or cost[i] > remaining:
            break
        replicas[i] += 1
        remaining -= cost[i]
        spent += cost[i]

    members = [np.flatnonzero(grp == g) for g in np.unique(grp)]
    d = score(replicas)  # updated incrementally: a grant only moves its wave
    while True:
        best_wave, best_gain = None, 0.0
        for mem in members:
            dm = d[mem]
            mx = dm.max()
            if not np.isfinite(mx):
                in_wave = ~np.isfinite(dm)
            else:
                in_wave = dm >= 0.95 * mx
            wave = mem[in_wave]
            cst = float(cost[wave].sum())
            if cst > remaining:
                continue
            rest = dm[~in_wave].max() if (~in_wave).any() else -np.inf
            new_mx = max(float(score(replicas[wave] + 1, wave).max()), rest)
            gain = (mx - new_mx) / cst if np.isfinite(mx) else np.inf
            if gain > best_gain:
                best_gain, best_wave = gain, wave
        if best_wave is None:
            break
        replicas[best_wave] += 1
        cst = float(cost[best_wave].sum())
        remaining -= cst
        spent += cst
        d[best_wave] = score(replicas[best_wave], best_wave)
    return AllocationResult(replicas, score(replicas), spent, remaining)


def proportional_allocate(
    weight: np.ndarray,
    unit_cost: np.ndarray,
    budget: float,
) -> AllocationResult:
    """Allocate replicas proportional to ``weight`` (the prior-work policy):
    "weight-based" when ``weight`` = MACs per layer, "performance-based
    layer-wise" when it is expected cycles per layer.  Replica counts are
    the floor of the proportional share (>= 1), with any leftover budget
    distributed by largest fractional remainder."""
    weight = np.asarray(weight, dtype=np.float64)
    unit_cost = np.asarray(unit_cost, dtype=np.float64)
    n = weight.size
    replicas = np.ones(n, dtype=np.int64)
    if n == 0 or budget <= 0:
        return AllocationResult(replicas, weight / replicas, 0.0, float(budget))

    total_w = weight.sum()
    share = weight / total_w * float(budget)
    extra = np.floor(share / unit_cost).astype(np.int64)
    replicas = replicas + np.maximum(extra, 0)
    spent = float((extra * unit_cost).sum())
    remaining = float(budget) - spent
    # Largest-remainder top-up.
    frac = share / unit_cost - extra
    for i in np.argsort(-frac):
        if unit_cost[i] <= remaining:
            replicas[i] += 1
            remaining -= unit_cost[i]
            spent += unit_cost[i]
    latency = weight / replicas
    return AllocationResult(replicas, latency, spent, remaining)


def proportional_allocate_batch(
    weight: np.ndarray,
    unit_cost: np.ndarray,
    budgets: np.ndarray,
) -> BatchAllocationResult:
    """``proportional_allocate`` over C budgets, vectorized in numpy on the
    host; the result holds CPU tensors.

    Element-wise identical to looping the scalar routine: ``np.argsort(-frac,
    axis=1)`` applies the same introsort per row as the scalar's per-config
    call, so even unstable tie orders agree.  The largest-remainder top-up
    walks the N sorted positions lock-step across configs.
    """
    budgets = np.atleast_1d(np.asarray(budgets, dtype=np.float64))
    weight = np.atleast_1d(np.asarray(weight, dtype=np.float64))
    cost = np.atleast_1d(np.asarray(unit_cost, dtype=np.float64))
    C = budgets.shape[0]
    N = weight.shape[-1]
    weight = np.broadcast_to(weight, (C, N))
    cost = np.broadcast_to(cost, (C, N))
    replicas = np.ones((C, N), dtype=np.int64)
    if N == 0 or C == 0:
        return _host_result(replicas, weight / replicas, np.zeros(C), budgets.copy())

    act = budgets > 0  # scalar early-returns all-ones below/at zero budget
    total_w = weight.sum(axis=1)
    share = weight / total_w[:, None] * budgets[:, None]
    extra = np.where(act[:, None], np.floor(share / cost).astype(np.int64), 0)
    replicas = replicas + np.maximum(extra, 0)
    spent = (extra * cost).sum(axis=1)
    remaining = budgets - spent
    frac = share / cost - extra
    order = np.argsort(-frac, axis=1)
    rows = np.arange(C)
    for k in range(N):
        i = order[:, k]
        ci = cost[rows, i]
        ok = act & (ci <= remaining)
        replicas[rows[ok], i[ok]] += 1
        remaining = np.where(ok, remaining - ci, remaining)
        spent = np.where(ok, spent + ci, spent)
    return _host_result(replicas, weight / replicas, spent, remaining)


def _host_result(replicas, latency, spent, leftover) -> BatchAllocationResult:
    return BatchAllocationResult(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (replicas, latency, spent, leftover))
    )

"""Cost-based pipeline-stage partitioning — the paper's performance-based
layer-wise allocation applied to pipeline parallelism.

Prior-work analogue ("weight-based"): split L layers into P stages with
equal LAYER COUNTS.  Paper analogue ("performance-based"): split so that
per-stage COST (profiled per-layer step cost — FLOPs from the dry-run, or
measured step times) is balanced, because the pipeline runs at the speed of
the slowest stage.

On a multi-chip fabric every stage boundary is an inter-chip link, so a cut
is not free: the activations crossing it ride the link every microbatch.
``edge_cost[i]`` prices starting a stage at layer ``i`` (the transfer of
layer ``i``'s input across the boundary, in the same units as ``costs``) and
the DP charges it to the receiving stage — balanced cuts migrate off fat
activation edges onto thin ones.  ``edge_cost=None`` is the flat special
case, bit-identical to the classic partition.

`partition_stages` is the classic linear-partition DP (O(L^2 P)), exact.
Ported from the reference ``core/alloc/pipeline_stages.py`` (numpy, verbatim)."""

from __future__ import annotations

import numpy as np

__all__ = ["partition_stages", "stage_costs", "bottleneck"]


def partition_stages(
    costs: np.ndarray,
    n_stages: int,
    edge_cost: np.ndarray | None = None,
) -> list[tuple[int, int]]:
    """Split layers [0, L) into contiguous stages minimizing max stage cost.

    With ``edge_cost`` (length L; entry ``i`` = cost of cutting BEFORE layer
    ``i``, ``edge_cost[0]`` ignored — the first stage reads from the host),
    a stage [i, j) costs ``sum(costs[i:j]) + edge_cost[i]`` and the DP
    minimizes the communication-inclusive bottleneck.

    Returns [(start, end), ...] half-open ranges, len == n_stages."""
    costs = np.asarray(costs, dtype=np.float64)
    L = costs.size
    if edge_cost is None:
        if n_stages >= L:
            return [(i, i + 1) for i in range(L)] + [(L, L)] * (n_stages - L)
        edge = np.zeros(L)
        P = n_stages
    else:
        edge = np.asarray(edge_cost, dtype=np.float64)
        if edge.shape != (L,):
            raise ValueError(f"edge_cost has shape {edge.shape}, expected ({L},)")
        # with priced cuts, more stages than layers never helps; pad with
        # empty trailing stages instead of forcing degenerate cuts
        P = min(n_stages, L)
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def seg(i, j):  # cost of layers [i, j), plus the incoming transfer
        base = prefix[j] - prefix[i]
        return base + edge[i] if i > 0 else base

    # dp[p][j] = minimal bottleneck for first j layers in p stages
    dp = np.full((P + 1, L + 1), np.inf)
    cut = np.zeros((P + 1, L + 1), dtype=np.int64)
    dp[0][0] = 0.0
    for p in range(1, P + 1):
        for j in range(1, L + 1):
            for i in range(p - 1, j):
                val = max(dp[p - 1][i], seg(i, j))
                if val < dp[p][j]:
                    dp[p][j] = val
                    cut[p][j] = i
    # with priced cuts, FEWER nonempty stages can beat the full count (a fat
    # activation edge may cost more than the imbalance it relieves): take
    # the best p <= P and pad with empty trailing stages.  Without edge
    # costs dp[p][L] is non-increasing in p, so best == P and the classic
    # partition is returned unchanged.
    best = int(np.argmin(dp[1 : P + 1, L])) + 1 if edge_cost is not None else P
    # walk back
    bounds = []
    j = L
    for p in range(best, 0, -1):
        i = int(cut[p][j])
        bounds.append((i, j))
        j = i
    out = list(reversed(bounds))
    return out + [(L, L)] * (n_stages - best)


def stage_costs(costs: np.ndarray, stages: list[tuple[int, int]]) -> np.ndarray:
    costs = np.asarray(costs, dtype=np.float64)
    return np.asarray([costs[a:b].sum() for a, b in stages])


def bottleneck(costs: np.ndarray, stages: list[tuple[int, int]]) -> float:
    return float(stage_costs(costs, stages).max())

"""Pareto-frontier extraction over swept design points (a copy of the
reference's ``dse/pareto.py``, numpy on the host).

The co-design question the sweep answers is three-way: how many arrays you
must build (cost), the throughput you get, and how busy the arrays stay
(paper Figs 8 + 9).  A design point is on the frontier iff no other point is
at least as good on every objective and strictly better on one.
"""

from __future__ import annotations

import numpy as np

from .sweep import SweepResult

__all__ = [
    "pareto_mask",
    "pareto_frontier",
    "DEFAULT_OBJECTIVES",
    "FAULT_OBJECTIVES",
    "LATENCY_OBJECTIVES",
    "MULTICHIP_OBJECTIVES",
]

# (column, maximize?) — fewer arrays is better, more img/s and util are better
DEFAULT_OBJECTIVES = (
    ("arrays_total", False),
    ("images_per_sec", True),
    ("mean_utilization", True),
)

# serving-oriented frontier: what you serve, what users feel (tail latency at
# the design's operating load, from a sweep run with ``FabricEval``), and how
# busy the arrays stay
LATENCY_OBJECTIVES = (
    ("images_per_sec", True),
    ("p99_cycles", False),
    ("mean_utilization", True),
)

# scale-out frontier over ``run_multichip_sweep`` results: what you serve,
# what users feel with inter-chip transfers on the critical path, and how
# many chips you must package/interconnect (fewer is cheaper)
MULTICHIP_OBJECTIVES = (
    ("images_per_sec", True),
    ("p99_cycles", False),
    ("n_chips", False),
)

# fault-tolerance frontier over ``run_fault_sweep`` results: capacity that
# stays serviceable through failures (spares buy it), the tail users feel
# while degraded, and the arrays you must build (spares cost them) — the
# spare-fraction x failure-rate trade of the robustness PR
FAULT_OBJECTIVES = (
    ("availability", True),
    ("p99_cycles", False),
    ("arrays_total", False),
)


def pareto_mask(values: np.ndarray, maximize) -> np.ndarray:
    """(n, k) objective matrix -> (n,) bool mask of non-dominated points.

    ``maximize`` is a length-k sequence of bools; minimized objectives are
    sign-flipped.  Duplicate points are all kept (neither strictly
    dominates).  O(n^2 k) via broadcasting — fine for sweep-sized n.
    """
    v = np.asarray(values, dtype=np.float64)
    if v.ndim != 2:
        raise ValueError(f"expected (n, k) objectives, got shape {v.shape}")
    maximize = np.asarray(maximize, dtype=bool)
    if maximize.shape != (v.shape[1],):
        raise ValueError(f"maximize has {maximize.shape}, objectives k={v.shape[1]}")
    v = np.where(maximize[None, :], v, -v)
    # q dominates p: q >= p everywhere, q > p somewhere
    ge = (v[None, :, :] >= v[:, None, :]).all(axis=2)  # [p, q]
    gt = (v[None, :, :] > v[:, None, :]).any(axis=2)
    dominated = (ge & gt).any(axis=1)
    return ~dominated


def pareto_frontier(result: SweepResult, objectives=DEFAULT_OBJECTIVES) -> np.ndarray:
    """Indices of frontier points, sorted by the first objective.  Reads
    ``result.objectives(names)``."""
    names = tuple(n for n, _ in objectives)
    maximize = [m for _, m in objectives]
    vals = result.objectives(names)
    idx = np.flatnonzero(pareto_mask(vals, maximize))
    first = vals[idx, 0]
    order = np.argsort(-first if objectives[0][1] else first, kind="stable")
    return idx[order]

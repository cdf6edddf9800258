"""The frozen yardstick of VT's per-layer metrics: the critical-path bound,
the per-step price, the job-step count and the bytes, none of which any
change to the program may move.

Origin: ``critical_path`` and ``chain_weights`` are copies of
``src/repro_torch/kernels/vtime_scan.py`` as of PR 26 (accepted, commit
3c797f4).  The step price is PR 26's run 26-M on an NVIDIA H100 80GB HBM3
at 700 W: its one-thread probe of VT's dependent FP64 add + min chain read
22.4 cycles at the 1980 MHz ``clocks.max.sm``, and its critical paths read
4.648 ms for 410,024 steps (fabric_tail) and 17.263 ms for 1,522,969
(ResNet18's closed loop): 11.336 ns a step.  The records keep no reading of
the add alone, so every step is priced at the add + min; a layer whose
pools all hold one server chains at an add alone, and there the bound
reads a little high (PERF.md, Open questions).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "STEP_NS", "HBM_BYTES_PER_S", "critical_path", "chain_weights", "config_steps", "launch_bound_ns",
    "vt_bytes",
]

STEP_NS = 4.648e6 / 410_024  # one job's chain link, add + min, 26-M (11.336 ns)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def critical_path(jobs, n_requests: int, concurrency: int | None = None, weights=None) -> float:
    """The longest dependency path through one config's (request, layer)
    grid: T[r][l] = max(T[r-1][l], T[r][l-1], and for l = 0 in a closed loop
    T[r-conc][L-1]) + w_l, w_l = jobs[l] * weights[l] (``weights`` None:
    1, the path in job steps)."""
    w = np.asarray(jobs, dtype=np.float64) * (1.0 if weights is None else np.asarray(weights, dtype=np.float64))
    N, L = int(n_requests), len(w)
    if N == 0 or L == 0:
        return 0.0
    conc = None if concurrency is None else int(concurrency)
    if conc is None or conc >= N:
        return float(w.sum() + (N - 1) * w.max())
    W = np.cumsum(w)
    Wprev = np.concatenate([[0.0], W[:-1]])
    T, last = np.zeros(L), np.zeros(N)
    for r in range(N):
        A = T.copy() if r else np.zeros(L)
        if r >= conc:
            A[0] = max(A[0], last[r - conc])
        T = W + np.maximum.accumulate(A - Wprev)
        last[r] = T[-1]
    return float(T[-1])


def chain_weights(lanes, blocks, add_ns: float, add_min_ns: float) -> np.ndarray:
    """(C, L) the least time of one job's chain link a layer: an add alone
    when every pool of the layer has at most one server, else an add and a
    min."""
    lanes = np.asarray(lanes, dtype=np.int64)
    offs = np.cumsum(blocks) - np.asarray(blocks)
    one = np.stack([lanes[:, o : o + b].max(axis=1, initial=0) <= 1 for o, b in zip(offs, blocks)], axis=1)
    return np.where(one, float(add_ns), float(add_min_ns))


def config_steps(jobs, n_requests: int) -> int:
    """Job steps one config's inputs need: every layer's jobs, every
    request, one after another in its pools (N x sum_l jobs_l)."""
    return int(n_requests) * int(np.sum(jobs))


def launch_bound_ns(lanes, blocks, jobs, n_requests: int, concurrency: int | None = None) -> float:
    """A launch's critical-path bound: its longest config's path, every
    job priced at ``STEP_NS`` (the add alone is not in the records).
    ``lanes`` (C, pools) servers a pool, ``blocks`` pools a layer, ``jobs``
    (L,) or (C, L) jobs a request a layer."""
    lanes = np.asarray(lanes, dtype=np.int64)
    jobs = np.broadcast_to(np.asarray(jobs, dtype=np.int64), (lanes.shape[0], len(blocks)))
    w = chain_weights(lanes, blocks, STEP_NS, STEP_NS)
    keys = {(tuple(j), tuple(x)) for j, x in zip(jobs.tolist(), w.tolist())}
    return max(critical_path(j, n_requests, concurrency, x) for j, x in keys)


def vt_bytes(tables_elems: int, n_requests: int, jobs, configs: int, pools: int) -> int:
    """Bytes one VT launch must move at the least: its float64 tables, the
    int32 sample index of every job, each config's lanes and variant, its
    float64 arrivals read and completions written."""
    return 8 * int(tables_elems) + 4 * int(n_requests) * int(np.sum(jobs)) + 4 * configs * (pools + 1) \
        + 16 * configs * int(n_requests)

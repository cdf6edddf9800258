"""The fabric as an event engine in plain Python and NumPy: FIFO pools of
replicated servers, one request after another through every layer.

Each pool is one block (block-wise dataflow) or one layer (layer-wise: a
patch's job is the barrier ``max_b`` of its blocks' cycles, on pool 0).
When a request reaches a layer at time ``t``, every pool's server free
times are raised to ``t``, and the layer's patches, in order, each put one
job on the earliest-free server of every pool (start + service); the
request leaves the layer when its last job ends, and never before ``t``.
Requests cannot overtake each other, so one request after another is the
whole simulation.  A closed loop of ``concurrency`` clients admits request
``r`` when request ``r - concurrency`` completes (the first ones at 0).

Service times are the profiled per-(patch, block) cycles of a sampled row:
``default_rng(seed).integers(0, S_l, (N, ppi_l))`` layer after layer, one
draw shared by every configuration (the port's documented sampling).

``dtype=np.float32`` runs every add and compare in float32: the control,
one precision below the float64 the configuration states.
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["service_indices", "simulate", "percentiles", "poisson_times"]


def service_indices(seed: int, dims, n: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, s, size=(int(n), int(p))) for s, p in dims]


def poisson_times(seed: int, n: int, rate: float) -> np.ndarray:
    """Open-loop Poisson arrivals: cumulative exponential gaps of mean
    ``1 / rate`` cycles."""
    return np.cumsum(np.random.default_rng(seed).exponential(1.0 / rate, size=n))


def _pool64(free: list, t: float, svc: list) -> float:
    h = [f if f > t else t for f in free]
    last = t
    if len(h) == 1:
        e = h[0]
        for s in svc:
            e = e + s
        free[0] = e
        return e if e > last else last
    heapq.heapify(h)
    for s in svc:
        e = h[0] + s
        heapq.heapreplace(h, e)
        if e > last:
            last = e
    free[:] = h
    return last


def _pool32(free: list, t, svc) -> float:
    f32 = np.float32
    h = [f if f > t else t for f in free]
    last = t
    heapq.heapify(h)
    for s in svc:
        e = f32(h[0] + s)
        heapq.heapreplace(h, e)
        if e > last:
            last = e
    free[:] = h
    return last


def simulate(tables, lanes, idx, *, arrivals=None, concurrency=None, n=None, dtype=np.float64):
    """(arrival, completion) times (N,) of one configuration.

    ``tables``: per layer the (S, B) float64 cycles of this configuration's
    variant; ``lanes``: per layer the (B,) servers a pool (0: no pool);
    ``idx``: per layer (N, ppi) sampled rows; ``arrivals`` (N,) for an open
    loop, or ``concurrency`` and ``n`` for a closed one."""
    f32 = dtype == np.float32
    pool = _pool32 if f32 else _pool64
    cast = np.float32 if f32 else float
    N = int(n if arrivals is None else len(arrivals))
    layers = []
    for tab, ln in zip(tables, lanes):
        ln = np.asarray(ln, dtype=np.int64)
        tab = np.asarray(tab, dtype=np.float64)
        if f32:
            tab = tab.astype(np.float32)
        pools = [b for b in range(ln.size) if ln[b] > 0]
        layerwise = len(pools) == 1 and ln.size > 1 and ln[1:].sum() == 0
        layers.append((tab, pools, [[cast(0.0)] * int(ln[b]) for b in pools], layerwise))
    t_arr = np.zeros(N, dtype=dtype)
    comp = np.zeros(N, dtype=dtype)
    ring = [cast(0.0)] * (int(concurrency) if concurrency is not None else 1)
    for r in range(N):
        if concurrency is None:
            t = cast(arrivals[r])
        else:
            t = ring[r % int(concurrency)]
        t_arr[r] = t
        for (tab, pools, frees, layerwise), ix in zip(layers, idx):
            svc = tab[ix[r]]  # (P, B)
            if layerwise:
                svc = svc.max(axis=1, keepdims=True)
            done = t
            for k, b in enumerate(pools):
                col = svc[:, 0 if layerwise else b]
                e = pool(frees[k], t, col if f32 else col.tolist())
                if e > done:
                    done = e
            t = done
        comp[r] = t
        if concurrency is not None:
            ring[r % int(concurrency)] = t
    return t_arr, comp


def percentiles(t_arr, comp, qs=(50.0, 95.0, 99.0)) -> np.ndarray:
    """Linear-interpolation percentiles of the latencies (``np.percentile``'s
    default), computed in the times' own type and read out in float64."""
    lat = np.asarray(comp) - np.asarray(t_arr)
    if lat.dtype == np.float64:
        return np.percentile(lat, qs)
    s = np.sort(lat)
    h = (s.size - 1) * np.asarray(qs, dtype=np.float64) / 100.0
    lo = np.floor(h).astype(np.int64)
    hi = np.minimum(lo + 1, s.size - 1)
    frac = (h - lo).astype(lat.dtype)
    return (s[lo] + frac * (s[hi] - s[lo])).astype(np.float64)

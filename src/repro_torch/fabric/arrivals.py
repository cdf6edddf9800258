"""Request arrival processes for the fabric runtime.

Copied from the reference ``fabric/arrivals.py`` (numpy only).

Three shapes cover the serving scenarios we care about:

  * ``ClosedLoop``   — a fixed population of in-flight requests; a completed
                       request is immediately replaced (throughput mode —
                       this is the regime the analytic model's steady-state
                       pipelined throughput describes).
  * ``PoissonOpen``  — open-loop Poisson arrivals at a target rate,
                       independent of completions (tail-latency mode).
  * ``TraceReplay``  — explicit arrival timestamps, e.g. recorded traffic.

Fleet traces add two non-stationary open-loop generators so diurnal /
bursty workloads don't have to be hand-built:

  * ``SinusoidalPoisson`` — inhomogeneous Poisson with a sinusoidal rate
                       (the diurnal load curve), sampled exactly by
                       thinning a homogeneous process at the peak rate.
  * ``MMPP2``        — 2-state Markov-modulated Poisson process (quiet /
                       burst), the standard bursty-traffic model.

Times are in fabric clock cycles throughout; convert at the edges.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "ClosedLoop",
    "MMPP2",
    "PoissonOpen",
    "SinusoidalPoisson",
    "TraceReplay",
    "arrival_times",
]


@dataclass(frozen=True)
class ClosedLoop:
    n_requests: int
    concurrency: int = 8


@dataclass(frozen=True)
class PoissonOpen:
    n_requests: int
    rate_per_cycle: float  # mean arrivals per clock cycle
    seed: int = 0

    @staticmethod
    def from_ips(n_requests: int, ips: float, clock_hz: float, seed: int = 0) -> "PoissonOpen":
        return PoissonOpen(n_requests, ips / clock_hz, seed)


@dataclass(frozen=True)
class TraceReplay:
    times: np.ndarray  # (N,) nondecreasing arrival times in cycles


@dataclass(frozen=True)
class SinusoidalPoisson:
    """Diurnal traffic: inhomogeneous Poisson with rate
    ``base_rate * (1 + amplitude * sin(2*pi*t/period + phase))``.

    Sampled exactly by thinning a homogeneous Poisson process at the peak
    rate — no discretization, seeded, nondecreasing by construction.
    """

    n_requests: int
    base_rate: float  # mean arrivals per cycle, averaged over a period
    period: float  # cycles per diurnal cycle
    amplitude: float = 0.5  # 0 (flat) .. 1 (rate touches zero at trough)
    phase: float = 0.0
    seed: int = 0


@dataclass(frozen=True)
class MMPP2:
    """Bursty traffic: 2-state Markov-modulated Poisson process.

    The process alternates exponentially-distributed sojourns in a quiet
    state (``rate0``) and a burst state (``rate1``); within each sojourn
    arrivals are Poisson at that state's rate (sampled exactly: Poisson
    count + sorted uniform order statistics per sojourn).
    """

    n_requests: int
    rate0: float  # arrivals per cycle in the quiet state
    rate1: float  # arrivals per cycle in the burst state
    mean_sojourn0: float  # cycles, mean dwell in the quiet state
    mean_sojourn1: float  # cycles, mean dwell in the burst state
    seed: int = 0


ArrivalProcess = ClosedLoop | PoissonOpen | TraceReplay | SinusoidalPoisson | MMPP2


def _sinusoidal_times(p: SinusoidalPoisson) -> np.ndarray:
    if not p.base_rate > 0:
        raise ValueError(f"base_rate must be positive, got {p.base_rate}")
    if not 0.0 <= p.amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {p.amplitude}")
    if not p.period > 0:
        raise ValueError(f"period must be positive, got {p.period}")
    rng = np.random.default_rng(p.seed)
    n = int(p.n_requests)
    peak = p.base_rate * (1.0 + p.amplitude)
    out = np.empty(n)
    got, t = 0, 0.0
    while got < n:
        m = max(1024, 2 * (n - got))
        cand = t + np.cumsum(rng.exponential(1.0 / peak, size=m))
        rate = p.base_rate * (
            1.0 + p.amplitude * np.sin(2.0 * np.pi * cand / p.period + p.phase)
        )
        keep = cand[rng.random(m) * peak < rate]
        k = min(keep.size, n - got)
        out[got : got + k] = keep[:k]
        got += k
        t = float(cand[-1])
    return out


def _mmpp2_times(p: MMPP2) -> np.ndarray:
    if p.rate0 < 0 or p.rate1 < 0 or (p.rate0 == 0 and p.rate1 == 0):
        raise ValueError(f"MMPP2 needs nonnegative rates, not both zero: {p.rate0}, {p.rate1}")
    if not (p.mean_sojourn0 > 0 and p.mean_sojourn1 > 0):
        raise ValueError("MMPP2 mean sojourns must be positive")
    rng = np.random.default_rng(p.seed)
    n = int(p.n_requests)
    rates = (p.rate0, p.rate1)
    sojourns = (p.mean_sojourn0, p.mean_sojourn1)
    chunks, got, t, state = [], 0, 0.0, 0
    while got < n:
        dur = float(rng.exponential(sojourns[state]))
        lam = rates[state]
        k = int(rng.poisson(lam * dur)) if lam > 0 and dur > 0 else 0
        if k:
            chunks.append(t + np.sort(rng.random(k)) * dur)
            got += k
        t += dur
        state ^= 1
    return np.concatenate(chunks)[:n]


def arrival_times(proc: ArrivalProcess) -> np.ndarray | None:
    """Explicit arrival times for open-loop processes; None for closed-loop
    (closed-loop admissions depend on completions and are resolved by the
    engine).

    Edge cases are part of the contract: an empty trace is a legal zero-
    request workload; duplicate timestamps (simultaneous arrivals, recorded
    bursts) are legal and dispatch in request order; a time running
    *backwards* is a data error and is rejected with the first offending
    position.
    """
    if isinstance(proc, ClosedLoop):
        return None
    if isinstance(proc, PoissonOpen):
        if not proc.rate_per_cycle > 0:
            raise ValueError(
                f"PoissonOpen rate_per_cycle must be positive, got {proc.rate_per_cycle}"
            )
        rng = np.random.default_rng(proc.seed)
        gaps = rng.exponential(1.0 / proc.rate_per_cycle, size=proc.n_requests)
        return np.cumsum(gaps)
    if isinstance(proc, SinusoidalPoisson):
        return _sinusoidal_times(proc)
    if isinstance(proc, MMPP2):
        return _mmpp2_times(proc)
    if isinstance(proc, TraceReplay):
        t = np.asarray(proc.times, dtype=np.float64)
        if t.ndim != 1:
            raise ValueError(f"trace times must be 1-D, got shape {t.shape}")
        bad = np.flatnonzero(np.diff(t) < 0)
        if bad.size:
            i = int(bad[0]) + 1
            raise ValueError(
                f"trace times must be nondecreasing: times[{bad[0]}]={t[bad[0]]} "
                f"> times[index {i}]={t[i]}"
            )
        return t
    raise TypeError(f"unknown arrival process {proc!r}")

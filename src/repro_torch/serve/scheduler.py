"""Static vs continuous batching: the paper's barrier analysis for serving
(a copy of the reference's ``src/repro/serve/scheduler.py``; numpy only).

Static batching: B requests start together; the batch completes when the
LONGEST generation finishes (the synchronization barrier; utilization =
mean(len)/max(len), the exact shape of the paper's Fig 6 block-skew loss).

Continuous batching: a finished slot refills from the queue on the next
step (the paper's "send work to the next available block").

``simulate_*`` are analytic slot-step counters (the serving counterpart of
``core/cim/simulate.py``); the slot engine (``serve/engine.py``) is the
runnable counterpart.

``fabric_slot_plan`` scales each allocation's decode batch from the tail
latency a fabric replay reports, so the fabric stays inside its latency
SLO: slots above the plan sit dormant (``reset_slots``) until a
re-allocation earns them back.  ``brownout_plan`` is the failure-mode
counterpart: when post-failure capacity cannot meet the p99 SLO at the
offered load, it computes the admission fraction that sheds just enough
load to keep the queues from diverging.  (The fabric replay and the failure
model themselves come with the fabric slice, ROADMAP.md.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "WorkloadConfig",
    "brownout_plan",
    "fabric_slot_plan",
    "sample_lengths",
    "simulate_static",
    "simulate_continuous",
    "BatchingStats",
]


@dataclass(frozen=True)
class WorkloadConfig:
    n_requests: int = 256
    mean_len: float = 128.0
    dist: str = "lognormal"  # request generation-length distribution
    sigma: float = 0.8
    seed: int = 0


def sample_lengths(cfg: WorkloadConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    if cfg.dist == "lognormal":
        mu = np.log(cfg.mean_len) - cfg.sigma**2 / 2
        out = rng.lognormal(mu, cfg.sigma, cfg.n_requests)
    elif cfg.dist == "uniform":
        out = rng.uniform(1, 2 * cfg.mean_len, cfg.n_requests)
    else:
        raise ValueError(cfg.dist)
    return np.maximum(out.astype(np.int64), 1)


def fabric_slot_plan(
    p99_cycles, slo_cycles: float, n_slots: int, min_slots: int = 1
) -> np.ndarray:
    """Per-allocation decode slot budget from replayed tail latency.

    First-order admission control: an allocation whose replayed p99 exceeds
    the SLO is oversubscribed, and shrinking its decode batch shrinks its
    offered load proportionally — so grant ``floor(n_slots * slo / p99)``
    slots (clipped to ``[min_slots, n_slots]``); allocations inside the SLO
    keep the full batch.  Configs with no traffic (p99 = 0) keep full slots.
    """
    if not slo_cycles > 0:
        raise ValueError(f"slo_cycles must be positive, got {slo_cycles}")
    if not 1 <= min_slots <= n_slots:
        raise ValueError(
            f"need 1 <= min_slots <= n_slots, got {min_slots}, {n_slots}"
        )
    p99 = np.asarray(p99_cycles, dtype=np.float64)
    frac = np.where(p99 > 0, np.minimum(slo_cycles / np.maximum(p99, 1e-300), 1.0), 1.0)
    return np.clip(np.floor(n_slots * frac), min_slots, n_slots).astype(np.int64)


def brownout_plan(
    offered_rps,
    capacity_rps,
    p99_cycles,
    slo_cycles: float,
    min_admit_frac: float = 0.05,
) -> np.ndarray:
    """Admission fraction under degraded capacity (graceful brownout).

    Two first-order pressure signals, take the tighter:

      * stability — admitting more than ``capacity_rps`` makes queues grow
        without bound, so cap admission at ``capacity / offered``;
      * tail SLO — replayed p99 scales roughly with admitted load near
        saturation, so scale admission by ``slo / p99`` when the measured
        p99 already exceeds the SLO.

    Vectorized over allocations like ``fabric_slot_plan``; no traffic
    (``offered_rps == 0``) or no latency signal (``p99 == 0``) admits 1.0.
    ``min_admit_frac`` keeps a trickle flowing even under extreme loss so
    recovery is observable (and no tenant is fully blacked out).  Returns
    the fraction of offered load to admit, in ``[min_admit_frac, 1]`` —
    shedding loses throughput by construction; it buys bounded queues and a
    defended p99.
    """
    if not slo_cycles > 0:
        raise ValueError(f"slo_cycles must be positive, got {slo_cycles}")
    if not 0.0 < min_admit_frac <= 1.0:
        raise ValueError(
            f"min_admit_frac must be in (0, 1], got {min_admit_frac}"
        )
    offered = np.asarray(offered_rps, dtype=np.float64)
    cap = np.asarray(capacity_rps, dtype=np.float64)
    p99 = np.asarray(p99_cycles, dtype=np.float64)
    if np.any(offered < 0) or np.any(cap < 0):
        raise ValueError("offered_rps and capacity_rps must be nonnegative")
    stab = np.where(offered > 0, cap / np.maximum(offered, 1e-300), np.inf)
    tail = np.where(p99 > 0, slo_cycles / np.maximum(p99, 1e-300), np.inf)
    frac = np.minimum(np.minimum(stab, tail), 1.0)
    return np.clip(frac, min_admit_frac, 1.0)


@dataclass(frozen=True)
class BatchingStats:
    total_steps: int
    slot_steps_used: int
    slot_steps_alloc: int
    mean_latency: float

    @property
    def utilization(self) -> float:
        return self.slot_steps_used / self.slot_steps_alloc

    @property
    def throughput(self) -> float:
        """completed tokens per slot-step."""
        return self.slot_steps_used / self.total_steps


def simulate_static(lengths: np.ndarray, n_slots: int) -> BatchingStats:
    total, used, lat = 0, 0, []
    for i in range(0, lengths.size, n_slots):
        batch = lengths[i : i + n_slots]
        steps = int(batch.max())
        total += steps
        used += int(batch.sum())
        lat.extend((total - steps + batch).tolist())  # finish times
    return BatchingStats(total, used, total * n_slots, float(np.mean(lat)))


def simulate_continuous(lengths: np.ndarray, n_slots: int) -> BatchingStats:
    """Event simulation: each step every busy slot decodes one token;
    empty slots refill from the queue immediately."""
    remaining = list(lengths[::-1])
    slots = np.zeros(n_slots, dtype=np.int64)  # tokens left per slot
    t, used, lat = 0, 0, []
    active = 0
    while remaining or active:
        for s in range(n_slots):
            if slots[s] == 0 and remaining:
                slots[s] = remaining.pop()
                active += 1
        busy = slots > 0
        if not busy.any():
            break
        slots[busy] -= 1
        used += int(busy.sum())
        t += 1
        done = busy & (slots == 0)
        for _ in range(int(done.sum())):
            lat.append(t)
            active -= 1
    return BatchingStats(t, used, t * n_slots, float(np.mean(lat)))

"""Load-aware expert replication: the paper's block-wise allocation applied
to MoE experts (reference: ``src/repro/core/alloc/expert.py``, copied).

An expert is a block of weights; the tokens routed to it are its
data-dependent service time; the capacity buffer is the barrier.  As in the
paper: (1) profile the expert-selection histogram, (2) run the same greedy
(``greedy_allocate``, highest expected latency first) to grant replicas
under a physical-slot budget, (3) dispatch each token round-robin over its
expert's replicas (``models.layers.moe_fwd``).

numpy on the host, as in the reference; ``greedy_allocate`` is the port's
own copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .greedy import greedy_allocate

__all__ = [
    "ReplicationPlan",
    "plan_replication",
    "profile_expert_histogram",
    "expected_max_load",
    "drop_rate",
]


@dataclass(frozen=True)
class ReplicationPlan:
    replication: tuple[int, ...]  # replicas per logical expert
    n_physical: int
    histogram: np.ndarray  # normalized load per logical expert
    slot_load: np.ndarray  # expected load per physical slot

    @property
    def max_slot_load(self) -> float:
        return float(self.slot_load.max())

    @property
    def balance(self) -> float:
        """mean/max slot load: 1.0 = perfectly balanced (full utilization)."""
        return float(self.slot_load.mean() / self.slot_load.max())


def profile_expert_histogram(router_logits: np.ndarray, top_k: int) -> np.ndarray:
    """Selection frequencies from profiled router logits (N, E)."""
    n, e = router_logits.shape
    idx = np.argsort(-router_logits, axis=-1)[:, :top_k]
    hist = np.bincount(idx.reshape(-1), minlength=e).astype(np.float64)
    return hist / hist.sum()


def plan_replication(
    histogram: np.ndarray,
    slot_budget: int,
    *,
    pad_to: int | None = None,
) -> ReplicationPlan:
    """Greedy replica grants: expected slot latency = hist_e / replicas_e.

    slot_budget: total physical slots available (>= n_experts).
    pad_to: if set, force the final slot count to exactly this value
      (mesh divisibility); leftover grants keep going to the current
      slowest expert even past the greedy stopping rule.
    """
    hist = np.asarray(histogram, dtype=np.float64)
    e = hist.size
    if slot_budget < e:
        raise ValueError(f"budget {slot_budget} < experts {e}")
    target = pad_to if pad_to is not None else slot_budget
    if target < e:
        raise ValueError(f"pad_to {target} < experts {e}")
    res = greedy_allocate(hist, np.ones(e), budget=target - e)
    repl = res.replicas.copy()
    while repl.sum() < target:
        repl[np.argmax(hist / repl)] += 1
    slot_load = np.concatenate([np.full(r, h / r) for h, r in zip(hist, repl)])
    return ReplicationPlan(tuple(int(r) for r in repl), int(repl.sum()), hist, slot_load)


def _slot_probs(plan_or_hist) -> np.ndarray:
    if isinstance(plan_or_hist, ReplicationPlan):
        probs = plan_or_hist.slot_load
    else:
        probs = np.asarray(plan_or_hist, dtype=np.float64)
    return probs / probs.sum()


def expected_max_load(plan_or_hist, n_tokens: int, top_k: int, rng=None, trials: int = 32) -> float:
    """Monte-Carlo E[max slot tokens] for a routing distribution: the
    barrier cost in the paper's terms (everyone waits for the slowest)."""
    probs = _slot_probs(plan_or_hist)
    rng = rng or np.random.default_rng(0)
    draws = rng.multinomial(n_tokens * top_k, probs, size=trials)
    return float(draws.max(axis=1).mean())


def drop_rate(plan_or_hist, n_tokens: int, top_k: int, capacity_factor: float, rng=None, trials: int = 32) -> float:
    """Fraction of routed assignments dropped at a given capacity factor."""
    probs = _slot_probs(plan_or_hist)
    n_slots = probs.size
    cap = int(np.ceil(n_tokens * top_k / n_slots * capacity_factor))
    rng = rng or np.random.default_rng(0)
    draws = rng.multinomial(n_tokens * top_k, probs, size=trials)
    dropped = np.maximum(draws - cap, 0).sum(axis=1)
    return float(dropped.mean() / (n_tokens * top_k))

"""Input-distribution drift: detection + online re-allocation.

The paper's allocation is computed against an offline profile ("Counting
Cards" makes the case that real input statistics move); when live inputs are
denser than profiled, the blocks sized for the old distribution become the
bottleneck.  The monitor keeps an EWMA of observed per-block mean cycles and
compares it to the profiled expectation; when the worst relative divergence
crosses a threshold it re-runs the paper's greedy allocator *warm-started
from the live replica state* (``greedy_allocate(initial_replicas=...)``)
against a held-back reserve of arrays, then charges an explicit stall while
the new replicas are programmed.

Growth-only by design: already-programmed replicas are never torn down
mid-serve (reprogramming eNVM costs far more than leaving a replica hot),
which is exactly the warm-start invariant the allocator's
``initial_replicas`` path provides.

Ported from the reference ``fabric/drift.py``: the monitor and the
re-allocation run on the host in numpy, as there; ``shift_profile`` builds
the port's ``LayerProfile`` tensors (float64 cycles on the profile's
device, the scaling and clipping done in numpy with the reference's ops).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.alloc.greedy import greedy_allocate
from ..core.cim.network import NetworkSpec
from ..core.cim.profile import LayerProfile, NetworkProfile
from ..core.cim.simulate import blockwise_units
from .metrics import ReallocationEvent

__all__ = ["DriftConfig", "OnlineReallocator", "shift_profile"]


@dataclass(frozen=True)
class DriftConfig:
    alpha: float = 0.25  # EWMA weight for a new per-block observation
    threshold: float = 0.20  # worst relative divergence that trips realloc
    warmup_observations: int = 96  # stage-visits before the EWMA is trusted
    cooldown_observations: int = 48  # stage-visits between reallocations
    program_cycles_per_array: float = 2048.0  # eNVM write time for one array
    parallel_writes: int = 64  # arrays programmed concurrently (per-PE ports)

    def stall(self, arrays_added: int) -> float:
        batches = -(-arrays_added // self.parallel_writes)
        return self.program_cycles_per_array * batches


class OnlineReallocator:
    """Watches one FabricSim's block-wise stages and grows replicas from a
    reserve budget when the observed cycle distribution drifts."""

    def __init__(self, spec: NetworkSpec, prof: NetworkProfile, reserve_arrays: float, cfg: DriftConfig = DriftConfig()):
        self.spec = spec
        self.cfg = cfg
        self.budget = float(reserve_arrays)
        self.expected = [_host(lp.mean_cycles) for lp in prof.layers]
        self.ewma = [e.copy() for e in self.expected]
        self.events: list[ReallocationEvent] = []
        self._sim = None
        self._obs = 0
        self._last_realloc_obs = 0
        self._min_cost = min(l.arrays_per_block for l in spec.layers)

    def bind(self, sim) -> None:
        self._sim = sim

    @property
    def divergence(self) -> float:
        worst = 0.0
        for e, w in zip(self.expected, self.ewma):
            d = float(np.max(np.abs(w - e) / np.maximum(e, 1e-9)))
            if d > worst:
                worst = d
        return worst

    def observe(self, layer_idx: int, block_means: np.ndarray, t: float) -> None:
        a = self.cfg.alpha
        self.ewma[layer_idx] = (1 - a) * self.ewma[layer_idx] + a * block_means
        self._obs += 1
        if (
            self._obs >= self.cfg.warmup_observations
            and self._obs - self._last_realloc_obs >= self.cfg.cooldown_observations
            and self.budget >= self._min_cost
            and self.divergence > self.cfg.threshold
        ):
            self._reallocate(t)

    def _reallocate(self, t: float) -> None:
        current = self._sim.current_block_dups()
        base_lat, cost = blockwise_units(self.spec, self.ewma)
        res = greedy_allocate(base_lat, cost, self.budget, initial_replicas=current)
        added = res.replicas - current
        arrays_added = int((added * cost).sum())
        self._last_realloc_obs = self._obs
        if arrays_added == 0:
            # Reserve can't afford the slowest block (greedy's stopping rule),
            # so the same EWMA would add 0 again next cooldown too: absorb the
            # drift into the baseline instead of re-running a futile greedy
            # pass forever.  A *further* shift still re-arms the monitor.
            self.expected = [w.copy() for w in self.ewma]
            return
        self.budget -= res.spent
        stall = self.cfg.stall(arrays_added)
        self._sim.apply_growth(added, t + stall)
        tripped_at = self.divergence
        # re-baseline: the live distribution is the new expectation, so the
        # monitor arms against *further* drift instead of re-tripping
        self.expected = [w.copy() for w in self.ewma]
        self.events.append(ReallocationEvent(t, stall, arrays_added, tripped_at))

    @property
    def stall_cycles(self) -> float:
        return sum(e.stall_cycles for e in self.events)


def _host(t) -> np.ndarray:
    """A profile tensor as a float64 numpy array on the host."""
    return t.detach().to("cpu", torch.float64).numpy().copy()


def shift_profile(prof: NetworkProfile, layer_scale: dict[int, float]) -> NetworkProfile:
    """A drifted copy of ``prof``: per-patch cycles of layer ``i`` scaled by
    ``layer_scale[i]`` (denser inputs -> more '1' bits -> more reads), clipped
    to the physical range [min reads, all-rows-read baseline] per block."""
    layers: list[LayerProfile] = []
    for i, lp in enumerate(prof.layers):
        k = layer_scale.get(i)
        if k is None:
            layers.append(lp)
            continue
        dev = lp.cycles_sample.device
        cyc = lp.cycles_sample.detach().cpu().numpy()
        hi = _host(lp.baseline_block_cycles)[None, :]
        lo = np.min(cyc, axis=0, keepdims=True).astype(np.float64)
        samp = np.clip(cyc * k, lo, hi)
        dens = np.minimum(_host(lp.block_density) * k, 1.0)
        layers.append(
            replace(
                lp,
                cycles_sample=torch.from_numpy(samp).to(dev),
                mean_cycles=torch.from_numpy(samp.mean(axis=0)).to(dev),
                block_density=torch.from_numpy(dens).to(dev),
            )
        )
    return NetworkProfile(prof.network, tuple(layers))

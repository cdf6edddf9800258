"""Allocation policies + pipelined-throughput simulator (Sections III & V).

The paper's Figure 8 policies:

  * ``baseline``        — zero-skipping OFF, arrays allocated by MACs.
  * ``weight_based``    — zero-skipping ON, arrays allocated by MACs,
                          layer-wise dataflow.
  * ``perf_layerwise``  — zero-skipping ON, arrays allocated greedily by
                          expected layer latency, layer-wise dataflow.
  * ``blockwise``       — zero-skipping ON, arrays allocated greedily by
                          expected *block* latency, block-wise dataflow
                          (the paper's contribution).
  * ``weight_blockflow``— ablation: weight-based allocation, block-wise
                          dataflow.

Dataflow model (steady-state pipelined throughput), for N images:
  layer-wise  T_l = max( sum_p max_b c[p,b] / d_l ,  max_p max_b c[p,b] )
  block-wise  T_l = max_b max( sum_p c[p,b] / d_b ,  max_p c[p,b] )
and T = max_l T_l.  Utilization = busy array-cycles / (arrays alive x T).

``latency_aware`` (the serving extension, block-wise dataflow) grants
replicas by marginal queueing-delay reduction at a target offered load
(``core.alloc.greedy.queueing_allocate``; ``fabric.vtime`` measures and
refines it).  It needs an offered load, so sweeps take it explicitly
(``ALL_POLICIES``).

The profile is packed once (``pack_profile``) into float64 tensors on its
device; ``_eval_kernel`` evaluates one allocation (``simulate``) or a batch
of them (``BatchSimulator``) with the same tensor algebra.  The greedy
allocation loops run on the host (``core.alloc.greedy``).  Every mean is an
explicit sum over a count: a sum of integer cycle counts is exact in
float64 in any order, and the division is then the reference's.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch

from ..alloc.greedy import greedy_allocate, proportional_allocate, queueing_allocate
from .network import NetworkSpec
from .profile import NetworkProfile

__all__ = [
    "Policy",
    "POLICIES",
    "ALL_POLICIES",
    "Allocation",
    "SimResult",
    "SimTensors",
    "BatchSimResult",
    "BatchSimulator",
    "allocate",
    "pack_profile",
    "simulate",
    "run_policy",
    "blockwise_units",
    "split_block_dups",
]

Policy = Literal[
    "baseline",
    "weight_based",
    "perf_layerwise",
    "blockwise",
    "weight_blockflow",
    "latency_aware",
]
POLICIES: tuple[Policy, ...] = (
    "baseline",
    "weight_based",
    "perf_layerwise",
    "blockwise",
    "weight_blockflow",
)
# the Fig 8 policies; "latency_aware" also needs an offered load
ALL_POLICIES: tuple[Policy, ...] = POLICIES + ("latency_aware",)
ARRAYS_PER_PE = 64
CLOCK_HZ = 100e6


@dataclass(frozen=True)
class Allocation:
    policy: Policy
    layer_dups: np.ndarray | None  # (L,) for layer-wise policies
    block_dups: list[np.ndarray] | None  # per-layer (B_l,) for block-wise dataflow
    arrays_used: int
    arrays_total: int


@dataclass(frozen=True)
class SimResult:
    policy: Policy
    total_cycles: float
    images_per_sec: float
    layer_cycles: torch.Tensor  # (L,) per-layer makespan for the batch
    layer_utilization: torch.Tensor  # (L,) busy / (arrays x T)
    arrays_used: int

    @property
    def mean_utilization(self) -> float:
        u = self.layer_utilization
        return float(u.sum() / u.numel())


def _layer_patch_cycles(prof: NetworkProfile, zskip: bool) -> list[np.ndarray]:
    """Per-layer (S, B) per-patch per-block cycle samples as float64 numpy
    on the host, the fabric engines' and the queueing allocator's input
    (integer cycles convert exactly)."""
    out = []
    for lp in prof.layers:
        if zskip:
            out.append(lp.cycles_sample.detach().to("cpu", torch.float64).numpy())
        else:
            base = lp.baseline_block_cycles.detach().to("cpu", torch.float64).numpy()
            out.append(np.broadcast_to(base, (lp.cycles_sample.shape[0], base.size)).copy())
    return out


def blockwise_units(
    spec: NetworkSpec, block_mean_cycles: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """Flattened per-block (base_latency, replica_cost) for greedy allocation,
    from per-layer (B_l,) expected cycles per patch."""
    base_lat, cost = [], []
    for i, layer in enumerate(spec.layers):
        mean_b = np.asarray(block_mean_cycles[i], dtype=np.float64)
        ppi = float(layer.patches_per_image)
        for b in range(layer.n_blocks):
            base_lat.append(mean_b[b] * ppi)
            cost.append(layer.arrays_per_block)
    return np.asarray(base_lat), np.asarray(cost, dtype=np.float64)


def split_block_dups(spec: NetworkSpec, replicas: np.ndarray) -> list[np.ndarray]:
    """Inverse of ``blockwise_units``'s flattening: per-layer (B_l,) replica
    arrays from the flat per-block vector."""
    out, k = [], 0
    for layer in spec.layers:
        out.append(np.asarray(replicas[k : k + layer.n_blocks]).copy())
        k += layer.n_blocks
    return out


def allocate(
    spec: NetworkSpec,
    prof: NetworkProfile,
    policy: Policy,
    n_pes: int,
    arrays_per_pe: int = ARRAYS_PER_PE,
    free_budget: float | None = None,
    offered_ips: float | None = None,
    load_frac: float = 0.7,
    audit=None,
) -> Allocation:
    """Pick replica counts.  ``free_budget`` caps the arrays spent on extra
    replicas below the physical ``total - base``.

    The ``latency_aware`` policy needs a target offered load:
    ``offered_ips`` (images/sec), or, when omitted, ``load_frac`` times the
    analytic throughput of the ``blockwise`` allocation at the same budget.
    ``audit`` (an ``obs.AllocationAudit``) records the greedy policies'
    per-grant decision log (``perf_layerwise`` / ``blockwise``); the other
    policies leave it empty."""
    total = n_pes * arrays_per_pe
    base_arrays = spec.n_arrays
    if total < base_arrays:
        raise ValueError(f"{total} arrays < minimum {base_arrays} for {spec.name}")
    free = total - base_arrays
    if free_budget is not None:
        if not 0 <= free_budget <= free:
            raise ValueError(
                f"free_budget {free_budget} outside [0, {free}] free arrays"
            )
        free = float(free_budget)
    layer_arrays = np.array([l.n_arrays for l in spec.layers], dtype=np.float64)

    if policy in ("baseline", "weight_based", "weight_blockflow"):
        macs = np.array([l.macs_per_image for l in spec.layers], dtype=np.float64)
        res = proportional_allocate(macs, layer_arrays, free)
        dups = res.replicas
        used = int(base_arrays + (res.replicas - 1) @ layer_arrays)
        if policy == "weight_blockflow":
            # same replica budget per layer, but blocks dispatch independently
            block_dups = [
                np.full(l.n_blocks, dups[i], dtype=np.int64)
                for i, l in enumerate(spec.layers)
            ]
            return Allocation(policy, None, block_dups, used, total)
        return Allocation(policy, dups, None, used, total)

    st = pack_profile(spec, prof)
    if policy == "perf_layerwise":
        # expected per-layer latency with one duplicate: patches x E[max_b c]
        exp_lat = (st.pm_mean[1] * st.ppi).cpu().numpy()
        res = greedy_allocate(exp_lat, layer_arrays, free, audit=audit)
        used = int(base_arrays + (res.replicas - 1) @ layer_arrays)
        return Allocation(policy, res.replicas, None, used, total)

    if policy == "blockwise":
        # one unit per block across the whole network
        base_lat, cost = blockwise_units(spec, _block_means(spec, st))
        res = greedy_allocate(base_lat, cost, free, audit=audit)
        block_dups = split_block_dups(spec, res.replicas)
        used = int(base_arrays + ((res.replicas - 1) * cost).sum())
        return Allocation(policy, None, block_dups, used, total)

    if policy == "latency_aware":
        if offered_ips is None:
            bw = allocate(spec, prof, "blockwise", n_pes, arrays_per_pe, free_budget)
            offered_ips = load_frac * simulate(spec, prof, bw).images_per_sec
        if offered_ips <= 0:
            raise ValueError(f"offered_ips must be positive, got {offered_ips}")
        r_cyc = float(offered_ips) / CLOCK_HZ  # images per fabric cycle
        cyc = _layer_patch_cycles(prof, True)
        job_rate, mean, scv, cost, batch, group = _queueing_inputs(spec, cyc, r_cyc)
        res = queueing_allocate(job_rate, mean, scv, cost, free, batch_size=batch, group=group)
        block_dups = split_block_dups(spec, res.replicas)
        used = int(base_arrays + ((res.replicas - 1) * cost).sum())
        return Allocation(policy, None, block_dups, used, total)

    raise ValueError(policy)


def _queueing_inputs(spec: NetworkSpec, cyc, r_cyc: float):
    """Per-block queueing-model inputs for ``latency_aware``, flat over all
    blocks: (job_rate, mean, scv, cost, batch, group).  Every patch of layer
    ``l`` brings one job to each of its blocks, so a pool's job rate is
    ``r * patches/image`` in request batches of ``patches_per_image``; a
    layer (one pipeline stage) is a group.  numpy on the host, the
    reference's arithmetic."""
    mean, scv, job_rate, cost, batch, group = [], [], [], [], [], []
    for i, layer in enumerate(spec.layers):
        m = cyc[i].mean(axis=0)
        v = cyc[i].var(axis=0)
        mean.append(m)
        scv.append(v / np.maximum(m, 1e-300) ** 2)
        job_rate.append(np.full(layer.n_blocks, r_cyc * layer.patches_per_image))
        cost.append(np.full(layer.n_blocks, float(layer.arrays_per_block)))
        batch.append(np.full(layer.n_blocks, float(layer.patches_per_image)))
        group.append(np.full(layer.n_blocks, i, dtype=np.int64))
    return tuple(
        np.concatenate(x) for x in (job_rate, mean, scv, cost, batch, group)
    )


def _block_means(spec: NetworkSpec, st: "SimTensors") -> list[np.ndarray]:
    """Per-layer (B_l,) zero-skip E_S[c] on the host."""
    mean_b = st.mean_b[1].cpu().numpy()
    return [mean_b[i, : l.n_blocks] for i, l in enumerate(spec.layers)]


# ------------------------------------------------------- array-kernel core
@dataclass(frozen=True)
class SimTensors:
    """Packed (NetworkSpec, NetworkProfile) pair: padded float64 cycle
    tensors on the profile's device plus the statistics the dataflow model
    needs.  Leading axis 2 on the per-variant tensors selects
    zero-skipping: index 0 = baseline (deterministic cycles), 1 = zskip."""

    cycles: torch.Tensor  # (2, L, S, B) per-patch per-block cycles, 0-padded
    s_mask: torch.Tensor  # (L, S) valid patch samples
    b_mask: torch.Tensor  # (L, B) valid blocks
    ppi: torch.Tensor  # (L,) patches per image
    width: torch.Tensor  # (L,) arrays per block
    layer_arrays: torch.Tensor  # (L,) arrays in one copy of the layer
    n_blocks: torch.Tensor  # (L,) valid block count
    mean_b: torch.Tensor  # (2, L, B) E_S[c]
    max_b: torch.Tensor  # (2, L, B) max_S c
    pm_mean: torch.Tensor  # (2, L) E_S[max_B c]  (layer-wise barrier)
    pm_max: torch.Tensor  # (2, L) max_S max_B c
    busy_sum: torch.Tensor  # (2, L) sum_B E_S[c]  (busy cycles per patch)

    @property
    def L(self) -> int:
        return self.b_mask.shape[0]

    @property
    def B(self) -> int:
        return self.b_mask.shape[1]


# keyed on object identity (the frozen dataclasses hold tensors, so they
# are not hashable); weakref finalizers evict entries before an id can be
# reused
_PACK_CACHE: dict[tuple[int, int], SimTensors] = {}


def pack_profile(spec: NetworkSpec, prof: NetworkProfile) -> SimTensors:
    """Pad per-layer (S, B) cycle samples into dense tensors + statistics,
    cached per (spec, profile) object pair."""
    key = (id(spec), id(prof))
    hit = _PACK_CACHE.get(key)
    if hit is not None:
        return hit
    st = _pack_profile(spec, prof)
    _PACK_CACHE[key] = st
    weakref.finalize(spec, _PACK_CACHE.pop, key, None)
    weakref.finalize(prof, _PACK_CACHE.pop, key, None)
    return st


def _pack_profile(spec: NetworkSpec, prof: NetworkProfile) -> SimTensors:
    dev = prof.layers[0].cycles_sample.device
    f64 = dict(dtype=torch.float64, device=dev)
    L = len(spec.layers)
    S = max(lp.cycles_sample.shape[0] for lp in prof.layers)
    B = max(l.n_blocks for l in spec.layers)
    cycles = torch.zeros((2, L, S, B), **f64)
    s_mask = torch.zeros((L, S), dtype=torch.bool, device=dev)
    b_mask = torch.zeros((L, B), dtype=torch.bool, device=dev)
    for i, lp in enumerate(prof.layers):
        s, b = lp.cycles_sample.shape
        cycles[0, i, :s, :b] = lp.baseline_block_cycles.to(torch.float64)
        cycles[1, i, :s, :b] = lp.cycles_sample.to(torch.float64)
        s_mask[i, :s] = True
        b_mask[i, :b] = True
    s_count = s_mask.sum(dim=1).to(torch.float64)  # (L,)
    mean_b = cycles.sum(dim=2) / s_count[None, :, None]
    max_b = cycles.amax(dim=2)  # padded entries are 0 <= any real cycle count
    neg_inf = float("-inf")
    patch_max = torch.where(b_mask[None, :, None, :], cycles, neg_inf).amax(dim=3)
    pm_mean = torch.where(s_mask, patch_max, 0.0).sum(dim=2) / s_count[None, :]
    pm_max = torch.where(s_mask, patch_max, neg_inf).amax(dim=2)
    busy_sum = torch.where(b_mask, mean_b, 0.0).sum(dim=2)
    return SimTensors(
        cycles=cycles,
        s_mask=s_mask,
        b_mask=b_mask,
        ppi=torch.tensor([l.patches_per_image for l in spec.layers], **f64),
        width=torch.tensor([l.arrays_per_block for l in spec.layers], **f64),
        layer_arrays=torch.tensor([l.n_arrays for l in spec.layers], **f64),
        n_blocks=torch.tensor([l.n_blocks for l in spec.layers], dtype=torch.int64, device=dev),
        mean_b=mean_b,
        max_b=max_b,
        pm_mean=pm_mean,
        pm_max=pm_max,
        busy_sum=busy_sum,
    )


def _eval_kernel(
    mean_b,  # (..., L, B) — zskip variant already selected; (V, L, B) with ``sel``
    max_b,  # (..., L, B)
    pm_mean,  # (..., L)
    pm_max,  # (..., L)
    busy_sum,  # (..., L)
    b_mask,  # (L, B)
    ppi,  # (L,)
    width,  # (L,)
    layer_arrays,  # (L,)
    dups_lb,  # (..., L, B) float replicas (layer-wise: broadcast along B)
    layerwise,  # (...) bool: barrier (layer-wise) vs independent blocks
    n_images,
    clock_hz,
    *,
    sel=None,  # (...) int variant index into a leading stack axis, or None
):
    """Allocations -> (T, img/s, per-layer makespan, per-layer util), over
    any leading batch shape (none for ``simulate``, (C,) for the batch).

    With ``sel`` the five statistic tensors carry a leading variant axis
    (the fused sweep's (2A, L, B) baseline + zero-skip per-ADC stacks) and
    each allocation gathers its variant first.  Selecting an element is not
    arithmetic, so results equal those from pre-gathered inputs."""
    if sel is not None:
        mean_b = mean_b[sel]
        max_b = max_b[sel]
        pm_mean = pm_mean[sel]
        pm_max = pm_max[sel]
        busy_sum = busy_sum[sel]
    P = ppi * n_images  # (L,) patches in the batch
    d_layer = dups_lb[..., 0]
    # layer-wise: patches synchronize on the slowest block (barrier)
    t_lw = torch.maximum(pm_mean * P / d_layer, pm_max)
    # block-wise: every block is an independent replicated server pool
    per_block = torch.maximum(mean_b * P[:, None] / dups_lb, max_b)
    t_bw = torch.where(b_mask, per_block, float("-inf")).amax(dim=-1)
    lw = layerwise[..., None]
    layer_T = torch.where(lw, t_lw, t_bw)
    alive = torch.where(
        lw,
        layer_arrays * d_layer,
        torch.where(b_mask, dups_lb * width[:, None], 0.0).sum(dim=-1),
    )
    # busy cycles are allocation-independent: every (patch, block) job runs
    # exactly once on `width` arrays.
    busy = busy_sum * P * width
    T = layer_T.amax(dim=-1)
    util = busy / (alive * T[..., None])
    # tensor / tensor divisions: torch turns ``scalar / tensor`` into
    # ``reciprocal() * scalar``, and on CUDA ``tensor / scalar`` into a
    # multiply by the scalar's reciprocal, each one more rounding
    ips = torch.full_like(T, float(n_images)) / (T / torch.full_like(T, float(clock_hz)))
    return T, ips, layer_T, util


def _alloc_to_dups(st: SimTensors, alloc: Allocation) -> tuple[torch.Tensor, bool]:
    """Allocation -> dense (L, B) replica matrix + layer-wise dataflow flag."""
    dups = np.ones((st.L, st.B))
    layerwise = alloc.layer_dups is not None
    if layerwise:
        dups *= np.asarray(alloc.layer_dups, dtype=np.float64)[:, None]
    else:
        for i, d in enumerate(alloc.block_dups):
            dups[i, : len(d)] = np.asarray(d, dtype=np.float64)
    return torch.as_tensor(dups, device=st.cycles.device), layerwise


def simulate(
    spec: NetworkSpec,
    prof: NetworkProfile,
    alloc: Allocation,
    n_images: int = 64,
    clock_hz: float = CLOCK_HZ,
) -> SimResult:
    st = pack_profile(spec, prof)
    z = int(alloc.policy != "baseline")
    dups_lb, layerwise = _alloc_to_dups(st, alloc)
    T, ips, layer_T, util = _eval_kernel(
        st.mean_b[z],
        st.max_b[z],
        st.pm_mean[z],
        st.pm_max[z],
        st.busy_sum[z],
        st.b_mask,
        st.ppi,
        st.width,
        st.layer_arrays,
        dups_lb,
        torch.tensor(layerwise, device=dups_lb.device),
        n_images,
        clock_hz,
    )
    return SimResult(alloc.policy, float(T), float(ips), layer_T, util, alloc.arrays_used)


# ----------------------------------------------------------- batched engine
@dataclass(frozen=True)
class BatchSimResult:
    """Structure-of-arrays ``SimResult`` for a batch of C allocations."""

    total_cycles: torch.Tensor  # (C,)
    images_per_sec: torch.Tensor  # (C,)
    layer_cycles: torch.Tensor  # (C, L)
    layer_utilization: torch.Tensor  # (C, L)

    @property
    def mean_utilization(self) -> torch.Tensor:  # (C,)
        u = self.layer_utilization
        return u.sum(dim=1) / u.shape[1]

    def __len__(self) -> int:
        return self.total_cycles.shape[0]


class BatchSimulator:
    """``_eval_kernel`` over a batch of allocations, on the profile's device,
    in float64, so batch results match the scalar ``simulate()`` to
    roundoff.  One instance per (spec, profile).  ``shard=True`` splits the
    config axis over the local devices of the profile's kind
    (``distrib.sharding.shard_map_batch``; one card: the plain path), with
    identical results."""

    def __init__(self, spec: NetworkSpec, prof: NetworkProfile, shard: bool = False):
        self.spec = spec
        self.tensors = pack_profile(spec, prof)
        self.shard = bool(shard)
        self._consts: dict[torch.device, tuple] = {}

    def _on(self, dev: torch.device) -> tuple:
        """The packed statistics on ``dev``, copied there once."""
        hit = self._consts.get(dev)
        if hit is None:
            st = self.tensors
            hit = tuple(
                t.to(dev)
                for t in (st.mean_b, st.max_b, st.pm_mean, st.pm_max, st.busy_sum,
                          st.b_mask, st.ppi, st.width, st.layer_arrays)
            )
            self._consts[dev] = hit
        return hit

    def _eval(self, dups_lb, lw, z, n_images, clock_hz):
        mean_b, max_b, pm_mean, pm_max, busy_sum, *rest = self._on(dups_lb.device)
        z = z.long()
        return _eval_kernel(
            mean_b[z], max_b[z], pm_mean[z], pm_max[z], busy_sum[z], *rest,
            dups_lb, lw, int(n_images), float(clock_hz),
        )

    def __call__(
        self,
        dups_lb,  # (C, L, B) float replicas, array or tensor
        layerwise,  # (C,) bool
        zskip,  # (C,) bool
        n_images: int = 64,
        clock_hz: float = CLOCK_HZ,
    ) -> BatchSimResult:
        st = self.tensors
        dev = st.cycles.device
        dups_lb = torch.as_tensor(dups_lb, dtype=torch.float64, device=dev)
        if dups_lb.dim() != 3 or tuple(dups_lb.shape[1:]) != (st.L, st.B):
            raise ValueError(
                f"dups_lb {tuple(dups_lb.shape)} != (C, {st.L}, {st.B})"
            )
        lw = torch.as_tensor(np.asarray(layerwise, dtype=bool), device=dev)
        z = torch.as_tensor(np.asarray(zskip, dtype=np.int64), device=dev)

        def ev(d, lw_, z_):
            return self._eval(d, lw_, z_, n_images, clock_hz)

        if self.shard and dups_lb.shape[0]:
            from ...distrib.sharding import shard_map_batch

            ev = shard_map_batch(ev)
        T, ips, layer_T, util = ev(dups_lb, lw, z)
        return BatchSimResult(T, ips, layer_T, util)


def run_policy(
    spec: NetworkSpec,
    prof: NetworkProfile,
    policy: Policy,
    n_pes: int,
    n_images: int = 64,
) -> SimResult:
    return simulate(spec, prof, allocate(spec, prof, policy, n_pes), n_images)

"""Fused DSE pipeline: profile-derive -> allocate -> evaluate, per
(network, rows-geometry) group, on one device.

The staged sweep (``run_sweep``) derives a profile per (geometry, ADC)
variant on the host side of each group, allocates, and evaluates, with
round trips between the stages.  ``FusedPipeline`` instead derives the
per-ADC cycle banks of every variant from ONE shared capture at once
(``kernels.bitplane_profile.bitplane_cycle_bank``: one K1 popcount, then a
re-costing per ADC precision), stacks their statistics once and keeps them
on the device for every chunk of every call.  Each config then picks its
variant by one scalar ``sel`` inside the eval, so nothing (C, L, B)-shaped
exists besides the replica tensor.

Two engines, element-wise identical on the discrete columns:

  * ``"torch"`` (the reference's ``"xla"``): the greedy families' bases
    are per-variant constants, so the whole greedy is replayed from ONE
    sorted grant-event table per variant on the host
    (``core.alloc.greedy.greedy_event_schedule``, exact, heap order tie
    for tie), and each chunk is a scatter + the batched ``_eval_kernel``
    with ``sel`` on the device;
  * ``"kernel"`` (the reference's ``"pallas"``): both greedy families go
    through K2 (``kernels.fused_alloc_eval``), which runs the lock-step
    greedy, the scatter and the eval for every config in one launch per
    chunk.  Proportional configs enter at budget 0 with their host-computed
    replicas as the warm start.

Equivalence contract (the reference's, ``src/repro/dse/fused.py``):
discrete columns (replicas, arrays used / total) are exactly equal to the
staged path; float columns agree to rtol 1e-12.  Cycle samples are
integer-valued float64, so sums are exact in any order and each mean is one
division, which makes the allocation bases bit-equal and the replicas
exact; ``busy_sum`` sums rounded means, whose order may differ.

The fused fabric stage (``fabric_percentiles``, ``fabric=`` on
``run_fused_sweep``) runs every config's latency percentiles through one VT
launch (``kernels.vtime_scan``): its variant table holds one service table
per (ADC, zero-skip, dataflow) triple, built once per pipeline on the
device from the derived banks, and each config picks its variant and its
lanes.  Its columns equal the staged sweep's.

``shard=True`` splits every chunk's config axis over the local devices
(``distrib.sharding.shard_map_batch``; one card: the plain path), each
device holding its own copy of the pipeline's statistics.
``run_fused_multichip_sweep`` evaluates a whole (placement x load) surface
through one closed-loop and one open-loop ``VirtualTimeFabric.run_batch``.
``latency_aware`` is load-coupled and stays on the staged path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core.alloc.greedy import greedy_event_schedule, proportional_allocate_batch
from ..core.cim.cost import DEFAULT_ARRAY, ArrayConfig, baseline_cycles
from ..core.cim.network import NetworkSpec
from ..core.cim.profile import ActivationCapture
from ..core.cim.simulate import ARRAYS_PER_PE, CLOCK_HZ, _eval_kernel
from ..core.cim.topology import allocate_placed, stage_transfer_matrix
from ..fabric.telemetry import get_telemetry, spanned
from ..fabric.vtime import lanes_of, service_indices, variant_table
from ..kernels.bitplane_profile import bitplane_cycle_bank
from ..kernels.fused_alloc_eval import fused_alloc_eval
from ..kernels.vtime_scan import VTTables, count_deep_inserts, vt_tables, vtime_scan
from .engine import flat_unit_map
from ..distrib.sharding import shard_map_batch
from .sweep import (
    ChipSweepPoint,
    FabricEval,
    SweepPoint,
    SweepResult,
    _spec_for,
    get_captured,
    get_profiled,
)

__all__ = [
    "FusedPipeline",
    "FusedChipSweepResult",
    "get_fused_pipeline",
    "clear_fused_caches",
    "run_fused_sweep",
    "run_fused_multichip_sweep",
]

ENGINES = ("torch", "kernel")
_PROPORTIONAL = ("baseline", "weight_based", "weight_blockflow")
_LAYERWISE_FLOW = ("baseline", "weight_based", "perf_layerwise")
_FUSED_POLICIES = _PROPORTIONAL + ("perf_layerwise", "blockwise")
_KIND = {p: 0 for p in _PROPORTIONAL}
_KIND["perf_layerwise"] = 1
_KIND["blockwise"] = 2
_F64 = torch.float64

_PIPELINE_CACHE: dict[tuple, "FusedPipeline"] = {}


def _canonical(array: ArrayConfig) -> ArrayConfig:
    """The rows-geometry key: ADC precision is a config axis INSIDE a fused
    group (it never changes block shapes), so strip it for grouping."""
    return array.variant(adc_bits=DEFAULT_ARRAY.adc_bits)


class FusedPipeline:
    """Fused derive -> allocate -> eval for one (network, rows-geometry)
    group, on ``device``.

    ``adc_bits`` is the group's ADC axis: per-config ``a_idx`` selects a
    variant.  All other ``ArrayConfig`` fields come from ``base_array`` and
    are part of the group identity (they change block shapes)."""

    def __init__(
        self,
        network: str,
        base_array: ArrayConfig,
        adc_bits: tuple[int, ...],
        *,
        profile_images: int = 1,
        sample_patches: int = 128,
        seed: int = 0,
        arrays_per_pe: int = ARRAYS_PER_PE,
        shard: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.shard = bool(shard)
        self._dev_consts: dict[torch.device, tuple] = {}
        self.network = network
        self.adc_bits = tuple(int(a) for a in adc_bits)
        if len(set(self.adc_bits)) != len(self.adc_bits):
            raise ValueError(f"duplicate adc_bits {adc_bits}")
        self.base_array = _canonical(base_array)
        self.variants = tuple(self.base_array.variant(adc_bits=a) for a in self.adc_bits)
        self.arrays_per_pe = int(arrays_per_pe)
        self.spec: NetworkSpec = _spec_for(network, self.base_array)
        self.capture: ActivationCapture = get_captured(
            network,
            profile_images=profile_images,
            sample_patches=sample_patches,
            seed=seed,
            device=self.device,
        )
        self._build_static()
        self._stats_cache = None
        self._sched_cache: dict[tuple, object] = {}
        self._vt_tables = None

    # ------------------------------------------------------------ host prep
    def _build_static(self) -> None:
        spec, cap, dev = self.spec, self.capture, self.device
        L = len(spec.layers)
        B = max(l.n_blocks for l in spec.layers)
        R = self.base_array.rows
        self.S_l = [c.sampled_q.shape[0] for c in cap.layers]
        S = max(self.S_l)
        self.L, self.B, self.S = L, B, S
        # zero-padded (L, B, S, R) uint8 block tensor on the device: padded
        # rows / blocks / samples hold no '1' bits and are masked after costing
        Q = torch.zeros((L, B, S, R), dtype=torch.uint8, device=dev)
        s_mask = np.zeros((L, S), dtype=bool)
        b_mask = np.zeros((L, B), dtype=bool)
        for li, (layer, c) in enumerate(zip(spec.layers, cap.layers)):
            s, rows = c.sampled_q.shape
            nb = layer.n_blocks
            s_mask[li, :s] = True
            b_mask[li, :nb] = True
            # block_row_slices tiles the rows contiguously, R rows per block
            padded = c.sampled_q.new_zeros((s, nb * R))
            padded[:, :rows] = c.sampled_q
            Q[li, :nb, :s] = padded.view(s, nb, R).transpose(0, 1).to(dev)
        self.Q = Q
        self.s_mask = s_mask
        self.b_mask = b_mask
        self.s_count = s_mask.sum(axis=1).astype(np.float64)
        self.ppi = np.array([l.patches_per_image for l in spec.layers], dtype=np.float64)
        self.width = np.array([l.arrays_per_block for l in spec.layers], dtype=np.float64)
        self.layer_arrays = np.array([l.n_arrays for l in spec.layers], dtype=np.float64)
        self.macs = np.array([l.macs_per_image for l in spec.layers], dtype=np.float64)
        self.base_arrays = spec.n_arrays
        table = spec.block_table()  # (N, 3): layer, block-in-layer, width
        self.l_idx = table[:, 0].copy()
        self.blk_idx = table[:, 1].copy()
        self.cost_blk = table[:, 2].astype(np.float64)
        self.N = table.shape[0]
        # baseline (zskip OFF) statistics are capture-independent geometry
        # constants, computed on the host with the ops the staged packing
        # applies to its variant-0 slice
        A = len(self.variants)
        cyc0 = np.zeros((A, L, S, B))
        for ai, v in enumerate(self.variants):
            for li, layer in enumerate(spec.layers):
                sl = layer.block_row_slices()
                base = baseline_cycles(np.asarray([s.stop - s.start for s in sl]), v)
                cyc0[ai, li, : self.S_l[li], : layer.n_blocks] = base
        self.base0 = cyc0[:, :, 0, :]  # (A, L, B) baseline cycles per block
        self.mean0 = cyc0.sum(axis=2) / self.s_count[None, :, None]
        self.max0 = cyc0.max(axis=2)
        pmax0 = np.where(b_mask[None, :, None, :], cyc0, -np.inf).max(axis=3)
        self.pm_mean0 = np.where(s_mask, pmax0, 0.0).sum(axis=2) / self.s_count[None, :]
        self.pm_max0 = np.where(s_mask, pmax0, -np.inf).max(axis=2)
        self.busy0 = np.where(b_mask[None], self.mean0, 0.0).sum(axis=2)

        def on_dev(a, dtype=_F64):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        self._b_mask_t = on_dev(b_mask, torch.bool)
        self._ppi_t = on_dev(self.ppi)
        self._width_t = on_dev(self.width)
        self._larr_t = on_dev(self.layer_arrays)
        self._cost_blk_t = on_dev(self.cost_blk)
        self._l_idx_t = on_dev(self.l_idx, torch.int64)
        self._blk_idx_t = on_dev(self.blk_idx, torch.int64)
        # one-hot unit maps of the two greedy families, for K2
        self._umaps = {
            "L": on_dev(flat_unit_map(L, B)),
            "B": on_dev(flat_unit_map(L, B, self.l_idx, self.blk_idx)),
        }

    # --------------------------------------------- stage 1: shared bank stacks
    def _stats(self):
        """Per-group shared statistic stacks, derived once on the device.

        Returns ``(mean_s, max_s (2A, L, B), pmn_s, pmx_s, busy_s (2A, L),
        exp_lat (A, L), base_blk (A, N), bank (A, L, S, B))``: the baseline
        (zskip OFF) variants occupy stack slots [0, A) and the zero-skip
        derivations slots [A, 2A), so a per-config ``sel = a_idx +
        A*zskip`` picks a variant inside ``_eval_kernel``.  One K1 launch
        per pipeline: the popcount is shared by every ADC variant.
        Integer-valued sums are exact in any order and each division
        happens once, so the statistics equal the staged packing's."""
        if self._stats_cache is not None:
            return self._stats_cache
        dev = self.device
        rows_per_read = tuple(v.rows_per_read for v in self.variants)
        bank = bitplane_cycle_bank(
            self.Q, rows_per_read, cycles_per_read=self.base_array.cycles_per_read
        )  # (A, L, B, S) int32
        s_mask = torch.as_tensor(self.s_mask, device=dev)
        b_mask = self._b_mask_t
        s_count = torch.as_tensor(self.s_count, dtype=_F64, device=dev)
        ppi = self._ppi_t
        valid = s_mask[None, :, None, :] & b_mask[None, :, :, None]
        cyc = torch.where(valid, bank, 0).to(_F64).transpose(2, 3)  # (A, L, S, B)
        mean_b1 = cyc.sum(dim=2) / s_count[None, :, None]  # (A, L, B)
        max_b1 = cyc.amax(dim=2)
        pmax1 = torch.where(b_mask[None, :, None, :], cyc, float("-inf")).amax(dim=3)
        pm_mean1 = torch.where(s_mask, pmax1, 0.0).sum(dim=2) / s_count[None, :]
        pm_max1 = torch.where(s_mask, pmax1, float("-inf")).amax(dim=2)
        busy1 = torch.where(b_mask[None], mean_b1, 0.0).sum(dim=2)

        def stack(host, derived):  # baseline slot v, zero-skip slot A + v
            return torch.cat([torch.as_tensor(host, dtype=_F64, device=dev), derived])

        self._stats_cache = (
            stack(self.mean0, mean_b1),
            stack(self.max0, max_b1),
            stack(self.pm_mean0, pm_mean1),
            stack(self.pm_max0, pm_max1),
            stack(self.busy0, busy1),
            pm_mean1 * ppi[None, :],  # per-ADC perf_layerwise bases
            (mean_b1 * ppi[None, :, None])[:, self._l_idx_t, self._blk_idx_t],  # blockwise
            cyc,
        )
        return self._stats_cache

    # ------------------------------------------- stage 2: schedule lookups
    def _schedule(self, kind: int, a: int, max_budget: float):
        """Cached ``GreedyEventSchedule`` for one (family, ADC variant),
        rebuilt only when a call's budget range outgrows its coverage."""
        sched = self._sched_cache.get((kind, a))
        if sched is not None and sched.max_budget >= max_budget:
            return sched
        stats = self._stats()
        if kind == 1:
            base = stats[5][a].cpu().numpy()  # (L,) expected layer latency
            cost = self.layer_arrays
        else:
            base = stats[6][a].cpu().numpy()  # (N,) per-block-unit latency
            cost = self.cost_blk
        sched = greedy_event_schedule(base, cost, max_budget)
        self._sched_cache[(kind, a)] = sched
        return sched

    # --------------------------------------------------------- chunk program
    def _on(self, dev: torch.device) -> tuple:
        """(five statistic stacks, b_mask, ppi, width, layer arrays, l_idx,
        blk_idx) on ``dev``, copied there once (a sharded call's other
        devices)."""
        hit = self._dev_consts.get(dev)
        if hit is None:
            hit = tuple(
                t.to(dev)
                for t in (*self._stats()[:5], self._b_mask_t, self._ppi_t, self._width_t,
                          self._larr_t, self._l_idx_t, self._blk_idx_t)
            )
            self._dev_consts[dev] = hit
        return hit

    def _sharded(self, fn):
        return shard_map_batch(fn) if self.shard else fn

    def _eval_chunk(self, fam: str, sel, layerwise, r, n_images: int, clock_hz: float):
        """Scatter + batched ``_eval_kernel`` for one chunk of family ``"L"``
        (per-layer replicas) or ``"B"`` (per-block-unit replicas)."""
        dev = self.device

        def ev(sel, layerwise, r):
            *stats, b_mask, ppi, width, larr, l_idx, blk_idx = self._on(r.device)
            c = r.shape[0]
            if fam == "B":
                dups_lb = torch.ones((c, self.L, self.B), dtype=_F64, device=r.device)
                dups_lb[:, l_idx, blk_idx] = r
            else:
                dups_lb = r[:, :, None].expand(c, self.L, self.B)
            T, ips, layer_T, util = _eval_kernel(
                *stats, b_mask, ppi, width, larr, dups_lb, layerwise, n_images, clock_hz,
                sel=sel,
            )
            return T, ips, layer_T, util, dups_lb

        return self._sharded(ev)(
            torch.as_tensor(sel, dtype=torch.int64, device=dev),
            torch.as_tensor(layerwise, device=dev),
            torch.as_tensor(r, dtype=_F64, device=dev),
        )

    def _validate(self, policies, n_pes):
        policies = np.atleast_1d(np.asarray(policies, dtype=object))
        n_pes = np.atleast_1d(np.asarray(n_pes, dtype=np.int64))
        policies, n_pes = np.broadcast_arrays(policies, n_pes)
        unknown = sorted({p for p in policies if p not in _FUSED_POLICIES})
        if unknown:
            raise ValueError(
                f"unsupported policies {unknown} for the fused pipeline; "
                f"choose from {_FUSED_POLICIES} ('latency_aware' is "
                f"load-coupled and is not ported yet)"
            )
        total = n_pes * self.arrays_per_pe
        if np.any(total < self.base_arrays):
            raise ValueError(
                f"{int(total.min())} arrays < minimum {self.base_arrays} for {self.spec.name}"
            )
        return policies, n_pes, total

    @spanned("dse.fused.alloc_eval")
    def __call__(
        self,
        a_idx,  # (C,) index into self.adc_bits
        policies,  # (C,) policy names
        n_pes,  # (C,) PE budgets
        *,
        n_images: int = 64,
        clock_hz: float = CLOCK_HZ,
        chunk: int = 32768,
        return_bank: bool = False,
        need_dups: bool = True,
        engine: str = "torch",
    ):
        """Evaluate C packed configs, one device pass per chunk.

        Returns a dict of numpy columns on the host (total_cycles,
        images_per_sec, layer_cycles, layer_utilization, dups_lb, layerwise,
        zskip, arrays_used, arrays_total) plus ``bank`` (A, L, S, B) float64
        when ``return_bank``.  ``chunk`` tiles the config axis, so device
        memory is bounded by the tile, not by C; tilings give identical
        results.  ``need_dups=False`` leaves out the (C, L, B) replica
        column.  ``engine`` is ``"torch"`` (event-schedule replay + batched
        eval) or ``"kernel"`` (K2)."""
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; use 'torch' or 'kernel'")
        policies, n_pes, total = self._validate(policies, n_pes)
        a_idx = np.broadcast_to(
            np.atleast_1d(np.asarray(a_idx, dtype=np.int32)), policies.shape
        ).copy()
        if a_idx.size and (a_idx.min() < 0 or a_idx.max() >= len(self.adc_bits)):
            raise ValueError(f"a_idx out of range for {len(self.adc_bits)} ADC variants")
        C = policies.shape[0]
        budgets = (total - self.base_arrays).astype(np.float64)
        kind = np.array([_KIND[p] for p in policies], dtype=np.int32)
        zskip = policies != "baseline"
        layerwise = np.isin(policies, _LAYERWISE_FLOW)
        A = len(self.variants)
        sel = (a_idx + np.where(zskip, A, 0)).astype(np.int32)

        # proportional replicas read no profile (MACs only): the staged
        # largest-remainder routine on the host, exact
        r_layer = np.ones((C, self.L))  # rows of family "L" only
        prop = kind == 0
        if prop.any():
            res = proportional_allocate_batch(self.macs, self.layer_arrays, budgets[prop])
            r_layer[prop] = res.replicas.numpy().astype(np.float64)

        outs = {
            "total_cycles": np.zeros(C),
            "images_per_sec": np.zeros(C),
            "layer_cycles": np.zeros((C, self.L)),
            "layer_utilization": np.zeros((C, self.L)),
        }
        if need_dups:
            outs["dups_lb"] = np.zeros((C, self.L, self.B))
        if engine == "kernel":
            used_f = self._kernel_eval(
                outs, sel, a_idx, kind, budgets, layerwise, r_layer,
                int(n_images), float(clock_hz), int(chunk), need_dups,
            )
        else:
            used_f = self._torch_eval(
                outs, sel, a_idx, kind, budgets, layerwise, r_layer,
                int(n_images), float(clock_hz), int(chunk), need_dups,
            )
        outs["arrays_used"] = self.base_arrays + used_f.astype(np.int64)
        outs["arrays_total"] = total
        outs["layerwise"] = layerwise
        outs["zskip"] = zskip
        if return_bank:
            outs["bank"] = self._stats()[-1].cpu().numpy()
        return outs

    def _torch_eval(
        self, outs, sel, a_idx, kind, budgets, layerwise, r_layer,
        n_images, clock_hz, chunk, need_dups,
    ):
        """``engine="torch"``: every greedy replica vector from the shared
        event schedules on the host, then scatter + eval on the device."""
        C = budgets.shape[0]
        tel = get_telemetry()
        used_f = np.zeros(C)
        rows_B = np.nonzero(kind == 2)[0]
        r_blk = np.ones((rows_B.size, self.N))  # family "B", rows_B order
        for k, rows_k in ((1, np.nonzero(kind == 1)[0]), (2, rows_B)):
            if rows_k.size == 0:
                continue
            bmax = float(budgets[rows_k].max())
            for a in np.unique(a_idx[rows_k]):
                rk = a_idx[rows_k] == a
                got = self._schedule(k, int(a), bmax).replicas_at(budgets[rows_k[rk]])
                reps = got.replicas.numpy().astype(np.float64)
                if k == 1:
                    r_layer[rows_k[rk]] = reps
                else:
                    r_blk[rk] = reps
        rows_L = np.nonzero(kind != 2)[0]
        used_f[rows_L] = (r_layer[rows_L] - 1.0) @ self.layer_arrays
        used_f[rows_B] = ((r_blk - 1.0) * self.cost_blk).sum(axis=1)

        csize_max = n_chunks = 0
        for fam, rows, r_fam in (("L", rows_L, r_layer), ("B", rows_B, r_blk)):
            if rows.size == 0:
                continue
            csize = min(chunk, rows.size)
            csize_max = max(csize_max, csize)
            for j0 in range(0, rows.size, csize):
                part = rows[j0 : j0 + csize]
                # family "L" replicas index by global row; family "B" by
                # position (r_blk rows are laid out in rows_B order)
                r_take = r_fam[part] if fam == "L" else r_fam[j0 : j0 + part.size]
                T, ips, layer_T, util, dups = self._eval_chunk(
                    fam, sel[part], layerwise[part], r_take, n_images, clock_hz
                )
                with tel.span("dse.fused.copy_out"):
                    outs["total_cycles"][part] = T.cpu().numpy()
                    outs["images_per_sec"][part] = ips.cpu().numpy()
                    outs["layer_cycles"][part] = layer_T.cpu().numpy()
                    outs["layer_utilization"][part] = util.cpu().numpy()
                    if need_dups:
                        outs["dups_lb"][part] = dups.cpu().numpy()
                n_chunks += 1
        # chunking telemetry: the live device set per pass is one tile (the
        # (csize, L, B) replica tensor dominates), never the full C
        tel.gauge("dse.fused.chunk_configs", csize_max)
        tel.gauge(
            "dse.fused.chunk_device_bytes",
            csize_max * (2 * self.L * self.B + self.N + 2 * self.L + 3) * 8,
        )
        tel.gauge("dse.fused.host_out_bytes", sum(a.nbytes for a in outs.values()))
        tel.count("dse.fused.chunks", n_chunks)
        return used_f

    def _kernel_eval(
        self, outs, sel, a_idx, kind, budgets, layerwise, dups0,
        n_images, clock_hz, chunk, need_dups,
    ):
        """``engine="kernel"``: both greedy families on their unit axis
        through K2 (greedy + scatter + eval, one launch per chunk).
        Proportional configs enter at budget 0 with their host-computed
        replicas as the warm start, where the greedy changes nothing."""
        dev = self.device
        tel = get_telemetry()
        stats = self._stats()
        C = budgets.shape[0]
        used_f = np.zeros(C)
        fams = (
            ("L", np.nonzero(kind != 2)[0], stats[5], self._larr_t),
            ("B", np.nonzero(kind == 2)[0], stats[6], self._cost_blk_t),
        )

        def on_dev(a, dtype=_F64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

        for fam, rows, base, cost in fams:
            if rows.size == 0:
                continue

            def launch(bud, a, sel_, lw, r0_, fam=fam, base=base, cost=cost):
                d = bud.device
                *b5, b_mask, ppi, width, larr, _, _ = self._on(d)
                with tel.span("k2.launch"):
                    out = fused_alloc_eval(
                        base.to(d), cost.to(d), self._umaps[fam].to(d), tuple(b5), b_mask, ppi, width, larr,
                        bud, a, sel_, lw, r0_, n_images=n_images, clock_hz=clock_hz,
                    )
                tel.count("k2.launches")
                return out[:5]

            r0 = np.ones((rows.size, base.shape[1]))
            bud = budgets[rows].copy()
            if fam == "L":
                isprop = kind[rows] == 0
                r0[isprop] = dups0[rows[isprop]]
                bud[isprop] = 0.0
            csize = min(chunk, rows.size)
            for j0 in range(0, rows.size, csize):
                part = rows[j0 : j0 + csize]
                sl = slice(j0, j0 + part.size)
                T, ips, layer_T, util, r = self._sharded(launch)(
                    on_dev(bud[sl]), on_dev(a_idx[part], torch.int32),
                    on_dev(sel[part], torch.int32), on_dev(layerwise[part], torch.bool),
                    on_dev(r0[sl]),
                )
                with tel.span("dse.fused.copy_out"):
                    outs["total_cycles"][part] = T.cpu().numpy()
                    outs["images_per_sec"][part] = ips.cpu().numpy()
                    outs["layer_cycles"][part] = layer_T.cpu().numpy()
                    outs["layer_utilization"][part] = util.cpu().numpy()
                    # integer-valued terms: exact in any order
                    used_f[part] = ((r - 1.0) * cost).sum(dim=1).cpu().numpy()
                    if need_dups:
                        r = r.cpu().numpy()
                        if fam == "L":
                            outs["dups_lb"][part] = r[:, :, None]
                        else:
                            d = np.ones((part.size, self.L, self.B))
                            d[:, self.l_idx, self.blk_idx] = r
                            outs["dups_lb"][part] = d
        return used_f

    # ----------------------------------------------------- fused fabric stage
    def _fabric_tables(self) -> VTTables:
        """VT's tables: per layer (4A, S_l, B_l) on the device, packed,
        variant ``(a * 2 + zskip) * 2 + layerwise``: the derived
        bank (zero-skip) or the baseline cycles broadcast over the samples,
        and for the layer-wise dataflow the per-patch barrier on pool 0."""
        if self._vt_tables is None:
            bank = self._stats()[-1]  # (A, L, S, B)
            base = torch.as_tensor(self.base0, dtype=_F64, device=self.device)
            tables = []
            for li, layer in enumerate(self.spec.layers):
                s, b = self.S_l[li], layer.n_blocks
                per = []
                for a in range(len(self.variants)):
                    c1 = bank[a, li, :s, :b]
                    c0 = base[a, li, :b].expand(s, b)
                    for c in (c0, c1):
                        per += [variant_table(c, False), variant_table(c, True)]
                tables.append(torch.stack(per))
            self._vt_tables = vt_tables(tables)
        return self._vt_tables

    @spanned("dse.fused.fabric")
    def fabric_percentiles(
        self,
        a_idx: np.ndarray,  # (C,)
        dups_lb: np.ndarray,  # (C, L, B) from the analytic stage
        layerwise: np.ndarray,  # (C,) bool
        zskip: np.ndarray,  # (C,) bool
        arrival_times: np.ndarray,  # (C, n) cycles
        *,
        seed: int = 0,
        qs: tuple = (50.0, 95.0, 99.0),
        xfer: np.ndarray | None = None,  # (C, L) stage entry transfers
    ) -> np.ndarray:
        """(C, len(qs)) latency percentiles through one VT launch: each
        config picks its (ADC, zero-skip, dataflow) variant of the
        pipeline's service tables and its lanes (a layer-wise config pools
        its duplicates on block 0).  Bit-identical to routing each config
        through the staged ``VirtualTimeFabric``; the percentiles are
        ``np.percentile`` on the host over the exact latencies."""
        dev = self.device
        n = arrival_times.shape[1]
        lw = np.asarray(layerwise, dtype=bool)
        dims = [(self.S_l[li], l.patches_per_image) for li, l in enumerate(self.spec.layers)]
        idx = service_indices(seed, dims, n, dev)
        t_arr, comp, _, _ = vtime_scan(
            self._fabric_tables(),
            idx,
            [p for _, p in dims],
            (np.asarray(a_idx, dtype=np.int64) * 2 + np.asarray(zskip, dtype=bool)) * 2 + lw,
            lanes_of([l.n_blocks for l in self.spec.layers], np.asarray(dups_lb).astype(np.int64), lw),
            n_requests=n,
            arrivals=torch.as_tensor(np.asarray(arrival_times, dtype=np.float64), device=dev),
            xfer=None if xfer is None else torch.as_tensor(np.asarray(xfer, dtype=np.float64), device=dev),
        )
        tel = get_telemetry()
        with tel.span("vt.wait"):
            comp, t_arr = comp.cpu().numpy(), t_arr.cpu().numpy()
            count_deep_inserts()
        with tel.span("vt.percentiles", host=True):
            return np.percentile(comp - t_arr, qs, axis=1).T


def get_fused_pipeline(
    network: str,
    base_array: ArrayConfig,
    adc_bits: tuple[int, ...],
    *,
    profile_images: int = 1,
    sample_patches: int = 128,
    seed: int = 0,
    arrays_per_pe: int = ARRAYS_PER_PE,
    shard: bool = False,
    device: str | torch.device = "cuda",
) -> FusedPipeline:
    """Cached ``FusedPipeline``: derived bank stacks and event schedules
    survive across sweeps."""
    dev = resolve_device(device)
    key = (
        network,
        _canonical(base_array),
        tuple(int(a) for a in adc_bits),
        profile_images,
        sample_patches,
        seed,
        arrays_per_pe,
        str(dev),
        bool(shard),
    )
    if key not in _PIPELINE_CACHE:
        _PIPELINE_CACHE[key] = FusedPipeline(
            network,
            base_array,
            adc_bits,
            profile_images=profile_images,
            sample_patches=sample_patches,
            seed=seed,
            arrays_per_pe=arrays_per_pe,
            shard=shard,
            device=dev,
        )
    return _PIPELINE_CACHE[key]


def clear_fused_caches() -> None:
    _PIPELINE_CACHE.clear()


@spanned("dse.fused.sweep")
def run_fused_sweep(
    points: list[SweepPoint],
    *,
    n_images: int = 64,
    profile_images: int = 1,
    sample_patches: int = 128,
    seed: int = 0,
    arrays_per_pe: int = ARRAYS_PER_PE,
    fabric: FabricEval | None = None,
    shard_devices: bool = False,
    chunk: int = 32768,
    chunk_size: int | None = None,
    engine: str = "torch",
    device: str | torch.device = "cuda",
) -> SweepResult:
    """Fused counterpart of ``run_sweep(engine="batch")`` on ``device``.

    Groups points by (network, rows-geometry); each group derives its
    shared per-ADC bank stacks once, then streams its whole (ADC x policy
    x PE-budget) config tensor through the fused allocate + eval, one pass
    per chunk (``chunk_size`` is an alias of ``chunk``).  Results are
    element-wise identical to the staged path on the discrete columns and
    within rtol 1e-12 on the floats.  ``engine="kernel"`` runs the
    allocate + eval through K2.  With ``fabric=FabricEval(...)`` the fused
    fabric stage (``FusedPipeline.fabric_percentiles``, one VT launch per
    group) fills the p50 / p95 / p99 columns from the same traces as the
    staged ``run_sweep``.  ``shard_devices=True`` splits each chunk over
    the local devices.  ``latency_aware`` points raise."""
    dev = resolve_device(device)
    if chunk_size is not None:
        chunk = int(chunk_size)
    C = len(points)
    out = {
        name: np.zeros(C)
        for name in ("total_cycles", "images_per_sec", "mean_utilization")
    }
    used = np.zeros(C, dtype=np.int64)
    total = np.zeros(C, dtype=np.int64)
    pcts = np.full((C, 3), np.nan) if fabric is not None else None

    tel = get_telemetry()
    with tel.span("dse.fused.points", host=True):
        groups: dict[tuple, list[int]] = {}
        for i, p in enumerate(points):
            groups.setdefault((p.network, _canonical(p.array)), []).append(i)
        packed = []
        for (net, arr), rows in groups.items():
            adcs = tuple(sorted({points[i].array.adc_bits for i in rows}))
            pos = {a: k for k, a in enumerate(adcs)}
            packed.append((net, arr, adcs, np.asarray(rows),
                           np.array([pos[points[i].array.adc_bits] for i in rows], dtype=np.int32),
                           np.array([points[i].policy for i in rows], dtype=object),
                           np.array([points[i].n_pes for i in rows], dtype=np.int64)))

    elapsed = 0.0
    for net, arr, adcs, idx, a_idx, pols, pes in packed:
        pipe = get_fused_pipeline(
            net,
            arr,
            adcs,
            profile_images=profile_images,
            sample_patches=sample_patches,
            seed=seed,
            arrays_per_pe=arrays_per_pe,
            shard=shard_devices,
            device=dev,
        )
        t0 = time.perf_counter()
        res = pipe(a_idx, pols, pes, n_images=n_images, chunk=chunk,
                   need_dups=fabric is not None, engine=engine)
        util = res["layer_utilization"]
        out["total_cycles"][idx] = res["total_cycles"]
        out["images_per_sec"][idx] = res["images_per_sec"]
        out["mean_utilization"][idx] = util.sum(axis=1) / util.shape[1]
        used[idx] = res["arrays_used"]
        total[idx] = res["arrays_total"]
        if fabric is not None:
            with tel.span("dse.fused.arrivals", host=True):
                gaps = np.random.default_rng(fabric.seed).exponential(1.0, size=fabric.n_requests)
                rates = fabric.load_frac * res["images_per_sec"] / CLOCK_HZ
                times = np.cumsum(gaps)[None, :] / rates[:, None]
            pcts[idx] = pipe.fabric_percentiles(
                a_idx, res["dups_lb"], res["layerwise"], res["zskip"], times, seed=fabric.seed
            )
        elapsed += time.perf_counter() - t0

    return SweepResult(
        points=list(points),
        total_cycles=out["total_cycles"],
        images_per_sec=out["images_per_sec"],
        mean_utilization=out["mean_utilization"],
        arrays_used=used,
        arrays_total=total,
        elapsed_s=elapsed,
        engine="fused",
        p50_cycles=pcts[:, 0] if fabric is not None else None,
        p95_cycles=pcts[:, 1] if fabric is not None else None,
        p99_cycles=pcts[:, 2] if fabric is not None else None,
        fabric=fabric,
    )


# --------------------------------------------------- fused multi-chip sweep
@dataclass
class FusedChipSweepResult:
    """Multi-chip outcome with a batched LOAD axis: row i of ``pcts`` holds
    the (len(load_fracs), 3) p50/p95/p99 surface of ``points[i]`` —
    placement x load evaluated in one batched virtual-time call per group."""

    points: list[ChipSweepPoint]
    load_fracs: tuple
    images_per_sec: np.ndarray  # (C,)
    pcts: np.ndarray  # (C, K, 3) latency percentiles, cycles
    max_stage_transfer: np.ndarray
    n_crossings: np.ndarray
    arrays_used: np.ndarray
    arrays_total: np.ndarray
    elapsed_s: float

    def __len__(self) -> int:
        return len(self.points)

    @property
    def n_evaluations(self) -> int:
        return len(self.points) * len(self.load_fracs)

    def rows(self) -> list[dict]:
        out = []
        for i, p in enumerate(self.points):
            for k, lf in enumerate(self.load_fracs):
                out.append(
                    {
                        "network": p.network,
                        "policy": p.policy,
                        "n_chips": p.n_chips,
                        "link_gbps": p.link_gbps,
                        "load_frac": float(lf),
                        "images_per_sec": float(self.images_per_sec[i]),
                        "p50_ms": float(self.pcts[i, k, 0] / CLOCK_HZ * 1e3),
                        "p95_ms": float(self.pcts[i, k, 1] / CLOCK_HZ * 1e3),
                        "p99_ms": float(self.pcts[i, k, 2] / CLOCK_HZ * 1e3),
                        "max_stage_transfer_cycles": float(
                            self.max_stage_transfer[i]
                        ),
                        "n_crossings": int(self.n_crossings[i]),
                        "arrays_used": int(self.arrays_used[i]),
                        "arrays_total": int(self.arrays_total[i]),
                    }
                )
        return out


def run_fused_multichip_sweep(
    points: list[ChipSweepPoint],
    *,
    load_fracs: tuple = (0.7,),
    n_requests: int = 200,
    closed_requests: int = 80,
    concurrency: int = 32,
    seed: int = 0,
    profile_images: int = 1,
    sample_patches: int = 128,
    arrays_per_pe: int = ARRAYS_PER_PE,
    latency_load_frac: float = 0.7,
    device: str | torch.device = "cuda",
) -> FusedChipSweepResult:
    """``run_multichip_sweep`` with the placement loop lifted into a
    batchable placement x load axis.

    The staged sweep evaluates one load point per run and walks placements
    in Python; here every group's (unique placement) x (load_frac) cross
    product goes through ONE batched open-loop virtual-time call (the
    placements' per-stage transfer vectors packed by
    ``topology.stage_transfer_matrix``), after one batched closed-loop call
    for throughput: two VT launches per group on ``device``.  At
    ``load_fracs=(0.7,)`` the outcome is element-wise identical to
    ``run_multichip_sweep``.
    """
    from ..fabric.arrivals import ClosedLoop, TraceReplay
    from ..fabric.vtime import VirtualTimeFabric

    K = len(load_fracs)
    C = len(points)
    ips = np.zeros(C)
    pcts = np.zeros((C, K, 3))
    xfer_max = np.zeros(C)
    crossings = np.zeros(C, dtype=np.int64)
    used = np.zeros(C, dtype=np.int64)
    total = np.zeros(C, dtype=np.int64)

    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(points):
        groups.setdefault((p.network, p.array), []).append(i)
    dev = resolve_device(device)
    prof_kw = dict(
        profile_images=profile_images, sample_patches=sample_patches, seed=seed, device=dev
    )
    for net, arr in groups:
        get_profiled(net, arr, **prof_kw)

    elapsed = 0.0
    qs = (50.0, 95.0, 99.0)
    for (net, arr), rows in groups.items():
        spec, prof = get_profiled(net, arr, **prof_kw)
        alias: dict[int, int] = {}
        canon: dict[tuple, int] = {}
        uniq: list[int] = []
        for i in rows:
            p = points[i]
            key = (
                p.policy, p.n_pes_total, p.n_chips,
                p.link_gbps if p.n_chips > 1 else None,
            )
            if key not in canon:
                canon[key] = i
                uniq.append(i)
            alias[i] = canon[key]
        placed = []
        for i in uniq:
            p = points[i]
            pa = allocate_placed(
                spec, prof, p.policy, p.topology(arrays_per_pe),
                load_frac=latency_load_frac,
            )
            placed.append(pa)
            xfer_max[i] = pa.placement.max_stage_transfer
            crossings[i] = pa.placement.n_crossings
            used[i] = pa.allocation.arrays_used
            total[i] = pa.allocation.arrays_total
        allocs = [pa.allocation for pa in placed]
        places = [pa.placement for pa in placed]
        stage_transfer_matrix(places)  # validate the packable axis up front
        t0 = time.perf_counter()
        vt = VirtualTimeFabric(spec, prof, lane_quantum=8, device=dev)
        cl = vt.run_batch(
            allocs, ClosedLoop(closed_requests, concurrency),
            seed=seed, percentiles=qs, placements=places,
        )
        ips[uniq] = cl.images_per_sec
        # the lifted axis: (placement x load) pairs share one normalized
        # gap sequence and evaluate in ONE batched open-loop call
        gaps = np.random.default_rng(seed).exponential(1.0, size=n_requests)
        cum = np.cumsum(gaps)
        U = len(uniq)
        allocs_x = [allocs[u] for u in range(U) for _ in range(K)]
        places_x = [places[u] for u in range(U) for _ in range(K)]
        procs = [
            TraceReplay(cum / (lf * ips[uniq[u]] / CLOCK_HZ))
            for u in range(U)
            for lf in load_fracs
        ]
        op = vt.run_batch(
            allocs_x, procs, seed=seed, percentiles=qs, placements=places_x
        )
        lat = op.latencies.reshape(U, K, -1)
        for k in range(K):
            pcts[np.asarray(uniq), k] = np.percentile(lat[:, k], qs, axis=1).T
        for i in rows:
            j = alias[i]
            if j != i:
                ips[i] = ips[j]
                pcts[i] = pcts[j]
                xfer_max[i] = xfer_max[j]
                crossings[i] = crossings[j]
                used[i] = used[j]
                total[i] = total[j]
        elapsed += time.perf_counter() - t0

    return FusedChipSweepResult(
        points=list(points),
        load_fracs=tuple(load_fracs),
        images_per_sec=ips,
        pcts=pcts,
        max_stage_transfer=xfer_max,
        n_crossings=crossings,
        arrays_used=used,
        arrays_total=total,
        elapsed_s=elapsed,
    )

"""Hierarchical chip -> PE -> array resource tree + communication-aware
placement.  Ported from the reference ``core/cim/topology.py`` (numpy on the
host, verbatim; it imports the port's own profile, simulate and greedy).

Arrays group into PEs behind a NoC, and scaling past one chip strings
several fabrics on inter-chip links; a stage whose replicas live off the
chip that produces its input pays a transfer delay on every request
crossing that dataflow edge.  ``FabricTopology`` is the tree and its cost
model (activation bytes from ``ArrayConfig.input_bits``, NoC hop latency from
``noc_hop_cycles``, inter-chip links from ``link_gbps``):

  * ``allocate_placed`` — every policy of ``simulate.allocate`` run
    placement-aware (``greedy_allocate_placed`` for the greedy policies,
    ``queueing_allocate(extra_delay=)`` for ``latency_aware``, counts then
    ``place_extras`` for the proportional ones);
  * ``place_allocation`` — place an existing flat ``Allocation``;
  * ``Placement.stage_transfer`` — the per-request entry delay per stage,
    the one vector the fabric engines take (``FabricSim(placement=)`` /
    ``VirtualTimeFabric.run_batch(placements=)``).

Movement within a chip is already paid for in the profiled per-patch
cycles, so ``transfer_cycles(c, c, n) == 0`` and a 1-chip fabric reproduces
the flat allocator and the flat fabric engines bit for bit.  Chips sit on a
linear chain; a transfer over ``h`` hops costs ``h * (head_latency + bytes /
link_bytes_per_cycle)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

from .cost import ArrayConfig, DEFAULT_ARRAY
from .network import LayerSpec, NetworkSpec
from .profile import NetworkProfile
from .simulate import (
    ARRAYS_PER_PE,
    CLOCK_HZ,
    Allocation,
    Policy,
    _layer_patch_cycles,
    _queueing_inputs,
    allocate,
    blockwise_units,
    simulate,
    split_block_dups,
)
from ..alloc.greedy import (
    greedy_allocate_placed,
    place_extras,
    proportional_allocate,
    queueing_allocate,
)

__all__ = [
    "FabricTopology",
    "Placement",
    "PlacedAllocation",
    "allocate_placed",
    "place_allocation",
    "request_bytes",
    "stage_transfer_matrix",
]


@dataclass(frozen=True)
class FabricTopology:
    """chip -> PE -> array resource tree with a link/NoC cost model.

    ``n_chips`` chips on a linear chain, each holding ``pes_per_chip`` PEs of
    ``arrays_per_pe`` crossbar arrays.  ``link_gbps`` is the bandwidth of one
    inter-chip link; per-hop head latency and activation byte counts derive
    from ``array`` (the same ``ArrayConfig`` the compute model uses, so a
    geometry sweep that changes the array automatically re-prices
    communication).  The host interface (input injection) attaches to chip 0.
    """

    pes_per_chip: int
    n_chips: int = 1
    arrays_per_pe: int = ARRAYS_PER_PE
    link_gbps: float = 64.0
    clock_hz: float = CLOCK_HZ
    array: ArrayConfig = DEFAULT_ARRAY

    def __post_init__(self):
        if self.n_chips < 1 or self.pes_per_chip < 1 or self.arrays_per_pe < 1:
            raise ValueError(
                f"degenerate topology: {self.n_chips} chips x "
                f"{self.pes_per_chip} PEs x {self.arrays_per_pe} arrays"
            )
        if self.link_gbps <= 0:
            raise ValueError(f"link_gbps must be positive, got {self.link_gbps}")

    # ------------------------------------------------------------ capacities
    @property
    def arrays_per_chip(self) -> int:
        return self.pes_per_chip * self.arrays_per_pe

    @property
    def total_pes(self) -> int:
        return self.n_chips * self.pes_per_chip

    @property
    def total_arrays(self) -> int:
        return self.n_chips * self.arrays_per_chip

    def spares_per_chip(self, spare_fraction: float) -> int:
        """Arrays to hold back as hot spares on EACH chip for fault
        tolerance: ``floor(arrays_per_chip * spare_fraction)``.  Spares are
        budgeted per chip, not fabric-wide, because a chip-correlated
        failure domain (``fabric.failures`` bursts) takes its own spares
        down with it — cross-chip spares are what survive."""
        if not 0.0 <= spare_fraction <= 1.0:
            raise ValueError(
                f"spare_fraction must be in [0, 1], got {spare_fraction}"
            )
        return int(self.arrays_per_chip * spare_fraction)

    # ------------------------------------------------------------ cost model
    @property
    def link_bytes_per_cycle(self) -> float:
        """Inter-chip link bandwidth in bytes per fabric clock cycle."""
        return self.link_gbps * 1e9 / 8.0 / self.clock_hz

    @property
    def hop_latency_cycles(self) -> float:
        """Head latency of one inter-chip hop: the NoC traversal from the
        producing PEs to the chip-edge link (diameter of a square PE mesh)."""
        return self.array.noc_hop_cycles * math.ceil(math.sqrt(self.pes_per_chip))

    def chip_hops(self, src: int, dst: int) -> int:
        return abs(int(src) - int(dst))

    def transfer_cycles(self, src: int, dst: int, nbytes: float) -> float:
        """Cycles to move ``nbytes`` of activations from chip ``src`` to chip
        ``dst``.  Zero on-chip (folded into the profiled compute cycles);
        store-and-forward per hop off-chip."""
        hops = self.chip_hops(src, dst)
        if hops == 0:
            return 0.0
        return hops * (self.hop_latency_cycles + nbytes / self.link_bytes_per_cycle)

    def transfer_matrix(self, src: int, nbytes: float) -> np.ndarray:
        """(n_chips,) transfer cycles from ``src`` to every chip."""
        return np.asarray(
            [self.transfer_cycles(src, k, nbytes) for k in range(self.n_chips)]
        )

    def variant(self, **changes) -> "FabricTopology":
        """A modified copy — the multi-chip design-space sweep axis (e.g.
        ``topo.variant(n_chips=4)`` or ``.variant(link_gbps=8.0)``)."""
        return replace(self, **changes)

    # --------------------------------------------------------- constructors
    @classmethod
    def single_chip(
        cls,
        n_pes: int,
        arrays_per_pe: int = ARRAYS_PER_PE,
        array: ArrayConfig = DEFAULT_ARRAY,
        clock_hz: float = CLOCK_HZ,
    ) -> "FabricTopology":
        """The degenerate one-chip tree: the flat pool the paper assumes.
        All transfers cost zero, so every placed result reproduces the flat
        allocator / fabric engines bit for bit."""
        return cls(
            pes_per_chip=int(n_pes),
            n_chips=1,
            arrays_per_pe=arrays_per_pe,
            array=array,
            clock_hz=clock_hz,
        )

    @classmethod
    def split(
        cls,
        n_chips: int,
        n_pes_total: int,
        arrays_per_pe: int = ARRAYS_PER_PE,
        link_gbps: float = 64.0,
        array: ArrayConfig = DEFAULT_ARRAY,
        clock_hz: float = CLOCK_HZ,
    ) -> "FabricTopology":
        """Partition a fixed PE budget over ``n_chips`` chips (the equal-
        silicon comparison the multi-chip sweep makes).  Requires the budget
        to divide evenly so every chip count compares the same total."""
        if n_pes_total % n_chips:
            raise ValueError(
                f"{n_pes_total} PEs do not split evenly over {n_chips} chips"
            )
        return cls(
            pes_per_chip=n_pes_total // n_chips,
            n_chips=n_chips,
            arrays_per_pe=arrays_per_pe,
            link_gbps=link_gbps,
            array=array,
            clock_hz=clock_hz,
        )


def request_bytes(layer: LayerSpec, array: ArrayConfig | None = None) -> float:
    """Activation bytes one request (image) carries INTO a layer: every
    patch applies its ``rows`` quantized inputs to the word lines."""
    a = layer.array if array is None else array
    return float(layer.patches_per_image) * layer.rows * a.act_bytes


@dataclass(frozen=True)
class Placement:
    """Replica -> location for one allocation on one topology.

    ``replica_chips``: per layer — block-wise allocations hold a tuple of
    (d_b,) int chip arrays (one per block, entry 0 = mandatory copy);
    layer-wise allocations hold a single (d_l,) array whose entry 0 stands
    for the mandatory grid and entries 1: are full-grid duplicates, each on
    one chip.  A mandatory grid can SPAN chips (first-fit may split it), so
    ``mandatory_chips`` records the true per-block home chips per layer —
    transfer and per-chip load accounting use it, never the single
    representative entry.  ``layer_src`` is the chip each stage's input is
    gathered from (host = chip 0 for stage 0, then the majority chip of the
    previous layer's mandatory arrays).  ``stage_transfer`` is the derived
    per-request entry delay per stage — the only thing the fabric engines
    consume.
    """

    topology: FabricTopology
    layer_src: np.ndarray  # (L,) int
    replica_chips: tuple  # per layer: tuple[np.ndarray, ...] | np.ndarray
    mandatory_chips: tuple  # per layer: (B_l,) int per-block home chips
    stage_transfer: np.ndarray  # (L,) float64 cycles
    chip_arrays: np.ndarray  # (K,) arrays occupied per chip

    @property
    def n_crossings(self) -> int:
        """Replica units parked off their stage's source chip — mandatory
        blocks plus extra replicas (blocks for block-wise, whole-grid
        duplicates for layer-wise); a data-movement footprint for reports."""
        total = 0
        for src, man, rc in zip(
            self.layer_src, self.mandatory_chips, self.replica_chips
        ):
            total += int((man != src).sum())
            extras = [a[1:] for a in rc] if isinstance(rc, tuple) else [rc[1:]]
            total += int(sum((a != src).sum() for a in extras))
        return total

    @property
    def max_stage_transfer(self) -> float:
        return float(self.stage_transfer.max()) if self.stage_transfer.size else 0.0


@dataclass(frozen=True)
class PlacedAllocation:
    """An ``Allocation`` plus where every replica lives."""

    allocation: Allocation
    placement: Placement


def stage_transfer_matrix(placements) -> np.ndarray:
    """Pack P placements' per-stage entry delays into one (P, L) float64
    matrix — the batchable placement axis the fused DSE pipeline feeds to
    the virtual-time kernel (one vmapped fabric call across placements
    instead of a Python loop over topologies)."""
    return np.ascontiguousarray(
        np.stack(
            [np.asarray(p.stage_transfer, dtype=np.float64) for p in placements]
        )
    )


# --------------------------------------------------------------- internals
def _mandatory_placement(
    spec: NetworkSpec, topo: FabricTopology, chip_free: np.ndarray | None = None
) -> tuple[list[np.ndarray], np.ndarray, np.ndarray]:
    """First-fit the mandatory copy of every block, in layer order.

    Returns (per-layer (B_l,) home-chip arrays, (L,) per-layer source chips,
    (K,) free arrays per chip after the mandatory copies).  Walking layers in
    order onto a chain of chips keeps adjacent stages co-located, which is
    what makes the dataflow edges cheap by default.  ``chip_free`` starts
    from partially-occupied chips (multi-tenant fabrics place tenants
    sequentially on one shared tree).
    """
    free = (
        np.full(topo.n_chips, float(topo.arrays_per_chip))
        if chip_free is None
        else np.asarray(chip_free, dtype=np.float64).copy()
    )
    homes: list[np.ndarray] = []
    for layer in spec.layers:
        w = float(layer.arrays_per_block)
        if w > topo.arrays_per_chip:
            raise ValueError(
                f"block of {layer.name} ({int(w)} arrays) exceeds one chip "
                f"({topo.arrays_per_chip} arrays)"
            )
        h = np.empty(layer.n_blocks, dtype=np.int64)
        for b in range(layer.n_blocks):
            fit = np.flatnonzero(free >= w)
            if fit.size == 0:
                raise ValueError(
                    f"topology ({topo.total_arrays} arrays over "
                    f"{topo.n_chips} chips) cannot hold the mandatory copy "
                    f"of {spec.name} ({spec.n_arrays} arrays)"
                )
            k = int(fit[0])
            free[k] -= w
            h[b] = k
        homes.append(h)
    src = np.zeros(len(spec.layers), dtype=np.int64)  # stage 0 feeds from host
    for i, layer in enumerate(spec.layers[:-1]):
        # the next stage's input is gathered where the bulk of this layer's
        # mandatory arrays sit (ties -> lowest chip id)
        src[i + 1] = _majority_chip(homes[i], layer, topo.n_chips)
    return homes, src, free


def _majority_chip(homes_i: np.ndarray, layer: LayerSpec, n_chips: int) -> int:
    """Chip holding the bulk of a layer's mandatory arrays (ties -> lowest
    id).  The ONE definition shared by the per-layer source-chip derivation
    and the layer-duplicate home — they must agree, or penalties would be
    measured from a different chip than replicas are charged to."""
    load = np.bincount(
        homes_i,
        weights=np.full(layer.n_blocks, layer.arrays_per_block),
        minlength=n_chips,
    )
    return int(np.argmax(load))


def _stage_transfer(
    spec: NetworkSpec,
    topo: FabricTopology,
    layer_src: np.ndarray,
    mandatory_chips,
    replica_chips,
) -> np.ndarray:
    """(L,) per-request entry delay: the worst replica's transfer on each
    stage's incoming dataflow edge (all jobs dispatch at stage entry, so the
    farthest replica gates readiness).  The mandatory copy is accounted by
    its TRUE per-block chips (first-fit may have split it across chips) —
    for layer-wise allocations ``replica_chips`` entry 0 is only a
    representative and is replaced by ``mandatory_chips`` here."""
    out = np.zeros(len(spec.layers))
    for i, layer in enumerate(spec.layers):
        nb = request_bytes(layer, topo.array)
        row = topo.transfer_matrix(int(layer_src[i]), nb)
        rc = replica_chips[i]
        worst = float(row[mandatory_chips[i]].max())
        extras = [a[1:] for a in rc] if isinstance(rc, tuple) else [rc[1:]]
        for a in extras:
            if a.size:
                worst = max(worst, float(row[a].max()))
        out[i] = worst
    return out


def _chip_arrays(
    spec: NetworkSpec, topo: FabricTopology, mandatory_chips, replica_chips
) -> np.ndarray:
    """(K,) arrays occupied per chip — mandatory blocks at their true homes
    plus extra replicas where they were placed (block replicas are
    ``arrays_per_block`` wide; layer-wise duplicates are whole grids)."""
    load = np.zeros(topo.n_chips)
    for layer, man, rc in zip(spec.layers, mandatory_chips, replica_chips):
        np.add.at(load, man, float(layer.arrays_per_block))
        if isinstance(rc, tuple):
            for a in rc:
                np.add.at(load, a[1:], float(layer.arrays_per_block))
        else:
            np.add.at(load, rc[1:], float(layer.n_arrays))
    return load


def _free_arrays(spec: NetworkSpec, topo: FabricTopology, free_budget) -> float:
    total = topo.total_arrays
    base = spec.n_arrays
    if total < base:
        raise ValueError(f"{total} arrays < minimum {base} for {spec.name}")
    free = total - base
    if free_budget is not None:
        if not 0 <= free_budget <= free:
            raise ValueError(
                f"free_budget {free_budget} outside [0, {free}] free arrays"
            )
        free = float(free_budget)
    return float(free)


def _layer_home_and_penalty(
    spec: NetworkSpec,
    topo: FabricTopology,
    homes: list[np.ndarray],
    src: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-LAYER (home chip, (L, K) penalty matrix) for layer-wise policies:
    a layer duplicate's home is the majority chip of its mandatory grid."""
    L = len(spec.layers)
    home = np.empty(L, dtype=np.int64)
    pen = np.zeros((L, topo.n_chips))
    for i, layer in enumerate(spec.layers):
        home[i] = _majority_chip(homes[i], layer, topo.n_chips)
        pen[i] = topo.transfer_matrix(int(src[i]), request_bytes(layer, topo.array))
    return home, pen


def _block_penalty(
    spec: NetworkSpec, topo: FabricTopology, src: np.ndarray
) -> np.ndarray:
    """(n_blocks, K) penalty matrix for the flat block units."""
    rows = []
    for i, layer in enumerate(spec.layers):
        row = topo.transfer_matrix(int(src[i]), request_bytes(layer, topo.array))
        rows.append(np.broadcast_to(row, (layer.n_blocks, topo.n_chips)))
    return np.concatenate(rows, axis=0)


def _stripe_extras(
    replicas: np.ndarray,
    cost: np.ndarray,
    home: np.ndarray,
    chip_free: np.ndarray,
) -> list[np.ndarray]:
    """Round-robin replica striping: the communication-blind baseline.
    Each extra replica goes to the next chip in rotation with space."""
    free = np.asarray(chip_free, dtype=np.float64).copy()
    K = free.size
    out: list[np.ndarray] = []
    ptr = 0
    for i in range(replicas.size):
        chips = [int(home[i])]
        for _ in range(int(replicas[i]) - 1):
            for off in range(K):
                k = (ptr + off) % K
                if free[k] >= cost[i]:
                    break
            else:
                raise ValueError(
                    f"no chip can hold another replica of unit {i} "
                    f"(cost {cost[i]}, free {free})"
                )
            free[k] -= cost[i]
            chips.append(k)
            ptr = (k + 1) % K
        out.append(np.asarray(chips, dtype=np.int64))
    return out


def _split_chips(spec: NetworkSpec, flat: list[np.ndarray]) -> tuple:
    """Flat per-block chip lists -> per-layer tuples (blockwise layout)."""
    out, k = [], 0
    for layer in spec.layers:
        out.append(tuple(flat[k : k + layer.n_blocks]))
        k += layer.n_blocks
    return tuple(out)


def _repack_or_keep(res, cost, *, home, pen, chip_free) -> list[np.ndarray]:
    """Final placement for counts granted by ``greedy_allocate_placed``.

    The dataflow-order re-pack (``place_extras``: chips fill along the chain
    as layers do) dominates grant-order interleaving on chain topologies,
    but it is a DIFFERENT first-fit order, so on a near-full fabric it can
    fail to pack counts the greedy's own grant-time assignment already
    proved placeable — in that case keep the greedy's certified chips.
    """
    try:
        return place_extras(
            res.replicas, cost, home_chip=home, unit_penalty=pen,
            chip_free=chip_free,
        )
    except ValueError:
        return res.replica_chips


# ------------------------------------------------------------------ public
def place_allocation(
    spec: NetworkSpec,
    alloc: Allocation,
    topo: FabricTopology,
    chip_free: np.ndarray | None = None,
    strategy: str = "locality",
) -> Placement:
    """Place an existing flat ``Allocation`` on a topology.

    Mandatory copies first-fit in layer order; extra replicas follow
    ``strategy``:

      * ``"locality"`` (default) — each replica goes to the affordable chip
        with the lowest transfer penalty on its stage's incoming dataflow
        edge (``place_extras``), in dataflow order.
      * ``"stripe"`` — replicas round-robin across chips (the
        communication-blind load/thermal-balancing default a flat-pool
        scheduler would pick); the baseline the locality placement is
        measured against.

    This is the placement path for allocations whose replica counts were
    chosen elsewhere — proportional policies, tenancy slices, drift
    re-allocations — and for evaluating a flat allocation "as if"
    serialized onto a multi-chip fabric.  ``chip_free`` starts from
    partially-occupied chips (sequential tenant placement on one shared
    tree); subtract the returned ``chip_arrays`` to chain the next tenant.
    """
    if strategy not in ("locality", "stripe"):
        raise ValueError(f"strategy must be 'locality' or 'stripe', got {strategy!r}")
    homes, src, free = _mandatory_placement(spec, topo, chip_free)
    if alloc.layer_dups is not None:
        home, pen = _layer_home_and_penalty(spec, topo, homes, src)
        cost = np.array([l.n_arrays for l in spec.layers], dtype=np.float64)
        reps = np.asarray(alloc.layer_dups, dtype=np.int64)
    else:
        table = spec.block_table()
        cost = table[:, 2].astype(np.float64)
        reps = np.concatenate([np.asarray(d) for d in alloc.block_dups]).astype(
            np.int64
        )
        home = np.concatenate(homes)
        pen = _block_penalty(spec, topo, src)
    if strategy == "stripe":
        chips = _stripe_extras(reps, cost, home, free)
    else:
        chips = place_extras(
            reps, cost, home_chip=home, unit_penalty=pen, chip_free=free
        )
    replica_chips = (
        tuple(chips) if alloc.layer_dups is not None else _split_chips(spec, chips)
    )
    return Placement(
        topology=topo,
        layer_src=src,
        replica_chips=replica_chips,
        mandatory_chips=tuple(homes),
        stage_transfer=_stage_transfer(spec, topo, src, homes, replica_chips),
        chip_arrays=_chip_arrays(spec, topo, homes, replica_chips),
    )


def allocate_placed(
    spec: NetworkSpec,
    prof: NetworkProfile,
    policy: Policy,
    topo: FabricTopology,
    free_budget: float | None = None,
    offered_ips: float | None = None,
    load_frac: float = 0.7,
    audit=None,
) -> PlacedAllocation:
    """``simulate.allocate`` lifted from "replica counts in a flat pool" to
    "placement on the resource tree".

    ``audit`` (a ``obs.AllocationAudit``) records the placed greedy's
    per-grant decision log — including the chip each replica landed on —
    for the greedy policies (``perf_layerwise`` / ``blockwise``).

    Policy-for-policy mirror of the flat allocator, with moves scored by a
    communication penalty on the dataflow edges:

      * ``perf_layerwise`` / ``blockwise`` run the comm-aware greedy
        (``greedy_allocate_placed``): the heap ranks units by effective
        latency = drain latency + worst-replica transfer, and each grant
        lands on the chip that least raises that transfer.
      * ``latency_aware`` folds the stage entry transfer into the queueing
        score (``extra_delay``), then places the chosen counts.
      * proportional policies (``baseline`` / ``weight_based`` /
        ``weight_blockflow``) keep their counts — proportional by
        definition — and place replicas penalty-greedily.

    On a 1-chip topology every penalty is zero and each policy reproduces
    the flat ``allocate`` replica-for-replica, bit for bit (pinned against
    the pre-refactor golden fixtures).
    """
    free = _free_arrays(spec, topo, free_budget)
    homes, src, chip_free = _mandatory_placement(spec, topo)
    L = len(spec.layers)
    zskip = policy != "baseline"
    cyc = _layer_patch_cycles(prof, zskip)
    ppi = np.array([l.patches_per_image for l in spec.layers], dtype=np.float64)
    layer_arrays = np.array([l.n_arrays for l in spec.layers], dtype=np.float64)
    base_arrays = spec.n_arrays
    total = topo.total_arrays

    if policy in ("baseline", "weight_based", "weight_blockflow"):
        macs = np.array([l.macs_per_image for l in spec.layers], dtype=np.float64)
        res = proportional_allocate(macs, layer_arrays, free)
        used = int(base_arrays + (res.replicas - 1) @ layer_arrays)
        home, pen = _layer_home_and_penalty(spec, topo, homes, src)
        if policy == "weight_blockflow":
            block_dups = [
                np.full(l.n_blocks, res.replicas[i], dtype=np.int64)
                for i, l in enumerate(spec.layers)
            ]
            table = spec.block_table()
            chips = place_extras(
                np.concatenate(block_dups), table[:, 2].astype(np.float64),
                home_chip=np.concatenate(homes),
                unit_penalty=_block_penalty(spec, topo, src),
                chip_free=chip_free,
            )
            alloc = Allocation(policy, None, block_dups, used, total)
            replica_chips = _split_chips(spec, chips)
        else:
            chips = place_extras(
                res.replicas, layer_arrays,
                home_chip=home, unit_penalty=pen, chip_free=chip_free,
            )
            alloc = Allocation(policy, res.replicas, None, used, total)
            replica_chips = tuple(chips)

    elif policy == "perf_layerwise":
        exp_lat = np.array([cyc[i].max(axis=1).mean() * ppi[i] for i in range(L)])
        home, pen = _layer_home_and_penalty(spec, topo, homes, src)
        res = greedy_allocate_placed(
            exp_lat, layer_arrays, free,
            home_chip=home, unit_penalty=pen, chip_free=chip_free,
            audit=audit,
        )
        used = int(base_arrays + (res.replicas - 1) @ layer_arrays)
        alloc = Allocation(policy, res.replicas, None, used, total)
        replica_chips = tuple(
            _repack_or_keep(
                res, layer_arrays, home=home, pen=pen, chip_free=chip_free
            )
        )

    elif policy == "blockwise":
        base_lat, cost = blockwise_units(spec, [cyc[i].mean(axis=0) for i in range(L)])
        pen_blocks = _block_penalty(spec, topo, src)
        home_flat = np.concatenate(homes)
        res = greedy_allocate_placed(
            base_lat, cost, free,
            home_chip=home_flat, unit_penalty=pen_blocks, chip_free=chip_free,
            audit=audit,
        )
        used = int(base_arrays + ((res.replicas - 1) * cost).sum())
        alloc = Allocation(
            policy, None, split_block_dups(spec, res.replicas), used, total
        )
        replica_chips = _split_chips(
            spec,
            _repack_or_keep(
                res, cost, home=home_flat, pen=pen_blocks, chip_free=chip_free
            ),
        )

    elif policy == "latency_aware":
        if offered_ips is None:
            bw = allocate(
                spec, prof, "blockwise", topo.total_pes, topo.arrays_per_pe,
                free_budget,
            )
            offered_ips = load_frac * simulate(spec, prof, bw).images_per_sec
        if offered_ips <= 0:
            raise ValueError(f"offered_ips must be positive, got {offered_ips}")
        r_cyc = float(offered_ips) / CLOCK_HZ
        pen_blocks = _block_penalty(spec, topo, src)
        home_flat = np.concatenate(homes)
        job_rate, mean, scv, cost, batch, group = _queueing_inputs(
            spec, cyc, r_cyc
        )
        # the stage's unavoidable entry transfer at the mandatory placement;
        # None (not zeros) on a single chip so the flat scoring path is
        # genuinely untouched
        home_pen = pen_blocks[np.arange(home_flat.size), home_flat]
        res = queueing_allocate(
            job_rate, mean, scv, cost, free,
            batch_size=batch, group=group,
            extra_delay=home_pen if np.any(home_pen) else None,
        )
        used = int(base_arrays + ((res.replicas - 1) * cost).sum())
        chips = place_extras(
            res.replicas, cost,
            home_chip=home_flat, unit_penalty=pen_blocks, chip_free=chip_free,
        )
        alloc = Allocation(
            policy, None, split_block_dups(spec, res.replicas), used, total
        )
        replica_chips = _split_chips(spec, chips)

    else:
        raise ValueError(policy)

    placement = Placement(
        topology=topo,
        layer_src=src,
        replica_chips=replica_chips,
        mandatory_chips=tuple(homes),
        stage_transfer=_stage_transfer(spec, topo, src, homes, replica_chips),
        chip_arrays=_chip_arrays(spec, topo, homes, replica_chips),
    )
    return PlacedAllocation(alloc, placement)

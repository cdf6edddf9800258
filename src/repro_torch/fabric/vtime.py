"""Packed virtual-time fabric: the event engine as array algebra.

``events.py`` / ``dispatch.py`` simulate the fabric with an explicit event
calendar; this module evaluates the *same* model as a dense virtual-time
recurrence.  Ported from the reference ``fabric/vtime.py``.

Why that is exact and not an approximation:

  * Pools are work-conserving FIFO and a request's patch jobs enqueue the
    moment it enters a stage, so a later request's jobs always sit behind an
    earlier request's jobs in every pool: requests cannot overtake each
    other.  The whole simulation collapses to a scan over requests: request
    r runs through all L stages against pool state left by requests
    0..r-1.
  * Closed-loop admission keeps the same shape: completions happen in index
    order, so request k arrives exactly when request ``k - concurrency``
    completes.

Pool state is a sorted multiset of server free-times per pool (``+inf``
marks servers that do not exist), and one FIFO job is "pop lane 0, sorted
insert of the end time" (``dispatch_step``): only adds, mins and maxes.

Two engines, bit-identical to each other and to ``FabricSim``:

  * ``engine="torch"`` (the default; the reference's ``"jax"``): one launch
    of VT, the virtual-time scan kernel (``kernels.vtime_scan``,
    ``csrc/vtime_scan.cu``), for every (allocation, trace) pair of a call,
    on ``device``.  Each config picks its cycle table from a small variant
    table (one per dataflow and zero-skip setting) and its lanes from a
    (C, pools) matrix, so allocations of mixed policies share the launch.
    On CPU tensors the same call runs VT's plain PyTorch version.
  * ``engine="numpy"``: the reference's shared kernel functions with
    ``xp=numpy`` and ``_np_scan``, config by config on the host (copied as
    they are, below).

Service times are presampled request-major (``sample_service_indices``) from
the profiled per-(patch, block) cycle sample; ``FabricSim`` consumes the
same helper in the same order, which is what makes the engines
bit-identical rather than merely statistically equivalent.  VT on a card
takes the same numbers drawn there (``service_indices``,
``kernels.service_draw``).  Percentiles are ``np.percentile`` on the host
over the exact latencies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core.cim.network import NetworkSpec
from ..core.cim.profile import NetworkProfile
from ..core.cim.simulate import CLOCK_HZ, Allocation, _layer_patch_cycles
from ..kernels import service_draw as _draw
from ..kernels.vtime_scan import VTTables, count_deep_inserts, to_device, vt_tables, vtime_scan
from .arrivals import ArrivalProcess, ClosedLoop, PoissonOpen, arrival_times
from .metrics import LatencyStats, latency_stats, percentile_kernel, steady_throughput
from .telemetry import get_telemetry, spanned

__all__ = [
    "CoarsenConfig",
    "chunk_plan",
    "dispatch_step",
    "hash_service_indices",
    "lanes_of",
    "pool_dispatch",
    "pool_dispatch_stream",
    "sample_service_indices",
    "service_indices",
    "variant_table",
    "VTInputs",
    "VTResult",
    "VirtualTimeFabric",
    "provision_latency_aware",
    "refine_latency_aware",
]

ENGINES = ("torch", "numpy")


# ------------------------------------------------------------ shared kernel
def dispatch_step(xp, free, svc):
    """One FIFO job per pool onto its earliest-free server.

    ``free``: (..., D) server free-times kept SORTED ascending (``+inf`` =
    absent server); ``svc``: (...,) the job's service time.  Because the
    lanes hold the sorted *multiset* of free-times — which is all the FIFO
    recurrence can observe — the earliest-free server is lane 0, and the
    update is an elementwise sorted-insert of the job's end time:

        r_i = min(max(u_{i-1}, v), u_i),   u = remaining lanes (+/-inf edges)

    No reductions, no scatter: the step is pure elementwise algebra, and it
    performs bit-for-bit the same IEEE add (start + svc) as the event
    engine's ``ServerPool``, whose completion times depend only on the same
    multiset.  Returns (free', end).
    """
    end = free[..., 0] + svc
    up = xp.concatenate([free[..., 1:], xp.full_like(free[..., :1], xp.inf)], axis=-1)
    free = xp.minimum(xp.maximum(free, end[..., None]), up)
    return free, end


def pool_dispatch(xp, scan, free, t_ready, svc, b_mask, collect=False):
    """FIFO-dispatch a batch of jobs, all ready at ``t_ready``.

    ``free``: (B, D) per-pool server free-times; ``svc``: (P, B) one job per
    pool per row; ``b_mask``: (B,) valid pools.  Returns (free', done) with
    ``done`` = completion of the batch (max end over valid pools, at least
    ``t_ready``) — exactly ``ServerPool.dispatch`` batched over pools.

    Clamping every server to ``t_ready`` up front is equivalent to the event
    engine's per-job ``max(avail, t)``: dispatch times per pool are
    nondecreasing, so a stored pre-clamp value below ``t_ready`` can never
    matter again, and the sorted multiset of free-times (which is all the
    FIFO recurrence sees) evolves identically.

    ``collect=True`` additionally returns (busy, wait) for this batch: busy
    = total service cycles dispatched, wait = total queue-wait (job start -
    ``t_ready``).  A job's start is read off lane 0 AFTER the clamp and
    BEFORE the sorted-insert — the same quantity the event engine's
    ``max(avail_i, t_ready)`` yields — so the telemetry path performs the
    identical IEEE ops on ``free``/``done`` and cannot perturb results.
    """
    free = xp.maximum(free, t_ready)
    if not collect:

        def job(free, svc_p):
            return dispatch_step(xp, free, svc_p)

        free, ends = scan(job, free, svc)  # (P, B) per-job completion times
        done = xp.maximum(xp.where(b_mask, ends, -xp.inf).max(), t_ready)
        return free, done

    def job(state, svc_p):
        free, acc = state
        start = free[..., 0]  # earliest-free lane = this job's start time
        free, end = dispatch_step(xp, free, svc_p)
        # accumulate queue wait in the carry (a 0-d scalar) rather than
        # emitting a second (B,) scan output: the collect kernel then adds
        # one fused reduction per job instead of doubling the ys traffic
        acc = acc + xp.where(b_mask, start - t_ready, 0.0).sum()
        return (free, acc), end

    (free, wait), ends = scan(job, (free, xp.zeros(())), svc)
    done = xp.maximum(xp.where(b_mask, ends, -xp.inf).max(), t_ready)
    busy = xp.where(b_mask, svc, 0.0).sum()
    return free, done, busy, wait


def pool_dispatch_stream(xp, scan, free, t_ready, svc, b_mask):
    """Carry-max variant of ``pool_dispatch``: accumulate the batch's
    completion as a running max in the scan carry instead of emitting a
    (P, B) per-job end matrix.  Float max is associative and commutative
    (no NaNs here), so folding the ends one job at a time — seeded with
    ``t_ready`` — produces bit-for-bit the same ``done`` as the
    materializing reduction; the lane updates are untouched.  This is what
    lets the fleet streaming kernel keep O(lanes) state per scan step
    regardless of trace length."""
    free = xp.maximum(free, t_ready)

    def job(state, svc_p):
        f, acc = state
        f, end = dispatch_step(xp, f, svc_p)
        acc = xp.maximum(acc, xp.where(b_mask, end, -xp.inf).max())
        return (f, acc), None

    (free, done), _ = scan(job, (free, t_ready), svc)
    return free, done


# ---------------------------------------------------- macro-job coarsening
@dataclass(frozen=True)
class CoarsenConfig:
    """Opt-in approximation: aggregate a stage's bulk patch jobs into
    macro-jobs of K patches (service times summed per pool), keeping the
    last ``tail_lanes * D`` jobs exact per-patch so end-of-stage lane
    balancing — which sets the next stage's start — is preserved.

    The kernel is work-bound at one scan step per job, so chunking the bulk
    is the honest wall-time lever: measured on VGG11 (single core),
    ``granularity=1, tail_lanes=3`` is 2.7x with ~0.3% positive (pessimistic)
    p50/p95/p99 bias and ``tail_lanes=2`` is 3.2x at ~2%.  Default off —
    every exactness-pinned path passes ``coarsen=None``.
    """

    granularity: float = 1.0  # target macro-jobs per lane in the bulk
    tail_lanes: int = 3  # exact per-patch jobs kept at stage end, x lanes
    k_max: int = 32  # macro-job size ceiling


def chunk_plan(n_patches: int, n_lanes: int, cfg: CoarsenConfig | None) -> tuple:
    """Static (K, n_bulk) macro-job plan for one stage; (1, 0) means exact.

    K is chosen so the bulk leaves ~``granularity * n_lanes`` macro-jobs
    (enough to keep every lane fed), capped at ``k_max``; the plan degrades
    to exact whenever the stage is too small to leave >= 2 bulk chunks."""
    if cfg is None:
        return (1, 0)
    target = max(1, int(round(cfg.granularity * n_lanes)))
    k = max(1, min(int(cfg.k_max), int(n_patches) // target))
    tail = min(int(n_patches), int(cfg.tail_lanes) * int(n_lanes))
    nb = max(0, (int(n_patches) - tail) // k)
    if k == 1 or nb < 2:
        return (1, 0)
    return (k, nb)


def _chunk_services(xp, svc, plan):
    """Aggregate (P, B) per-patch services into the planned macro-jobs.

    The K-way sum is an explicit left fold, so every engine accumulates
    in the identical order (library ``sum`` reduction trees differ)."""
    k, nb = plan
    if nb == 0:
        return svc
    head = svc[: nb * k].reshape((nb, k) + svc.shape[1:])
    acc = head[:, 0]
    for j in range(1, k):
        acc = acc + head[:, j]
    return xp.concatenate([acc, svc[nb * k :]], axis=0)


def _request_step(xp, job_scan, stages, xfer, concurrency, collect, carry, inp):
    """Run one request through every stage against the carried pool state.

    ``stages``: sequence of (cycles (S, B), b_mask (B,)) per layer;
    ``xfer``: (L,) per-stage entry transfer delay (multi-chip placement), or
    None for the flat fabric — when present, the request's clock advances by
    ``xfer[l]`` before stage ``l`` dispatches, the identical IEEE add the
    event engine performs in ``FabricSim._dispatch_stage``;
    ``carry``: (per-layer free tensors, completion ring buffer);
    ``inp``: (request index, open-loop arrival time, per-layer (P,) sample
    indices).  Closed loop (``concurrency`` not None) reads the arrival from
    the ring: request r enters when request r - concurrency completed (slots
    before the first wrap hold the 0.0 init = the initial admissions).

    ``collect=True`` carries two extra per-layer tuples of 0-d accumulators
    (busy, wait) through the scan: the utilization / duty-cycle telemetry.
    """
    if collect:
        frees, ring, busy, wait = carry
    else:
        frees, ring = carry
    r, t_arr, idx = inp
    if concurrency is None:
        t = t_arr
    else:
        pos = r % concurrency
        t = ring[pos]
    t0 = t
    new_frees = []
    for li, ((cycles, b_mask), free, ix) in enumerate(zip(stages, frees, idx)):
        if xfer is not None:
            t = t + xfer[li]
        svc = cycles[ix]  # (P, B) this request's sampled per-block cycles
        if collect:
            free, t, b_l, w_l = pool_dispatch(
                xp, job_scan, free, t, svc, b_mask, collect=True
            )
            busy = busy[:li] + (busy[li] + b_l,) + busy[li + 1 :]
            wait = wait[:li] + (wait[li] + w_l,) + wait[li + 1 :]
        else:
            free, t = pool_dispatch(xp, job_scan, free, t, svc, b_mask)
        new_frees.append(free)
    if concurrency is not None:
        ring = xp.where(xp.arange(ring.shape[0]) == pos, t, ring)
    if collect:
        return (tuple(new_frees), ring, busy, wait), (t0, t)
    return (tuple(new_frees), ring), (t0, t)


def _tree_blocks(xs, nb, w):
    """Reshape each leaf (N, ...) -> (nb, w, ...) over the first nb*w rows."""
    if isinstance(xs, tuple):
        return tuple(_tree_blocks(x, nb, w) for x in xs)
    return xs[: nb * w].reshape((nb, w) + xs.shape[1:])


def _tree_tail(xs, lo):
    if isinstance(xs, tuple):
        return tuple(_tree_tail(x, lo) for x in xs)
    return xs[lo:]


def _scan_windowed(xp, scan, body, carry, xs, n, window):
    """Blocked request scan: ``window`` sequential ``body`` steps per scan
    step, cutting the scan length N -> N/W (+ a W=1 epilogue for the
    remainder).  The block body unrolls the SAME per-request step in the
    same order — only the loop-carried structure changes — so results are
    bit-identical to the W=1 scan for every W (pinned in tests).  Handles
    bodies that emit no ys (the streaming fleet kernel)."""
    w = max(1, min(int(window), n if n else 1))
    nb = n // w if w > 1 else 0
    parts = []
    if nb > 0:

        def block(c, blk):
            ys = []
            for j in range(w):
                c, y = body(c, _tree_index(blk, j))
                ys.append(y)
            if ys[0] is None:
                return c, None
            return c, tuple(
                xp.stack([y[k] for y in ys]) for k in range(len(ys[0]))
            )

        carry, ys = scan(block, carry, _tree_blocks(xs, nb, w))
        if ys is not None:
            # (nb, w, ...) -> (nb * w, ...) restores request-major order
            parts.append(tuple(y.reshape((nb * w,) + y.shape[2:]) for y in ys))
        done = nb * w
    else:
        done = 0
    if done < n:
        carry, ys = scan(body, carry, _tree_tail(xs, done))
        if ys is not None:
            parts.append(ys)
    if not parts:
        return carry, None
    if len(parts) == 1:
        return carry, parts[0]
    return carry, tuple(
        xp.concatenate([p[k] for p in parts]) for k in range(len(parts[0]))
    )


def run_fabric_kernel(
    xp, scan, stages, frees, arrivals, idx, concurrency, percentiles,
    job_scan=None, xfer=None, collect_stats=False, window=1, return_state=False,
):
    """Whole-run recurrence: scan ``_request_step`` over requests, then
    reduce per-request latencies to percentiles: a plain loop in the numpy
    engine.  ``job_scan`` (defaults to
    ``scan``) drives the inner per-job loop; ``xfer`` is this config's (L,)
    stage transfer vector (or None for the flat fabric).

    ``window`` processes W requests per scan step (``_scan_windowed``),
    exploiting the non-overtaking property to shorten the scan N -> N/W
    bit-identically; the window auto-clamps to the closed-loop concurrency,
    where admission forces request k to wait on request k - concurrency and
    a wider block buys nothing.

    ``collect_stats=True`` returns two extra (L,) vectors — total busy
    (service) cycles and queue-wait cycles per layer, accumulated through
    the scan carry.  They reconcile with the event engine's ``PoolStats``
    counters to float64 summation-order tolerance (scalar ``+=`` there vs.
    ``xp.sum`` here); completions/percentiles are bit-identical either way.

    ``return_state=True`` appends the final (frees, ring) carry to the
    outputs — the hook segmented replay uses to hand lane state across
    control-interval boundaries.
    """
    n = arrivals.shape[0]
    ring = xp.zeros(concurrency if concurrency is not None else 1)
    from functools import partial

    body = partial(
        _request_step, xp, job_scan or scan, stages, xfer, concurrency, collect_stats
    )
    if concurrency is not None:
        window = min(int(window), int(concurrency))
    if collect_stats:
        zeros = tuple(xp.zeros(()) for _ in stages)
        carry0 = (frees, ring, zeros, zeros)
    else:
        carry0 = (frees, ring)
    carry, (t_arr, comp) = _scan_windowed(
        xp, scan, body, carry0, (xp.arange(n), arrivals, idx), n, window
    )
    lat = comp - t_arr
    pct = percentile_kernel(xp, lat, percentiles)
    out = (t_arr, comp, pct)
    if collect_stats:
        out = out + (xp.stack(carry[2]), xp.stack(carry[3]))
    if return_state:
        out = out + (carry[0], carry[1])
    return out


def _tree_index(xs, j):
    if isinstance(xs, tuple):
        return tuple(_tree_index(x, j) for x in xs)
    return xs[j]


def _tree_len(xs):
    while isinstance(xs, tuple):
        xs = xs[0]
    return len(xs)


def _np_scan(f, init, xs):
    """``lax.scan`` semantics for numpy: xs is a (possibly nested) tuple of
    arrays sliced along axis 0; ys stacked (or None)."""
    n = _tree_len(xs)
    carry = init
    ys = []
    for j in range(n):
        carry, y = f(carry, _tree_index(xs, j))
        if y is not None:
            ys.append(y)
    if not ys:
        return carry, None
    if isinstance(ys[0], tuple):
        return carry, tuple(np.stack([y[k] for y in ys]) for k in range(len(ys[0])))
    return carry, np.stack(ys)


# --------------------------------------------------------------- packing
@spanned("vt.draw", host=True)
def sample_service_indices(rng: np.random.Generator, dims, n_requests: int):
    """Per-layer (N, ppi) sample-row indices, drawn layer-major.

    ``dims`` = [(S_l, ppi_l)] per stage.  Both ``FabricSim`` and the
    virtual-time paths draw through this helper with the same generator
    state, so all engines see identical service times per (request, patch).
    """
    tel = get_telemetry()
    if tel.enabled:
        tel.count("vt.indices", int(n_requests) * sum(int(ppi) for _, ppi in dims))
    return [
        rng.integers(0, s, size=(int(n_requests), int(ppi))) for s, ppi in dims
    ]


def _hash_salt(seed: int, layer: int) -> int:
    """Per-(seed, layer) salt for ``hash_service_indices`` — plain python
    int, mixed host-side so the kernel hashes only (request, patch)."""
    return (int(seed) * 0x9E3779B9 + (int(layer) + 1) * 0xC2B2AE35) & 0xFFFFFFFF


def hash_service_indices(xp, salt, r, n_patches, n_samples):
    """Counter-based service-sample indices: a splitmix-style uint32 hash of
    (salt, request, patch), evaluated in-kernel.

    Presampling (``sample_service_indices``) materializes per-layer (N, ppi)
    int64 tensors — tens of GB at fleet scale (10^6 requests x ~1.5k patches)
    — so the streaming replay derives each request's indices on the fly
    instead.  Pure uint32 array arithmetic (multiply/xor/shift wrap
    identically in every engine), so every engine sees the same indices:
    ``r`` may be a traced scalar (one request inside the scan) or an (N,)
    vector (``FabricSim``'s vectorized draw); the result broadcasts to
    ``r.shape + (n_patches,)``.  The final modulo is bias-free whenever
    ``n_samples`` is a power of two (the profiler's sample counts are) and
    biased by < n_samples/2^32 otherwise.
    """
    u = xp.uint32
    r32 = xp.asarray(r).astype(u)[..., None]
    p = xp.arange(n_patches, dtype=u)
    h = (p + u(1)) * u(0x9E3779B9)
    h = h + (r32 + u(1)) * u(0x85EBCA6B) + u(salt)
    h = h ^ (h >> 16)
    h = h * u(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * u(0x846CA68B)
    h = h ^ (h >> 16)
    return (h % u(n_samples)).astype(xp.int32)


@dataclass(frozen=True)
class _GroupPack:
    """One homogeneous (dataflow, zskip) sub-batch of allocations."""

    rows: np.ndarray  # (C,) indices into the caller's allocation list
    layerwise: bool
    zskip: bool
    stages: tuple  # per layer (cycles (S, B) float64, b_mask (B,) bool)
    frees: tuple  # per layer (C, B, D) float64 initial free-times
    xfer: np.ndarray | None = None  # (C, L) per-stage entry transfers


def _pack_group(
    spec: NetworkSpec, cyc, layerwise: bool, allocs, lane_quantum: int = 1
) -> tuple:
    """Dense per-layer (cycles, b_mask) + per-config (C, B, D) free tensors.

    ``lane_quantum`` rounds each layer's lane count D up to a multiple, so
    callers that re-pack slowly-growing allocations (the oracle refinement
    loop) keep stable shapes and reuse compiled kernels."""
    stages, frees = [], []
    for i, layer in enumerate(spec.layers):
        if layerwise:
            cycles = cyc[i].max(axis=1, keepdims=True)  # (S, 1) barrier
            b_mask = np.ones(1, dtype=bool)
            dups = np.asarray(
                [int(a.layer_dups[i]) for a in allocs], dtype=np.int64
            )[:, None]  # (C, 1)
        else:
            cycles = cyc[i]  # (S, B)
            b_mask = np.ones(layer.n_blocks, dtype=bool)
            dups = np.stack(
                [np.asarray(a.block_dups[i], dtype=np.int64) for a in allocs]
            )  # (C, B)
        q = max(1, int(lane_quantum))
        D = -(-int(dups.max()) // q) * q
        free = np.where(
            np.arange(D) < dups[:, :, None], 0.0, np.inf
        )  # (C, B, D)
        stages.append((np.ascontiguousarray(cycles, dtype=np.float64), b_mask))
        frees.append(free)
    return tuple(stages), tuple(frees)


def _split_by_padded_cost(spec, allocs, rows, layerwise) -> list[list[int]]:
    """Partition same-shape configs so lane padding stays bounded.

    The dense (C, B, D) free tensors pad every config to the sub-batch max
    lanes per layer, so one heavily-replicated allocation (a low-load
    latency-aware reshape, say) would inflate the scan cost of the whole
    batch.  Greedily chain configs in order of their own padded cost and cut
    a new sub-group when a config is more than 1.5x the sub-group's first —
    bounding the padding waste at ~1.5x for a few extra calls.
    """

    def padded_cost(a):
        # per-job scan work: patches (scan steps) x lanes touched per step
        if layerwise:
            return float(
                sum(
                    l.patches_per_image * int(a.layer_dups[i])
                    for i, l in enumerate(spec.layers)
                )
            )
        return float(
            sum(
                l.patches_per_image * l.n_blocks * int(np.max(a.block_dups[i]))
                for i, l in enumerate(spec.layers)
            )
        )

    costs = {j: padded_cost(allocs[j]) for j in rows}
    order = sorted(rows, key=lambda j: costs[j])
    subs: list[list[int]] = []
    for j in order:
        if subs and costs[j] <= 1.5 * max(costs[subs[-1][0]], 1.0):
            subs[-1].append(j)
        else:
            subs.append([j])
    return subs


def variant_table(cycles: torch.Tensor, layerwise: bool) -> torch.Tensor:
    """One layer's (S, B) service table for VT: the per-(patch, block)
    cycles, or for the layer-wise dataflow each patch's barrier
    ``max_b cycles[p, b]`` on pool 0 and zeros elsewhere (those pools hold
    no servers).  The barrier values are those of ``_pack_group``'s (S, 1)
    table and of the reference's fused gather (``dse/fused.py:676-694``)."""
    if not layerwise:
        return cycles
    out = torch.zeros_like(cycles)
    out[:, 0] = cycles.amax(dim=1)
    return out


def lanes_of(blocks, dups, layerwise) -> np.ndarray:
    """(C, sum_l B_l) servers per pool, layer by layer, from (C, L, B)
    duplicates (B: at least every layer's B_l): a block-wise config's
    replicas, or a layer-wise one's (``layerwise``) duplicates of block 0
    on each layer's pool 0 (its other pools get none)."""
    dups = np.asarray(dups, dtype=np.int64)
    pool = np.arange(dups.shape[2])
    d = np.where(np.asarray(layerwise, dtype=bool)[:, None, None] & (pool > 0), 0, dups)
    return d[:, pool[None, :] < np.asarray(blocks)[:, None]]


def _alloc_dups(spec: NetworkSpec, allocs) -> tuple:
    """(C, L, B) duplicates of allocations (a layer-wise one's on every
    block) and their (C,) layer-wise flags."""
    blocks = [l.n_blocks for l in spec.layers]
    dups = np.zeros((len(allocs), len(blocks), max(blocks)), dtype=np.int64)
    for c, a in enumerate(allocs):
        for i, b in enumerate(blocks):
            dups[c, i, :b] = a.layer_dups[i] if a.layer_dups is not None else a.block_dups[i]
    return dups, np.asarray([a.layer_dups is not None for a in allocs])


def pool_lanes(spec: NetworkSpec, alloc: Allocation) -> np.ndarray:
    """(sum_l B_l,) servers per pool of one allocation (``lanes_of``)."""
    return lanes_of([l.n_blocks for l in spec.layers], *_alloc_dups(spec, [alloc]))[0]


@spanned("vt.upload")
def upload_indices(idx, device: torch.device) -> torch.Tensor:
    """Per-layer (N, P_l) sample indices as VT's flat int32 buffer on
    ``device``: layer after layer (``service_draw``'s layout), one host
    buffer, pinned for a card, and one copy."""
    tel = get_telemetry()
    with tel.span("vt.pack_indices", host=True):
        flat = np.concatenate([np.asarray(i).ravel() for i in idx]).astype(np.int32, copy=False)
    tel.count("vt.upload_bytes", flat.nbytes)
    return to_device(device, flat)[0]


def service_indices(seed: int, dims, n_requests: int, device: torch.device) -> torch.Tensor:
    """``upload_indices(sample_service_indices(default_rng(seed), dims, n),
    device)``, the same flat int32 buffer: on a CUDA device drawn there
    (``kernels.service_draw``: the layers whose S is a power of two or 1 by
    the kernel, the others by numpy from their start state and copied with
    the launch's input), on any other by the host.

    On the card ``vt.draw`` holds the plan, the host's layers and the
    launch (not mirrored: it encloses a launch), ``vt.upload`` only the
    host's layers' copy; ``vt.indices`` counts every index,
    ``vt.indices_device`` those the kernel wrote."""
    if device.type != "cuda":
        return upload_indices(sample_service_indices(np.random.default_rng(seed), dims, n_requests), device)
    tel = get_telemetry()
    with tel.span("vt.draw"):
        plan = _draw.draw_plan(seed, dims, n_requests)
        host = upload_indices([plan.host], device) if plan.host.size else None
        flat = _draw.service_draw(plan, host, torch.empty(plan.total, dtype=torch.int32, device=device))
    if tel.enabled:
        tel.count("vt.indices", plan.total)
        tel.count("vt.indices_device", plan.total - plan.host.size)
    return flat


# ----------------------------------------------------------------- results
class VTInputs(NamedTuple):
    """VT's input for a batch of allocations (``VirtualTimeFabric.vt_inputs``)."""

    tables: VTTables  # the (dataflow, zero-skip) variants the batch holds
    variant: np.ndarray  # (C,) int32: each allocation's
    lanes: np.ndarray  # (C, sum_l B_l) servers per pool (pool_lanes)
    dims: tuple  # (S_l, P_l) per layer: the draw's


@dataclass(frozen=True)
class VTResult:
    """Structure-of-arrays fabric outcome for C (allocation, trace) pairs."""

    arrivals: np.ndarray  # (C, N) cycles
    completions: np.ndarray  # (C, N) cycles
    percentiles: np.ndarray  # (C, P) latency percentiles, cycles
    percentile_qs: tuple  # the P percentile levels
    clock_hz: float = CLOCK_HZ
    # telemetry (run_batch(collect_stats=True) only): per-layer service and
    # queue-wait job-cycles accumulated by the engine; they reconcile with
    # FabricSim(stats=True)'s PoolStats at rtol 1e-9
    layer_busy: np.ndarray | None = None  # (C, L)
    layer_wait: np.ndarray | None = None  # (C, L)

    def __len__(self) -> int:
        return self.completions.shape[0]

    @property
    def latencies(self) -> np.ndarray:  # (C, N)
        return self.completions - self.arrivals

    def percentile(self, q: float) -> np.ndarray:  # (C,)
        return self.percentiles[:, self.percentile_qs.index(q)]

    @property
    def p99(self) -> np.ndarray:
        return self.percentile(99.0)

    def latency(self, i: int) -> LatencyStats:
        return latency_stats(self.latencies[i])

    def latency_ms(self, i: int) -> LatencyStats:
        return self.latency(i).scaled(1e3 / self.clock_hz)

    @property
    def images_per_sec(self) -> np.ndarray:  # (C,)
        return np.asarray(
            [steady_throughput(c, clock_hz=self.clock_hz) for c in self.completions]
        )


class VirtualTimeFabric:
    """Batched fabric evaluation of (allocation, arrival-trace) pairs.

    ``engine="torch"`` runs every pair of a call in one VT launch on
    ``device`` (VT's plain PyTorch version when ``device`` is the CPU);
    ``engine="numpy"`` runs the reference's kernel functions per config on
    the host, grouped by (layerwise, zero-skipping) as the reference groups
    its jit calls (``lane_quantum`` pads their lanes, which changes no
    result).  Cycle tables are read from the profile once into float64
    numpy and, for VT, packed on the device for each set of variants a
    batch holds (``vt_inputs``), kept for the instance's life.
    """

    def __init__(
        self,
        spec: NetworkSpec,
        prof: NetworkProfile,
        *,
        live_prof: NetworkProfile | None = None,
        clock_hz: float = CLOCK_HZ,
        lane_quantum: int = 1,
        device: str | torch.device = "cuda",
    ):
        self.spec = spec
        self.prof = prof
        self.live_prof = live_prof
        self.clock_hz = clock_hz
        self.lane_quantum = int(lane_quantum)
        self.device = resolve_device(device)
        self._cyc = {
            z: _layer_patch_cycles(live_prof or prof, z) for z in (False, True)
        }
        # the draw's (S_l, P_l) per layer: the profile's, whatever the dataflow or zero-skipping
        self.dims = tuple((int(c.shape[0]), int(l.patches_per_image)) for c, l in zip(self._cyc[True], spec.layers))
        self._tables: dict[tuple, VTTables] = {}

    # ------------------------------------------------------------- internals
    def _groups(self, allocs, placements=None) -> list[_GroupPack]:
        keys: dict[tuple, list[int]] = {}
        for j, a in enumerate(allocs):
            keys.setdefault((a.layer_dups is not None, a.policy != "baseline"), []).append(j)
        out = []
        for (layerwise, zskip), rows in keys.items():
            for sub in _split_by_padded_cost(self.spec, allocs, rows, layerwise):
                stages, frees = _pack_group(
                    self.spec, self._cyc[zskip], layerwise,
                    [allocs[j] for j in sub],
                    lane_quantum=self.lane_quantum,
                )
                xfer = (
                    None
                    if placements is None
                    else np.ascontiguousarray(
                        np.stack(
                            [
                                np.asarray(
                                    placements[j].stage_transfer, dtype=np.float64
                                )
                                for j in sub
                            ]
                        )
                    )
                )
                out.append(
                    _GroupPack(np.asarray(sub), layerwise, zskip, stages, frees, xfer)
                )
        return out

    def _variant_tables(self, keys: tuple) -> VTTables:
        """VT's tables on the device, variant v of the (layerwise, zskip)
        pair ``keys[v]``."""
        hit = self._tables.get(keys)
        if hit is None:
            hit = self._tables[keys] = vt_tables(
                [torch.stack([variant_table(torch.from_numpy(self._cyc[z][i]), lw) for lw, z in keys])
                 for i in range(len(self.spec.layers))], self.device)
        return hit

    def vt_inputs(self, allocs) -> VTInputs:
        """VT's input for a batch of allocations: the packed tables of the
        (dataflow, zero-skip) variants it holds, each allocation's variant
        and servers per pool (host arrays), and the draw's dims."""
        with get_telemetry().span("vt.configs", host=True):
            kind = [(a.layer_dups is not None, a.policy != "baseline") for a in allocs]
            keys = tuple(sorted(set(kind)))
            variant = np.asarray([keys.index(k) for k in kind], dtype=np.int32)
            lanes = lanes_of([l.n_blocks for l in self.spec.layers], *_alloc_dups(self.spec, allocs))
        return VTInputs(self._variant_tables(keys), variant, lanes, self.dims)

    def _run_torch(self, allocs, placements, times, concurrency, idx, collect_stats):
        dev = self.device
        inp = self.vt_inputs(allocs)
        xfer = None
        if placements is not None:
            xfer = np.stack(
                [np.asarray(p.stage_transfer, dtype=np.float64) for p in placements]
            )
            xfer = torch.as_tensor(xfer, device=dev)
        t_arr, comp, busy, wait = vtime_scan(
            inp.tables,
            idx,
            [p for _, p in inp.dims],
            inp.variant,
            inp.lanes,
            n_requests=times.shape[1],
            arrivals=None if concurrency is not None else torch.as_tensor(times, device=dev),
            concurrency=concurrency,
            xfer=xfer,
            collect_stats=collect_stats,
        )
        with get_telemetry().span("vt.wait"):
            out = tuple(None if x is None else x.cpu().numpy() for x in (t_arr, comp, busy, wait))
            count_deep_inserts()
            return out

    # ------------------------------------------------------------------ run
    @spanned("vt.run_batch")
    def run_batch(
        self,
        allocs,
        proc: ArrivalProcess | list,
        *,
        seed: int = 0,
        engine: str = "torch",
        percentiles: tuple = (50.0, 95.0, 99.0),
        placements: list | None = None,
        collect_stats: bool = False,
        window: int = 1,
    ) -> VTResult:
        """Evaluate C allocations against one shared arrival process (or a
        per-allocation list of same-kind processes).  Service times are
        sampled once with ``default_rng(seed)``: the same draws every
        ``FabricSim(spec, prof, alloc, seed=seed)`` would consume.

        ``placements`` (one object per allocation with a ``stage_transfer``
        (L,) vector, or None for the flat fabric) adds each config's
        per-stage entry transfer delays, bit-identical to
        ``FabricSim(placement=...)``.

        ``collect_stats=True`` additionally fills ``VTResult.layer_busy`` /
        ``layer_wait`` (C, L); completions and percentiles are bit-identical
        with the flag on or off.

        ``window`` blocks the numpy engine's request scan W at a time
        (bit-identical for every W); VT takes every request in one launch
        and ignores it."""
        if engine not in ENGINES:
            raise ValueError(f"engine must be 'torch' or 'numpy', got {engine!r}")
        allocs = list(allocs)
        if not allocs:
            raise ValueError("need at least one allocation")
        if placements is not None and len(placements) != len(allocs):
            raise ValueError(
                f"{len(placements)} placements for {len(allocs)} allocations"
            )
        procs = proc if isinstance(proc, list) else [proc] * len(allocs)
        if len(procs) != len(allocs):
            raise ValueError(f"{len(procs)} arrival processes for {len(allocs)} allocations")
        closed = isinstance(procs[0], ClosedLoop)
        if any(isinstance(p, ClosedLoop) != closed for p in procs):
            raise ValueError("cannot mix closed- and open-loop processes in one batch")
        tel = get_telemetry()
        with tel.span("vt.arrivals", host=True):
            if closed:
                concurrency = procs[0].concurrency
                if any(p.concurrency != concurrency or p.n_requests != procs[0].n_requests for p in procs):
                    raise ValueError("closed-loop batch needs identical (n_requests, concurrency)")
                n = procs[0].n_requests
                times = np.zeros((len(allocs), n))
            else:
                concurrency = None
                tlist = [arrival_times(p) for p in procs]
                n = tlist[0].size
                if any(t.size != n for t in tlist):
                    raise ValueError("all arrival traces in a batch need the same length")
                times = np.stack(tlist).astype(np.float64)

        # one draw shared by every config
        if engine == "torch":
            idx = service_indices(seed, self.dims, n, self.device)
        else:
            idx = sample_service_indices(np.random.default_rng(seed), self.dims, n)

        C = len(allocs)
        L = len(self.spec.layers)
        qs = tuple(percentiles)
        if n == 0:
            z = np.zeros((C, L)) if collect_stats else None
            return VTResult(
                np.zeros((C, 0)), np.zeros((C, 0)), np.zeros((C, len(qs))), qs,
                self.clock_hz, layer_busy=z, layer_wait=z,
            )
        if engine == "torch":
            arrivals, completions, busy, wait = self._run_torch(
                allocs, placements, times, concurrency, idx, collect_stats
            )
            with tel.span("vt.percentiles", host=True):
                lat = completions - arrivals
                pcts = np.stack([percentile_kernel(np, lat[k], qs) for k in range(C)])
            return VTResult(
                arrivals, completions, pcts, qs, self.clock_hz,
                layer_busy=busy, layer_wait=wait,
            )
        arrivals = np.zeros((C, n))
        completions = np.zeros((C, n))
        pcts = np.zeros((C, len(qs)))
        busy = np.zeros((C, L)) if collect_stats else None
        wait = np.zeros((C, L)) if collect_stats else None
        for g in self._groups(allocs, placements):
            for k, row in enumerate(g.rows):
                frees = tuple(f[k].copy() for f in g.frees)
                out = run_fabric_kernel(
                    np, _np_scan, g.stages, frees, times[row],
                    tuple(idx), concurrency, qs,
                    xfer=None if g.xfer is None else g.xfer[k],
                    collect_stats=collect_stats, window=window,
                )
                arrivals[row], completions[row], pcts[row] = out[:3]
                if collect_stats:
                    busy[row] = np.asarray(out[3])
                    wait[row] = np.asarray(out[4])
        return VTResult(
            arrivals, completions, pcts, qs, self.clock_hz,
            layer_busy=busy, layer_wait=wait,
        )


# ------------------------------------------------- fabric-oracle refinement
def provision_latency_aware(
    spec: NetworkSpec,
    prof: NetworkProfile,
    n_pes: int,
    *,
    offered_ips: float | None = None,
    load_frac: float = 0.7,
    arrays_per_pe: int | None = None,
    proc: ArrivalProcess | list | None = None,
    calib_requests: int = 250,
    calib_seeds: tuple = (101, 211),
    margin: float = 0.02,
    grants: int = 8,
    seed: int = 0,
    percentile: float = 99.0,
    engine: str = "torch",
    vt: "VirtualTimeFabric | None" = None,
    device: str | torch.device = "cuda",
) -> Allocation:
    """Serving-oriented allocation: provision a fabric for traffic, not peak.

      1. build the paper's throughput allocation (``blockwise``) and the
         tail-weighted analytic allocation (``latency_aware`` =
         ``queueing_allocate``) at the same PE budget;
      2. measure both on a calibration workload with one batched
         virtual-time call per trace (``proc``, defaulting to open-loop
         Poisson traces at the offered load) and keep the measured-p99
         winner: the analytic shape is taken only where the measurement
         agrees it pays by more than ``margin``;
      3. spend any arrays the winner's greedy left stranded with the
         fabric-oracle (``refine_latency_aware``).

    Returns a block-wise ``Allocation`` with policy ``latency_aware``.  A
    ``VirtualTimeFabric`` made here runs on ``device``.
    """
    from ..core.cim.simulate import ARRAYS_PER_PE, allocate, simulate

    app = ARRAYS_PER_PE if arrays_per_pe is None else arrays_per_pe
    bw = allocate(spec, prof, "blockwise", n_pes, app)
    if offered_ips is None:
        offered_ips = load_frac * simulate(spec, prof, bw).images_per_sec
    la = allocate(
        spec, prof, "latency_aware", n_pes, app, offered_ips=offered_ips
    )
    if proc is None:
        rate = float(offered_ips) / CLOCK_HZ
        procs = [
            PoissonOpen(int(calib_requests), rate, seed=s) for s in calib_seeds
        ]
    else:
        procs = proc if isinstance(proc, list) else [proc]
    if vt is None:
        vt = VirtualTimeFabric(spec, prof, lane_quantum=8, device=device)
    cands = [
        Allocation("latency_aware", None, bw.block_dups, bw.arrays_used, bw.arrays_total),
        la,
    ]
    p = np.zeros(len(cands))
    for k, pr in enumerate(procs):
        res = vt.run_batch(cands, pr, seed=seed + k, engine=engine, percentiles=(percentile,))
        p += res.percentiles[:, 0]
    # deviate from the throughput shape only on a decisive calibration win
    best = la if p[1] < p[0] * (1.0 - margin) else cands[0]
    if grants > 0 and best.arrays_total - best.arrays_used > 0:
        best = refine_latency_aware(
            spec, prof, best, procs, grants=grants, seed=seed,
            percentile=percentile, engine=engine, vt=vt,
        )
    return best


def refine_latency_aware(
    spec: NetworkSpec,
    prof: NetworkProfile,
    alloc: Allocation,
    proc: ArrivalProcess,
    *,
    grants: int = 16,
    candidates: int = 24,
    seed: int = 0,
    percentile: float = 99.0,
    engine: str = "torch",
    vt: "VirtualTimeFabric | None" = None,
    device: str | torch.device = "cuda",
) -> Allocation:
    """Greedy fabric-oracle refinement of a block-wise allocation.

    Each round evaluates, in one batched virtual-time call per calibration
    trace, the current allocation plus the ``candidates`` most promising
    affordable +1-replica moves (shortlisted by analytic marginal drain
    reduction per array), and grants the block with the best *measured*
    p``percentile`` reduction per array on the calibration workload
    ``proc``.  Stops after ``grants`` rounds, when nothing is affordable, or
    when no candidate improves the tail.  A ``VirtualTimeFabric`` made here
    runs on ``device``.
    """
    if alloc.block_dups is None:
        raise ValueError("fabric-oracle refinement requires a block-wise allocation")
    procs = proc if isinstance(proc, list) else [proc]
    if vt is None:
        vt = VirtualTimeFabric(spec, prof, lane_quantum=8, device=device)
    table = spec.block_table()  # (n_blocks, 3): layer, block-in-layer, width
    cost = table[:, 2].astype(np.int64)
    cyc = _layer_patch_cycles(prof, alloc.policy != "baseline")
    base_lat = np.concatenate(
        [c.mean(axis=0) * l.patches_per_image for c, l in zip(cyc, spec.layers)]
    )
    dups = [np.asarray(d, dtype=np.int64).copy() for d in alloc.block_dups]
    used, total = int(alloc.arrays_used), int(alloc.arrays_total)

    def mk(d, arrays_used):
        return Allocation(alloc.policy, None, [x.copy() for x in d], arrays_used, total)

    pq = (percentile,)
    for _ in range(int(grants)):
        budget = total - used
        flat = np.concatenate(dups).astype(np.float64)
        afford = np.flatnonzero(cost <= budget)
        if afford.size == 0:
            break
        # shortlist by analytic marginal drain reduction per array
        marg = (base_lat[afford] / flat[afford] - base_lat[afford] / (flat[afford] + 1)) / cost[afford]
        cand = afford[np.argsort(-marg, kind="stable")[: int(candidates)]]
        batch = [mk(dups, used)]
        for j in cand:
            li, bi = int(table[j, 0]), int(table[j, 1])
            d = [x.copy() for x in dups]
            d[li][bi] += 1
            batch.append(mk(d, used + int(cost[j])))
        # average the measured tail over the calibration traces (a list of
        # procs reduces single-trace overfit); one batched call per trace
        p = np.zeros(len(batch))
        for k, pr in enumerate(procs):
            res = vt.run_batch(batch, pr, seed=seed + k, engine=engine, percentiles=pq)
            p += res.percentiles[:, 0]
        p /= len(procs)
        gain = (p[0] - p[1:]) / cost[cand]
        best = int(np.argmax(gain))
        if gain[best] <= 0:
            break
        j = cand[best]
        li, bi = int(table[j, 0]), int(table[j, 1])
        dups[li][bi] += 1
        used += int(cost[j])
    return mk(dups, used)

"""VT: the virtual-time scan of the fabric engines, one launch per call.

The reference runs its batched fabric engine as one ``jax.jit(jax.vmap(...))``
of ``run_fabric_kernel`` per sub-batch (``src/repro/fabric/vtime.py:629-674``),
whose loop over requests and jobs is a ``lax.scan`` on the device.  No
Pallas kernel is involved, but the recurrence is serial in jobs (1,448 a
VGG11 request, 30,233 a ResNet18 one), so in eager PyTorch it would cost five
to seven launches a job.  ``vtime_scan`` is its counterpart: one launch of
``csrc/vtime_scan.cu`` for C (allocation, trace) pairs, a thread-block
cluster per pair.

The problem, for config c: layer l has B_l pools, pool p holding
``lanes[c, off_l + p]`` servers (0 for a pool that is not used).  Request r
brings P_l jobs to every pool of layer l, job j with service time
``table_l[variant[c], idx_l[r, j], p]``; pools are FIFO over sorted server
free-times (``fabric.vtime.dispatch_step``), a layer completes at its last
job's end (at least its ready time), and the next layer starts then, after
the stage transfer ``xfer[c, l]`` when given.  Requests arrive at
``arrivals[c, r]`` (open loop) or at the completion of request
``r - concurrency`` (closed loop).  Out: per request its arrival and
completion (C, N); with ``collect_stats`` the service cycles and queue waits
per layer (C, L).  Completions are bit-identical to ``FabricSim`` and to the
numpy engine; the two sums agree with the numpy engine to rtol 1e-12 (their
order differs).  Service times are cycles, so both versions take them >= 0
(the kernel's insert relies on it).  A pool holds at most ``MAX_LANES`` =
65,536 servers: up to 1,024 a warp keeps them in registers, above that its
lanes stay in the pool state (shared memory when it fits, else a global
scratch row) and each job rewrites them a row of 32 at a time.

What bounds it is the critical path, not the sum of the jobs: (r, l)
needs (r, l-1) (its ready time) and (r-1, l) (the pools' state), and a
closed loop adds (r - concurrency, L-1) before (r, 0); ``critical_path``
is the longest path through that grid.  So a config's layers run as a
wavefront: ``kernel_plan`` splits them into S <= 8 contiguous stages
(balancing each layer's jobs times the cost a job of its widest pool; one
pass of ``stage_splits``' DP holds every S's split), one block of the
config's cluster each, which hand every request to the next stage through
distributed shared memory.  Arrivals, completions and the carried state do
not depend on S.

``vtime_stream`` is the second entry of the same source: the fleet's
streaming replay (the reference's ``_run_stream_kernel``,
``src/repro/fabric/fleet.py:104-164``), one launch per segment.  It runs the
same stages over requests whose sample indices are hashed in the kernel
(``fabric.vtime.hash_service_indices``; there is no (N, P) index tensor) or
given, whose jobs may be macro-jobs (``_chunk_services``: a left fold of K
patches, then the exact tail), and folds each latency into the log-bucket
sketch, min / max, Welford mean / m2 and the horizon
(``fabric.metrics.sketch_update``).  Lane state, ring, sketch and horizon
(``StreamState``) come from the caller and go back to it, so a segment's
launch continues the previous one, whatever either's S; each stage reads
and writes back only its own pools' lanes.  ``vtime_stream_ref`` is its
plain version.  The reference's ``window`` blocks its scan and changes no
bit; the launch takes every request in order and has no such argument.

This module alone knows the layout the kernel reads.  ``vt_tables`` packs
the per-layer (V, S_l, B_l) tables once, checked, into one flat float64
buffer with each (layer, variant)'s offset (``VTTables``; callers keep it);
the indices are the draw's flat int32 buffer (``fabric.vtime.service_indices``:
each layer's (N, P_l) after the last), read in place from each layer's
offset in ``meta``; ``variant`` and ``lanes`` are host arrays, checked
there and uploaded with ``meta`` in one copy (``to_device``), and
``kernel_plan`` reads the lanes' host copy.  ``_prepare`` checks what the
two entries share, reading one flag back from the device.

``vtime_scan`` launches the kernel on CUDA tensors (``kernel_plan`` makes
its host-side choices) and runs the plain PyTorch version ``vtime_scan_ref``
on CPU tensors.  The plain version is the same recurrence batched over the
configs, a Python loop over requests and jobs: it is the CPU tests' engine
and ``chip_smoke.py``'s yardstick, and nothing on the card's path calls it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from . import _build

__all__ = [
    "MAX_LANES",
    "StreamState",
    "VTTables",
    "chain_weights",
    "count_deep_inserts",
    "critical_path",
    "kernel_plan",
    "pool_caps",
    "stage_split",
    "stage_splits",
    "stream_dense",
    "stream_flat",
    "stream_state",
    "to_device",
    "vtime_scan",
    "vtime_scan_ref",
    "vtime_stream",
    "vtime_stream_ref",
    "vt_tables",
]

_F64 = torch.float64
MAX_SMEM = 232_448  # the most shared memory one block may use on the card
STATIC_SMEM = 20 * 1024  # the kernel's own shared arrays, kept out of the dynamic memory's room
MAX_LAYERS = 64
MAX_POOLS = 1024
MAX_LANES = 65_536  # servers a pool; a warp holds up to 1,024 in registers
MAX_STAGES = 8  # blocks of a config's cluster (the portable cluster size)
SM_COUNT = 132  # the H100's SMs: with no card asked, S is capped at SM_COUNT // S resident clusters
WARPS = 8  # with no card asked, the warps a block may hold; on the card, the build's launch bound
SMALL_POOL = 8  # pools of at most this many servers run on one thread
CHUNK = 2048  # doubles of service times a staging buffer holds
BUFS = 4  # staging buffers in a stage's ring
ROWS = 1024  # sample rows a streaming loader warp hashes once a chunk (int32 scratch)
LOADER_WARPS = 2  # warps of a VT block that stage service times
STREAM_LOADER_WARPS = 4  # of a streaming block, which also hash and fold macro-jobs
# cycles a job by a pool's lane capacity (pool_caps), and a (request, layer)
# of one job, as chip_smoke.py's vt_lane_costs measured them on the H100
# (PERF.md; a warp pool of 33 to 512 servers merges epochs of jobs: caps 64
# to 512, at the cells' spread; a layer of fewer than 8 epochs' jobs a
# request runs them one by one but is weighed as merged, up to 3.7x light);
# they weigh the layers when kernel_plan splits them into stages (only
# their ratios matter)
JOB_CYCLES = {0: 0.0, 1: 14.0, 2: 31.0, 4: 42.0, 8: 65.0, 32: 85.0, 64: 45.0, 128: 43.0, 256: 40.0, 512: 52.0,
              1024: 345.0}
LAYER_CYCLES = 1720.0


def _telemetry():
    """The recorder in force (``fabric.telemetry``, imported at the call:
    the fabric package imports this module)."""
    from ..fabric.telemetry import get_telemetry

    return get_telemetry()


@functools.cache
def _launcher():
    fn = _build.load("vtime_scan").vtime_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_longlong] + [ctypes.c_int] * 13
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _max_threads_fn():
    fn = _build.load("vtime_scan").vtime_max_threads
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn


class KernelPlan(NamedTuple):
    threads: int  # threads a block
    consumer_warps: int  # warps that run the pools; the other loader_warps stage
    loader_warps: int
    kmax: int  # lanes a thread of the widest pool's warp holds: 1, 4 or 16; 32 with a pool wider than 512
    chunk: int  # doubles of service times a staging buffer holds
    state_stride: int  # doubles of pool state a stage's block holds (its largest stage, its largest config)
    smem_state: bool  # the pool state lives in shared memory
    smem_bytes: int  # dynamic shared memory a block takes
    stages: int  # S: blocks of a config's cluster
    split: tuple  # S + 1 layer indices: stage s runs layers split[s] .. split[s+1] - 1
    stage_weights: tuple  # S: each stage's sum of the layer weights the split balanced


def pool_caps(lanes: np.ndarray) -> np.ndarray:
    """Lanes of state VT gives each pool: the power of two above its servers
    for a pool of at most 8 (one thread runs it), at least 32 above (a warp
    runs it, 32 / 64 / ... lanes), none for a pool without servers."""
    d = np.asarray(lanes, dtype=np.int64)
    pow2 = np.where(d <= 1, 1, 1 << np.ceil(np.log2(np.maximum(d, 1))).astype(np.int64))
    return np.where(d == 0, 0, np.where(d <= SMALL_POOL, pow2, np.maximum(32, pow2)))


def job_cycles(cap: int) -> float:
    """Cycles a job of a pool with ``cap`` lanes of state (``JOB_CYCLES``;
    a pool wider than 1,024 servers rewrites a row of 32 lanes in memory a
    job, about 40 cycles a row)."""
    cap = int(cap)
    return JOB_CYCLES[cap] if cap in JOB_CYCLES else 40.0 * cap / 32


def stage_splits(work, most: int):
    """Every split of layers with ``work`` into 1 to ``most`` contiguous
    non-empty stages whose largest sum of work is least, from one pass of
    the linear-partition DP: the table for k stages depends only on the one
    for k - 1, so a pass to ``most`` stages keeps each k's cuts.  Returns
    ``split(S)``, which reads back the split into S <= ``most`` stages (among
    equal splits, the earliest boundaries): a tuple of S + 1 indices from 0
    to len(work).  Counters ``vt.split_passes`` (a pass) and
    ``vt.split_reads`` (a split read)."""
    w = np.asarray(work, dtype=np.float64)
    L, most = len(w), int(most)
    if not 1 <= most <= L:
        raise ValueError(f"{most} stages for {L} layers")
    tel = _telemetry()
    tel.count("vt.split_passes")
    pre = np.concatenate([[0.0], np.cumsum(w)])
    last = pre[1:, None] - pre[None, 1:]  # [i, j]: layers j+1 .. i, the last stage after a cut at j
    last[np.triu_indices(L)] = np.inf  # j >= i leaves the last stage no layer
    rows = np.arange(L)
    best = pre[1:].copy()  # best[i]: the least largest stage over layers 0..i in k stages
    cuts = [np.zeros(L, dtype=np.int64)]
    for _ in range(1, most):
        v = np.maximum(best[None, :], last)
        j = np.argmin(v, axis=1)  # the first least: the earliest cut among equal splits
        # rows i < k - 1 cannot hold k stages: their best stays inf, so no
        # feasible row's least cuts there, and reading back never reaches them
        best = v[rows, j]
        cuts.append(j + 1)

    def split(S: int) -> tuple:
        S = int(S)
        if not 1 <= S <= most:
            raise ValueError(f"{S} stages for {L} layers")
        tel.count("vt.split_reads")
        out, i = [L], L - 1
        for k in range(S - 1, 0, -1):
            out.append(int(cuts[k][i]))
            i = out[-1] - 1
        return tuple([0] + out[::-1])

    return split


def stage_split(work, stages: int) -> tuple:
    """The split of layers with ``work`` into ``stages`` contiguous non-empty
    stages whose largest sum of work is least (``stage_splits``' split of
    ``stages``): a tuple of stages + 1 indices from 0 to len(work)."""
    return stage_splits(work, stages)(stages)


def kernel_plan(lanes: np.ndarray, blocks, patches, *, jobs=None, stream: bool = False, stages: int | None = None,
                warps=None, clusters=None) -> KernelPlan:
    """VT's host-side choices for (C, pools) lane counts over layers of
    ``blocks`` pools and ``patches`` jobs a request (``jobs``: (C, L) jobs a
    request when macro-jobs change them), for the streaming entry
    (``stream``) or VT:

    * consumer warps with a thread for every small pool of the layer that
      has most and a warp for every pool of more than 8 servers in the layer
      that has most, within the build's warps (``warps(kmax)``: the card's
      answer for the build's launch bound; ``WARPS`` with no card) beside
      ``LOADER_WARPS`` (``STREAM_LOADER_WARPS`` for the streaming entry)
      warps that stage service times;
    * the build for the widest pool (``kmax``; 32 for pools wider than 512);
    * staging buffers of ``CHUNK`` doubles (fewer when no layer needs them,
      at least the widest layer's pools), ``BUFS`` of them;
    * the stages: each layer weighs its most jobs times ``job_cycles`` of
      its widest pool, times the pools a consumer warp (or thread) runs in
      turn, plus ``LAYER_CYCLES``; for S stages the split minimises the
      largest stage's weight (the plan keeps each stage's weight,
      ``stage_weights``), every S's split read from one ``stage_splits``
      pass up to min(``MAX_STAGES``, L) stages (``stages`` when forced),
      and S is the smallest count that reaches the least such weight over
      the counts whose C clusters are all resident at once
      (``clusters(S, plan)``: the device's occupancy
      query; with no card, one block an SM of ``SM_COUNT``), so S = 1 when
      C fills the card.  ``stages`` forces S (tests and measurements only);
    * the pool state of a stage (``pool_caps`` summed over its pools, the
      largest stage and config) in shared memory when it fits."""
    lanes = np.asarray(lanes, dtype=np.int64)
    if lanes.size and lanes.max() > MAX_LANES:
        raise ValueError(f"VT holds at most {MAX_LANES} servers a pool, got {int(lanes.max())}")
    blocks, patches = [int(b) for b in blocks], [int(p) for p in patches]
    L, C = len(blocks), lanes.shape[0]
    caps = pool_caps(lanes)
    offs = np.cumsum(blocks) - blocks
    jobs = np.broadcast_to(np.asarray(patches if jobs is None else jobs, dtype=np.int64), (C, L))
    small, wide, width = [], [], []
    for o, b in zip(offs, blocks):
        d = lanes[:, o : o + b]
        small.append(int(((d >= 1) & (d <= SMALL_POOL)).sum(axis=1).max(initial=0)))
        wide.append(int((d > SMALL_POOL).sum(axis=1).max(initial=0)))
        width.append(int(caps[:, o : o + b].max(initial=0)))
    top = max(width, default=1)
    kmax = 1 if top <= 32 else 4 if top <= 128 else 16 if top <= 512 else 32
    loaders = STREAM_LOADER_WARPS if stream else LOADER_WARPS
    most = warps(kmax) if warps is not None else WARPS
    consumers = min(most - loaders, max(1, -(-max(small) // 32), max(wide)))
    work = [int(jobs[:, l].max(initial=0)) * job_cycles(width[l])
            * max(1, -(-wide[l] // consumers), -(-small[l] // (32 * consumers))) + LAYER_CYCLES for l in range(L)]
    chunk = max(max(blocks), min(CHUNK, max(b * p for b, p in zip(blocks, patches))))
    rows = 4 * ROWS * loaders if stream else 0
    if stages is not None and not 1 <= int(stages) <= min(MAX_STAGES, L):
        raise ValueError(f"{stages} stages: 1 to {min(MAX_STAGES, L)} for {L} layers")
    splits = stage_splits(work, min(MAX_STAGES, L) if stages is None else int(stages))

    def shape(S):
        split = splits(S)
        stride = 1
        for a, b in zip(split[:-1], split[1:]):
            q0, q1 = offs[a], offs[b - 1] + blocks[b - 1]
            stride = max(stride, int(caps[:, q0:q1].sum(axis=1).max(initial=1)))
        smem = 8 * (BUFS * chunk + stride) + rows <= MAX_SMEM - STATIC_SMEM
        return KernelPlan(32 * (consumers + loaders), consumers, loaders, kmax, chunk, stride, smem,
                          8 * (BUFS * chunk + (stride if smem else 0)) + rows, S, split,
                          tuple(float(np.sum(work[a:b])) for a, b in zip(split[:-1], split[1:])))

    if stages is not None:
        return shape(int(stages))
    best = shape(1)
    for S in range(2, min(MAX_STAGES, L) + 1):
        plan = shape(S)
        if (clusters(S, plan) if clusters is not None else SM_COUNT // S) < C:
            break
        if max(plan.stage_weights) < max(best.stage_weights):
            best = plan
    return best


def critical_path(jobs, n_requests: int, concurrency: int | None = None, weights=None) -> float:
    """The longest dependency path through one config's (request, layer)
    grid: T[r][l] = max(T[r-1][l], T[r][l-1], and for l = 0 in a closed loop
    T[r-conc][L-1]) + w_l, w_l = jobs[l] * weights[l] (``weights`` None:
    1, the path in job steps; else e.g. the ns of one job's chain link).
    With stages each running their layers' jobs in order, no launch can be
    faster than this path."""
    w = np.asarray(jobs, dtype=np.float64) * (1.0 if weights is None else np.asarray(weights, dtype=np.float64))
    N, L = int(n_requests), len(w)
    if N == 0 or L == 0:
        return 0.0
    conc = None if concurrency is None else int(concurrency)
    if conc is None or conc >= N:  # no back edge: the path takes the heaviest layer N times
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
    min (one compare and select)."""
    lanes = np.asarray(lanes, dtype=np.int64)
    offs = np.cumsum(blocks) - np.asarray(blocks)
    one = np.stack([lanes[:, o : o + b].max(axis=1, initial=0) <= 1 for o, b in zip(offs, blocks)], axis=1)
    return np.where(one, float(add_ns), float(add_min_ns))


@functools.cache
def _clusters(device: int, stream: bool, stats: bool, plan: KernelPlan) -> int:
    """How many clusters of ``plan``'s launch shape the device holds at once
    (the launch entries' occupancy query)."""
    out = ctypes.c_int(0)
    S = plan.stages
    split = (ctypes.c_int * (MAX_STAGES + 1))(*range(S + 1))
    shape = (plan.kmax, plan.chunk, plan.threads, plan.consumer_warps, int(plan.smem_state))
    if stream:
        rc = _stream_launcher()(*([None] * 11), plan.state_stride, None, 1, None, 1, 1, 0, *([None] * 4), 0,
                                1, 1, S, 1, 1, 0, *shape, plan.state_stride, S, split, None, ctypes.byref(out))
    else:
        rc = _launcher()(*([None] * 14), plan.state_stride, 1, 1, S, 1, 1, 0, *shape, int(stats), S, split, None,
                         ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"vtime_scan: occupancy query failed: CUDA error {rc}")
    return out.value


@functools.cache
def _build_warps(device: int, kmax: int, stats: bool, stream: bool) -> int:
    """Warps a block of the kernel's build for ``kmax`` holds at most (its
    launch bound, as the device reports it)."""
    n = _max_threads_fn()(kmax, int(stats), int(stream))
    if n < 32:
        raise RuntimeError(f"vtime_scan: the launch bound query failed: CUDA error {-n}")
    return n // 32


def _limits(device, stream: bool, stats: bool) -> dict:
    """``kernel_plan``'s ``warps`` and ``clusters`` for a launch on
    ``device``: the card's answers, or none (the defaults) off the card."""
    if device.type != "cuda":
        return {}
    index = device.index if device.index is not None else torch.cuda.current_device()

    def warps(kmax):
        with torch.cuda.device(index):
            return _build_warps(index, kmax, stats, stream)

    def clusters(S, plan):
        with torch.cuda.device(index):
            return _clusters(index, stream, stats, plan)
    return dict(warps=warps, clusters=clusters)


class VTTables(NamedTuple):
    """Per-layer (V, S_l, B_l) float64 service tables as both entries read
    them (``vt_tables``): one flat buffer, each (layer, variant)'s offset
    into it and the shapes, checked once when built."""

    flat: torch.Tensor  # every layer's table, flat
    tbl_off: torch.Tensor  # (L, V) int64 offsets into flat, on its device
    variants: int  # V
    samples: tuple  # S_l
    blocks: tuple  # B_l

    def layer(self, l: int) -> torch.Tensor:
        """Layer l's (V, S_l, B_l) table: a view of ``flat``."""
        o = self.variants * sum(s * b for s, b in zip(self.samples[:l], self.blocks[:l]))
        shape = (self.variants, self.samples[l], self.blocks[l])
        return self.flat[o : o + math.prod(shape)].view(shape)


def vt_tables(tables, device=None) -> VTTables:
    """Per-layer (V, S_l, B_l) service tables of one V packed for VT on
    ``device`` (None: the first table's).  Service times are cycles: a
    negative or NaN one raises (VT's insert relies on >= 0; the check reads
    one flag back), as does any other shape."""
    tables = list(tables)
    if not all(isinstance(t, torch.Tensor) for t in tables):
        raise TypeError("vtime_scan takes torch tensors")
    L = len(tables)
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"vtime_scan: {L} layer tables (1 to {MAX_LAYERS})")
    if any(t.dim() != 3 or t.shape[0] != tables[0].shape[0] or min(t.shape) < 1 for t in tables):
        raise ValueError(f"tables must be (V, S_l, B_l) with one V, got {[tuple(t.shape) for t in tables]}")
    if any(t.device != tables[0].device for t in tables):
        raise ValueError("vtime_scan: every input must lie on one device")
    blocks = tuple(int(t.shape[2]) for t in tables)
    if sum(blocks) > MAX_POOLS:
        raise ValueError(f"vtime_scan: {sum(blocks)} pools, at most {MAX_POOLS}")
    dev = tables[0].device if device is None else torch.device(device)
    flat = torch.cat([t.to(_F64).reshape(-1) for t in tables]).to(dev)
    if not bool((flat >= 0).all()):
        raise ValueError("service times must be >= 0 (and not NaN)")
    V = int(tables[0].shape[0])
    sizes = np.asarray([t.numel() for t in tables], dtype=np.int64)
    off = (np.cumsum(sizes) - sizes)[:, None] + np.arange(V)[None, :] * (sizes // V)[:, None]
    return VTTables(flat, torch.as_tensor(off, device=dev), V, tuple(int(t.shape[1]) for t in tables), blocks)


def to_device(device: torch.device, *arrays) -> list[torch.Tensor]:
    """Host arrays on ``device`` in one copy (from pinned memory, not
    waited for, on a card): one byte buffer holding each array from a
    multiple of 8 bytes, viewed back as its dtype and shape."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs = np.cumsum([0] + [-(-a.nbytes // 8) * 8 for a in arrays])
    pin = device.type == "cuda"
    # at least 8 bytes: an empty tensor's stride is 0, and no view of it is taken
    buf = torch.empty(max(8, int(offs[-1])), dtype=torch.uint8, pin_memory=pin)
    host = buf.numpy()
    for a, o in zip(arrays, offs):
        host[o : o + a.nbytes] = a.reshape(-1).view(np.uint8)
    t = buf.to(device, non_blocking=True) if pin else buf.to(device)
    return [t[o : o + a.nbytes].view(torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
            for a, o in zip(arrays, offs)]


class _Problem(NamedTuple):
    """Checked inputs of either entry, on the tables' device."""

    tables: VTTables
    idx: torch.Tensor | None  # the flat int32 indices, layer-major (None: hashed)
    patches: tuple  # P_l
    io: tuple  # per layer, the offset into idx of the launch's first request
    variant: torch.Tensor  # (C,) int32
    lanes: torch.Tensor  # (C, pools) int32
    host_lanes: np.ndarray  # (C, pools) int32, the lanes' host copy
    meta: torch.Tensor  # (L, 5) int64: B_l, P_l, first pool, io_l, S_l
    arrivals: torch.Tensor | None  # (C, N) float64, open loop
    xfer: torch.Tensor | None  # (C, L) float64
    n_requests: int
    concurrency: int  # 0: open loop

    @property
    def device(self) -> torch.device:
        return self.tables.flat.device

    def layer_idx(self, l: int) -> torch.Tensor:
        """Layer l's (N, P_l) indices of the launch's requests: a view of ``idx``."""
        N, P = self.n_requests, self.patches[l]
        return self.idx[self.io[l] : self.io[l] + N * P].view(N, P)


def _prepare(tables, idx, patches, variant, lanes, n_requests, arrivals, concurrency, xfer, *, carry=(),
             r0: int = 0, stream: bool = False) -> _Problem:
    """The inputs both entries share, checked.  ``tables`` from
    ``vt_tables``; ``idx`` the flat int32 indices, layer by layer, P_l =
    ``patches[l]`` a request: N requests for VT, any from request ``r0`` + N
    on for the streaming entry (``stream``; None there: hashed), whose
    ``carry`` tensors must lie on the tables' device too; ``variant`` (C,)
    and ``lanes`` (C, pools) host arrays, checked on the host and uploaded
    with the launch's ``meta`` in one copy.  The indices' range is checked
    on the device, one flag read back."""
    name = "vtime_stream" if stream else "vtime_scan"
    if not isinstance(tables, VTTables):
        raise TypeError(f"{name} takes its tables packed by vt_tables")
    tensors = [t for t in (arrivals, xfer, *carry) if t is not None] + ([idx] if idx is not None or not stream else [])
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError(f"{name} takes torch tensors")
    dev = tables.flat.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every input must lie on one device")
    L, N = len(tables.blocks), int(n_requests)
    P = np.asarray([int(x) for x in patches], dtype=np.int64)
    if P.shape != (L,) or P.min() < int(stream):
        raise ValueError(f"{name}: patches must be {L} counts of at least {int(stream)}, got {P.tolist()}")
    rows, first = N, 0
    if idx is not None:
        per = int(P.sum())
        rows, first = (idx.numel() // per if per else N), int(r0)
        if idx.dim() != 1 or rows * per != idx.numel() or (rows < first + N if stream else rows != N):
            raise ValueError(f"idx must be flat, {'>= ' if stream else ''}{first + N} requests of {per} indices, "
                             f"got {tuple(idx.shape)}")
        idx = idx.to(torch.int32).contiguous()
    io = rows * (np.cumsum(P) - P) + first * P
    variant = np.asarray(variant, dtype=np.int64).reshape(-1)
    C, n_pools = variant.shape[0], sum(tables.blocks)
    lanes = np.asarray(lanes, dtype=np.int64)
    if lanes.shape != (C, n_pools):
        raise ValueError(f"lanes {tuple(lanes.shape)} != (C={C}, pools={n_pools})")
    if C and (variant.min() < 0 or variant.max() >= tables.variants):
        raise ValueError(f"variant out of range for {tables.variants} variants")
    if lanes.size and (lanes.min() < 0 or lanes.max() > MAX_LANES):
        raise ValueError(f"lanes must lie in [0, {MAX_LANES}]")
    if (arrivals is None) == (concurrency is None):
        raise ValueError("give arrivals (open loop) or concurrency (closed loop), not both")
    if arrivals is not None:
        arrivals = arrivals.to(_F64)
        if arrivals.dim() != 2 or arrivals.shape[0] != C or (arrivals.shape[1] < N if stream
                                                            else arrivals.shape[1] != N):
            raise ValueError(f"arrivals {tuple(arrivals.shape)} must be ({C}, {'>= ' if stream else ''}{N})")
        arrivals = arrivals[:, :N].contiguous()
    elif int(concurrency) < 1:
        raise ValueError(f"concurrency must be >= 1, got {concurrency}")
    if xfer is not None:
        xfer = xfer.to(_F64).contiguous()
        if tuple(xfer.shape) != (C, L):
            raise ValueError(f"xfer {tuple(xfer.shape)} != ({C}, {L})")
    if idx is not None and C:
        runs = []  # (first, end, S): the launch's indices, layers of one S back to back in one run
        for l, S in enumerate(tables.samples):
            lo, hi = int(io[l]), int(io[l] + N * P[l])
            if runs and runs[-1][1] == lo and runs[-1][2] == S:
                runs[-1][1] = hi
            elif hi > lo:
                runs.append([lo, hi, S])
        checks = [((idx[a:b] >= 0) & (idx[a:b] < S)).all() for a, b, S in runs]
        if checks and not bool(torch.stack(checks).all()):
            raise ValueError("a sample index is out of range of its layer's table")
    blocks = np.asarray(tables.blocks, dtype=np.int64)
    meta = np.stack([blocks, P, np.cumsum(blocks) - blocks, io, np.asarray(tables.samples)], axis=1)
    meta, small = to_device(dev, meta, np.concatenate([variant, lanes.reshape(-1)]).astype(np.int32))
    return _Problem(tables, idx, tuple(P.tolist()), tuple(io.tolist()), small[:C], small[C:].view(C, n_pools),
                    lanes.astype(np.int32), meta, arrivals, xfer, N, 0 if concurrency is None else int(concurrency))


def _plain(p: _Problem, collect_stats: bool):
    """The recurrence in torch, batched over the configs, float64."""
    dev = p.device
    C, N, L = p.variant.shape[0], p.n_requests, len(p.patches)
    inf = float("inf")
    D = max(1, int(p.host_lanes.max())) if p.host_lanes.size else 1
    v = p.variant.long()
    frees, masks, cyc = [], [], []
    off = 0
    for li, B in enumerate(p.tables.blocks):
        d = p.lanes[:, off : off + B].long()
        off += B
        lane = torch.arange(D, device=dev)
        frees.append(torch.where(lane < d[..., None], 0.0, inf).to(_F64))  # (C, B, D)
        masks.append(d > 0)  # pools that have servers
        cyc.append(p.tables.layer(li)[v])  # (C, S_l, B_l)
    t_arr = torch.zeros((C, N), dtype=_F64, device=dev)
    comp = torch.zeros((C, N), dtype=_F64, device=dev)
    busy = torch.zeros((C, L), dtype=_F64, device=dev) if collect_stats else None
    wait = torch.zeros((C, L), dtype=_F64, device=dev) if collect_stats else None
    pad = torch.full((C, 1, 1), inf, dtype=_F64, device=dev)
    idx = [p.layer_idx(li) for li in range(L)]
    for r in range(N):
        if p.concurrency == 0:
            t = p.arrivals[:, r]
        elif r < p.concurrency:
            t = torch.zeros(C, dtype=_F64, device=dev)
        else:
            t = comp[:, r - p.concurrency]
        t_arr[:, r] = t
        for li in range(L):
            if p.xfer is not None:
                t = t + p.xfer[:, li]
            svc = cyc[li][:, idx[li][r].long(), :]  # (C, P_l, B_l)
            free = torch.maximum(frees[li], t[:, None, None])
            mask = masks[li]
            ends = []
            for j in range(svc.shape[1]):
                start = free[..., 0]
                if collect_stats:
                    wait[:, li] += torch.where(mask, start - t[:, None], 0.0).sum(dim=1)
                end = start + svc[:, j, :]
                up = torch.cat([free[..., 1:], pad.expand(C, free.shape[1], 1)], dim=-1)
                free = torch.minimum(torch.maximum(free, end[..., None]), up)
                ends.append(end)
            frees[li] = free
            if ends:
                e = torch.where(mask[:, None, :], torch.stack(ends, dim=1), -inf)
                t = torch.maximum(e.amax(dim=(1, 2)), t)
            if collect_stats:
                busy[:, li] += torch.where(mask[:, None, :], svc, 0.0).sum(dim=(1, 2))
        comp[:, r] = t
    return t_arr, comp, busy, wait


class _Packed(NamedTuple):
    """A checked problem and ``kernel_plan``'s choices for it."""

    p: _Problem
    plan: KernelPlan


def _pack(p: _Problem, collect_stats: bool = False) -> _Packed:
    """``kernel_plan``'s choices from the lanes' host copy (on the card, with
    the build's launch bound and the device's resident clusters)."""
    with _telemetry().span("vt.kernel_plan", host=True):
        plan = kernel_plan(p.host_lanes, p.tables.blocks, p.patches, **_limits(p.device, False, collect_stats))
    return _Packed(p, plan)


def _split_arg(plan: KernelPlan):
    """The plan's split as the entries' int array of MAX_STAGES + 1 (a plan
    of more stages than that is passed cut, for the launch to refuse)."""
    split = list(plan.split[: MAX_STAGES + 1])
    return (ctypes.c_int * (MAX_STAGES + 1))(*split, *([0] * (MAX_STAGES + 1 - len(split))))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(k: _Packed, collect_stats: bool, deep: torch.Tensor | None = None):
    """One launch on packed buffers: allocates the outputs (and the global
    pool state when it does not fit in shared memory) and runs VT as C
    clusters of ``plan.stages`` blocks; a refused launch raises.  ``deep``,
    a (1,) int64 tensor on the card, has the launch's jobs that short
    epochs sent one by one added."""
    p, plan = k.p, k.plan
    dev = p.device
    C, N, L = p.variant.shape[0], p.n_requests, len(p.patches)
    t_arr = torch.empty((C, N), dtype=_F64, device=dev)
    comp = torch.empty((C, N), dtype=_F64, device=dev)
    busy = torch.empty((C, L), dtype=_F64, device=dev) if collect_stats else None
    wait = torch.empty((C, L), dtype=_F64, device=dev) if collect_stats else None
    gstate = None if plan.smem_state else torch.empty((C * plan.stages, plan.state_stride), dtype=_F64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _launcher()(
            p.tables.flat.data_ptr(), p.tables.tbl_off.data_ptr(), p.meta.data_ptr(), p.idx.data_ptr(),
            p.variant.data_ptr(), p.lanes.data_ptr(), _ptr(p.arrivals), _ptr(p.xfer),
            t_arr.data_ptr(), comp.data_ptr(), _ptr(busy), _ptr(wait), _ptr(gstate), _ptr(deep), plan.state_stride,
            C, N, L, p.tables.variants, p.lanes.shape[1], p.concurrency, plan.kmax, plan.chunk, plan.threads,
            plan.consumer_warps, int(plan.smem_state), int(collect_stats), plan.stages, _split_arg(plan), stream,
            None,
        )
    if rc != 0:
        raise RuntimeError(f"vtime_scan kernel launch failed ({plan.stages} stages): CUDA error {rc}")
    vtime_scan.launches += 1
    return t_arr, comp, busy, wait


def vtime_scan_ref(
    tables, idx, patches, variant, lanes, *, n_requests, arrivals=None, concurrency=None,
    xfer=None, collect_stats=False,
):
    """Plain PyTorch version of VT, on the tables' device: the recurrence
    batched over the configs, a Python loop over requests and jobs.
    Arguments and outputs as for ``vtime_scan``."""
    p = _prepare(tables, idx, patches, variant, lanes, n_requests, arrivals, concurrency, xfer)
    return _plain(p, bool(collect_stats))


def vtime_scan(
    tables: VTTables,  # the service tables, one per variant (vt_tables)
    idx,  # the flat int32 sample indices: each layer's (N, P_l), layer after layer (service_indices)
    patches,  # P_l, the jobs a request of each layer
    variant,  # (C,) host array: the table variant of each config
    lanes,  # (C, sum_l B_l) host array: servers per pool, layer by layer (0: unused pool)
    *,
    n_requests: int,
    arrivals=None,  # (C, N) arrival times in cycles: the open loop
    concurrency: int | None = None,  # the closed loop's requests in flight
    xfer=None,  # (C, L) per-stage entry transfers, or None
    collect_stats: bool = False,
):
    """VT over C configs -> ``(t_arr, comp, busy, wait)``: (C, N) arrivals
    and completions, and with ``collect_stats`` the (C, L) service cycles and
    queue waits (else None), float64 on the tables' device.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and add one to ``vtime_scan.launches``; CPU tensors run
    ``vtime_scan_ref``.  Inputs are checked first (shapes and ranges on the
    host, the indices' range on the device, read back in one transfer); a
    failure to build or launch raises.  Each run, on either device, adds one
    to the recorder's ``vt.launches`` and its job steps (configs x requests
    x jobs a request) to ``vt.job_steps``; a recorded launch on the card
    also counts the jobs that epochs cut short by a deep insert sent one by
    one (the kernel's run_merged), for ``count_deep_inserts`` to read
    back."""
    tel = _telemetry()
    stats = bool(collect_stats)
    with tel.span("vt.prepare"):
        p = _prepare(tables, idx, patches, variant, lanes, n_requests, arrivals, concurrency, xfer)
    if p.device.type == "cpu":
        out = _plain(p, stats)
    elif p.device.type == "cuda":
        with tel.span("vt.plan"):
            k = _pack(p, stats)
        with tel.span("vt.launch") as attrs:
            if attrs is not None:
                attrs.update(configs=p.variant.shape[0], requests=p.n_requests, stages=k.plan.stages,
                             kmax=k.plan.kmax, threads=k.plan.threads, smem_state=bool(k.plan.smem_state),
                             job_steps=_job_steps(p), stage_weights=list(k.plan.stage_weights))
            deep = torch.zeros(1, dtype=torch.int64, device=p.device) if tel.enabled else None
            out = _launch(k, stats, deep)
            if deep is not None:
                _DEEP.append(deep)
    else:
        raise ValueError(f"no kernel for device {p.device}")
    tel.count("vt.launches")
    if tel.enabled:
        tel.count("vt.job_steps", _job_steps(p))
    return out


def _job_steps(p: _Problem) -> int:
    """Job steps a run of VT takes: every config's requests x jobs a request."""
    return p.variant.shape[0] * p.n_requests * sum(p.patches)


vtime_scan.launches = 0
_DEEP: list = []  # the deep-insert counters of recorded launches, not yet read back


def count_deep_inserts() -> None:
    """Add to the recorder's ``vt.deep_inserts`` the jobs that the launches
    recorded since the last call ran one by one after an epoch that a deep
    insert (an end below a later pop) cut to less than half its jobs (only
    a recording ``vtime_scan`` on the card counts them).  Called where the
    launches' outputs are read back, so the counters' copy waits for
    nothing more."""
    if _DEEP:
        n = sum(int(d.item()) for d in _DEEP)
        _DEEP.clear()
        _telemetry().count("vt.deep_inserts", n)


# ------------------------------------------------------------- streaming entry
@functools.cache
def _stream_launcher():
    fn = _build.load("vtime_scan").vtime_stream_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 11
                   + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


class StreamState(NamedTuple):
    """A streaming replay's carry for C configs, float64 on one device."""

    state: torch.Tensor  # (C, stride) lane free-times, pool by pool at pool_caps(lanes) lanes, sorted, +inf absent
    ring: torch.Tensor  # (C, R) closed-loop completions by slot r % concurrency (R = 1 for the open loop)
    counts: torch.Tensor  # (C, n_bins) sketch bucket counts
    moments: torch.Tensor  # (C, 5): n, min, max, mean, m2
    horizon: torch.Tensor  # (C,) largest completion so far


def _layout(lanes: np.ndarray):
    """Per-pool lane capacity and first lane of each config's state row, and
    the row length (the largest config's)."""
    caps = pool_caps(lanes)
    offs = np.cumsum(caps, axis=1) - caps
    return caps, offs, int(caps.sum(axis=1).max(initial=1)) if caps.size else 1


def _dense_index(lanes: np.ndarray, blocks):
    """Per layer (C, B_l, D_l) indices into a state row with a trailing
    +inf column: lane d of pool b, or the +inf column past its capacity
    (D_l: the layer's largest capacity, at least 1)."""
    caps, offs, stride = _layout(lanes)
    out, q = [], 0
    for b in blocks:
        c = caps[:, q : q + b]
        d = np.arange(max(1, int(c.max(initial=1))))
        out.append(np.where(d < c[..., None], offs[:, q : q + b, None] + d, stride))
        q += b
    return out, stride


def stream_state(lanes, servers, *, n_bins: int, ring_len: int = 1, device="cuda") -> StreamState:
    """A fresh carry on ``device`` (the card by default; it raises without
    one): ``lanes`` (C, pools) lane slots a pool, the first ``servers`` (C,
    pools) of them free at 0 and the rest absent (+inf); an empty ring
    (zeros), an empty sketch (n 0, min +inf, max -inf)."""
    lanes = np.asarray(lanes, dtype=np.int64)
    servers = np.asarray(servers, dtype=np.int64)
    caps, offs, stride = _layout(lanes)
    C = lanes.shape[0]
    st = np.full((C, stride), np.inf)
    for c in range(C):
        for q in range(lanes.shape[1]):
            st[c, offs[c, q] : offs[c, q] + servers[c, q]] = 0.0
    mom = np.zeros((C, 5))
    mom[:, 1], mom[:, 2] = np.inf, -np.inf
    dev = resolve_device(device)
    return StreamState(*(torch.as_tensor(a, dtype=_F64, device=dev) for a in (
        st, np.zeros((C, max(1, int(ring_len)))), np.zeros((C, int(n_bins))), mom, np.zeros(C))))


def stream_dense(state: torch.Tensor, lanes, blocks) -> list[torch.Tensor]:
    """The carry's lanes as per-layer (C, B_l, D_l) sorted free-times on the
    state's device (+inf past a pool's capacity): the reference's packed
    lane layout, for host-side boundary updates."""
    idx, stride = _dense_index(np.asarray(lanes, dtype=np.int64), blocks)
    ext = torch.cat([state[:, :stride], torch.full_like(state[:, :1], float("inf"))], dim=1)
    return [torch.gather(ext, 1, torch.as_tensor(i.reshape(i.shape[0], -1), device=state.device)).view(i.shape)
            for i in idx]


def stream_flat(dense, lanes, blocks) -> torch.Tensor:
    """Inverse of ``stream_dense``: the (C, stride) state row.  Lanes past a
    pool's capacity must be +inf (they are dropped)."""
    idx, stride = _dense_index(np.asarray(lanes, dtype=np.int64), blocks)
    C = dense[0].shape[0]
    ext = torch.full((C, stride + 1), float("inf"), dtype=_F64, device=dense[0].device)
    for d, i in zip(dense, idx):
        ext.scatter_(1, torch.as_tensor(i.reshape(C, -1), device=d.device), d.reshape(C, -1).to(_F64))
    return ext[:, :stride].contiguous()


_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for int64 ``a`` in [0, 2^32), in two 16-bit halves
    of ``k`` so that no int64 product overflows."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def stream_hash(salt: int, r, n_patches: int, n_samples: int, device="cuda") -> torch.Tensor:
    """``fabric.vtime.hash_service_indices`` for request(s) ``r`` in int64
    masked to 32 bits after every multiply and add (the kernel's uint32
    arithmetic): (..., n_patches) int64 sample rows on ``device`` (the card
    by default; it raises without one)."""
    r = torch.as_tensor(r, dtype=torch.int64, device=resolve_device(device))[..., None] & _M32
    p = torch.arange(int(n_patches), dtype=torch.int64, device=r.device)
    h = _mul32(p + 1, 0x9E3779B9)
    h = (h + _mul32((r + 1) & _M32, 0x85EBCA6B)) & _M32
    h = (h + (int(salt) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h % int(n_samples)


class _Stream(NamedTuple):
    """Checked streaming inputs: the ones VT shares and the stream's own."""

    p: _Problem
    salts: list | None  # per layer uint32 salt (hash mode)
    plans: np.ndarray  # (C, L, 2) int64 (K, n_bulk)
    carry: StreamState
    r0: int
    sketch: tuple  # (bins_per_octave, min_exp)


def _prepare_stream(tables, variant, lanes, carry, n_requests, patches, salts, idx, plans, r0, arrivals,
                    concurrency, xfer, sketch) -> _Stream:
    if (salts is None) == (idx is None):
        raise ValueError("vtime_stream: give salts (hashed indices) or idx (presampled), not both")
    p = _prepare(tables, idx, patches, variant, lanes, n_requests, arrivals, concurrency, xfer, carry=tuple(carry),
                 r0=int(r0), stream=True)
    C, L = p.variant.shape[0], len(p.patches)
    if salts is not None:
        salts = [int(s) & _M32 for s in salts]
        if len(salts) != L:
            raise ValueError(f"{len(salts)} salts for {L} layers")
    plans = np.ones((C, L, 2), dtype=np.int64) * np.array([1, 0]) if plans is None else \
        np.broadcast_to(np.asarray(plans, dtype=np.int64), (C, L, 2)).copy()
    P = np.asarray(p.patches)[None, :]
    if np.any(plans[..., 0] < 1) or np.any(plans[..., 1] < 0) or np.any(plans[..., 0] * plans[..., 1] > P):
        raise ValueError("plans must hold (K >= 1, n_bulk >= 0) with K * n_bulk <= P_l")
    if idx is not None and np.any(plans[..., 1] > 0):
        raise ValueError("presampled indices take exact plans only")
    _, _, stride = _layout(p.host_lanes)
    st, ring, counts, moments, horizon = (t.to(_F64).contiguous() for t in carry)
    if st.dim() != 2 or st.shape[0] != C or st.shape[1] < stride:
        raise ValueError(f"state {tuple(st.shape)} must be ({C}, >= {stride})")
    conc = p.concurrency
    if ring.dim() != 2 or ring.shape[0] != C or ring.shape[1] < max(1, conc):
        raise ValueError(f"ring {tuple(ring.shape)} must be ({C}, >= {max(1, conc)})")
    if counts.dim() != 2 or counts.shape[0] != C or moments.shape != (C, 5) or horizon.shape != (C,):
        raise ValueError("counts (C, n_bins), moments (C, 5) and horizon (C,) expected")
    return _Stream(p, salts, plans, StreamState(st, ring, counts, moments, horizon), int(r0),
                   (int(sketch[0]), int(sketch[1])))


def _chunk_jobs(svc: torch.Tensor, k: int, nb: int) -> torch.Tensor:
    """``vtime._chunk_services`` on (c, P, B): nb macro-jobs, each the left
    fold of k patches, then the exact tail."""
    if nb == 0:
        return svc
    head = svc[:, : nb * k].reshape(svc.shape[0], nb, k, svc.shape[2])
    acc = head[:, :, 0]
    for j in range(1, k):
        acc = acc + head[:, :, j]
    return torch.cat([acc, svc[:, nb * k :]], dim=1)


def _stream_plain(s: _Stream, emit: bool):
    """The streaming recurrence in torch, batched over the configs (those
    that share a layer's plan together), float64."""
    p = s.p
    dev = p.device
    C, N, L = p.variant.shape[0], p.n_requests, len(p.patches)
    inf = float("inf")
    blocks = list(p.tables.blocks)
    lanes_np = p.host_lanes.astype(np.int64)
    dense = stream_dense(s.carry.state, lanes_np, blocks)
    masks, q = [], 0
    for b in blocks:
        masks.append(p.lanes[:, q : q + b] > 0)
        q += b
    v = p.variant.long()
    cyc = [p.tables.layer(li)[v] for li in range(L)]  # (C, S_l, B_l)
    idx = None if p.idx is None else [p.layer_idx(li) for li in range(L)]
    ring = s.carry.ring.clone()
    counts = s.carry.counts.clone()
    n, mn, mx, mean, m2 = (s.carry.moments[:, k].clone() for k in range(5))
    hor = s.carry.horizon.clone()
    F, min_exp = s.sketch
    n_bins = counts.shape[1]
    t_arr = torch.zeros((C, N), dtype=_F64, device=dev) if emit else None
    comp = torch.zeros((C, N), dtype=_F64, device=dev) if emit else None
    groups = []  # per layer: [(k, nb, config indices)]
    for li in range(L):
        keys = {}
        for c in range(C):
            keys.setdefault(tuple(int(x) for x in s.plans[c, li]), []).append(c)
        groups.append([(k, nb, torch.as_tensor(cs, device=dev)) for (k, nb), cs in keys.items()])
    rows_c = torch.arange(C, device=dev)
    for i in range(N):
        r = s.r0 + i
        if p.concurrency == 0:
            t = p.arrivals[:, i]
        else:
            t = ring[:, r % p.concurrency].clone()
        t0 = t
        for li in range(L):
            if p.xfer is not None:
                t = t + p.xfer[:, li]
            if idx is not None:
                rows = idx[li][i].long()
            else:
                rows = stream_hash(s.salts[li], r, p.patches[li], p.tables.samples[li], dev)
            svc = cyc[li][:, rows, :]  # (C, P_l, B_l)
            done = t.clone()
            for k, nb, cs in groups[li]:
                jobs = _chunk_jobs(svc[cs], k, nb)
                tc = t[cs]
                free = torch.maximum(dense[li][cs], tc[:, None, None])
                mask = masks[li][cs]
                acc = tc
                pad = torch.full_like(free[..., :1], inf)
                for j in range(jobs.shape[1]):
                    end = free[..., 0] + jobs[:, j, :]
                    up = torch.cat([free[..., 1:], pad], dim=-1)
                    free = torch.minimum(torch.maximum(free, end[..., None]), up)
                    acc = torch.maximum(acc, torch.where(mask, end, -inf).amax(dim=-1))
                dense[li][cs] = free
                done[cs] = acc
            t = done
        if p.concurrency:
            ring[:, r % p.concurrency] = t
        lat = t - t0
        m_, e_ = torch.frexp(torch.clamp_min(lat, 2.0**min_exp))
        sub = torch.floor((m_ * 2.0 - 1.0) * F).to(torch.int64)
        b = torch.clamp((e_.to(torch.int64) - (min_exp + 1)) * F + sub, 0, n_bins - 1)
        counts[rows_c, b] += 1.0
        n1 = n + 1.0
        d = lat - mean
        mean = mean + d / n1
        m2 = m2 + d * (lat - mean)
        n = n1
        mn = torch.minimum(mn, lat)
        mx = torch.maximum(mx, lat)
        hor = torch.maximum(hor, t)
        if emit:
            t_arr[:, i] = t0
            comp[:, i] = t
    state = stream_flat(dense, lanes_np, blocks)
    if state.shape[1] < s.carry.state.shape[1]:
        state = torch.cat([state, s.carry.state[:, state.shape[1]:]], dim=1)
    out = StreamState(state, ring, counts, torch.stack([n, mn, mx, mean, m2], dim=1), hor)
    return out, ((t_arr, comp) if emit else None)


def _stream_plan(s: _Stream) -> KernelPlan:
    """``kernel_plan`` for a streaming launch: each layer weighs its
    macro-jobs and exact tail (the plans), and the carry's lanes stay
    where ``stream_state`` put them (a stage's pools are one slice of it)."""
    p = s.p
    jobs = s.plans[..., 1] + np.asarray(p.patches)[None, :] - s.plans[..., 1] * s.plans[..., 0]
    return kernel_plan(p.host_lanes, p.tables.blocks, p.patches, jobs=jobs, stream=True,
                       **_limits(p.device, True, False))


def _stream_launch(s: _Stream, emit: bool):
    """One streaming launch as C clusters of the plan's stages; a refused
    launch raises."""
    p = s.p
    dev = p.device
    C, N, L = p.variant.shape[0], p.n_requests, len(p.patches)
    plan = _stream_plan(s)
    salts = np.asarray(s.salts or [], dtype=np.uint32).view(np.int32)
    salts, plans = to_device(dev, salts, s.plans.astype(np.int32))
    st, ring, counts, moments, horizon = (t.clone() for t in s.carry)
    t_arr = torch.empty((C, N), dtype=_F64, device=dev) if emit else None
    comp = torch.empty((C, N), dtype=_F64, device=dev) if emit else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _stream_launcher()(
            p.tables.flat.data_ptr(), p.tables.tbl_off.data_ptr(), p.meta.data_ptr(),
            None if s.salts is None else salts.data_ptr(), _ptr(p.idx), plans.data_ptr(),
            p.variant.data_ptr(), p.lanes.data_ptr(), _ptr(p.arrivals), _ptr(p.xfer), st.data_ptr(), st.shape[1],
            ring.data_ptr(), ring.shape[1], counts.data_ptr(), counts.shape[1], s.sketch[0], s.sketch[1],
            moments.data_ptr(), horizon.data_ptr(), _ptr(t_arr), _ptr(comp), s.r0,
            C, N, L, p.tables.variants, p.lanes.shape[1], p.concurrency, plan.kmax, plan.chunk, plan.threads,
            plan.consumer_warps, int(plan.smem_state), plan.state_stride, plan.stages, _split_arg(plan), stream,
            None,
        )
    if rc != 0:
        raise RuntimeError(f"vtime_stream kernel launch failed ({plan.stages} stages): CUDA error {rc}")
    vtime_stream.launches += 1
    return StreamState(st, ring, counts, moments, horizon), ((t_arr, comp) if emit else None)


def vtime_stream_ref(tables, variant, lanes, carry, *, n_requests, patches, salts=None, idx=None,
                     plans=None, r0=0, arrivals=None, concurrency=None, xfer=None, emit=False, sketch=(32, 0)):
    """Plain PyTorch version of the streaming entry, on the tables' device:
    the recurrence batched over the configs, a Python loop over requests
    and jobs.  Arguments and outputs as for ``vtime_stream``."""
    s = _prepare_stream(tables, variant, lanes, carry, n_requests, patches, salts, idx, plans, r0, arrivals,
                        concurrency, xfer, sketch)
    return _stream_plain(s, bool(emit))


def vtime_stream(
    tables: VTTables,  # the service tables, one per variant (vt_tables)
    variant,  # (C,) host array: the table variant of each config
    lanes,  # (C, sum_l B_l) host array: lane slots per pool (0: unused pool)
    carry: StreamState,  # lane state, ring, sketch, horizon (stream_state for a fresh one)
    *,
    n_requests: int,  # requests of this segment
    patches,  # per layer P_l, the jobs a request
    salts=None,  # per layer hash salts: indices hashed from (salt, r0 + i, patch)
    idx=None,  # or the flat presampled indices of requests 0, 1, ... (as for vtime_scan): this segment's from r0 on
    plans=None,  # (C, L, 2) or (L, 2) macro-job plans (K, n_bulk); None: exact
    r0: int = 0,  # global id of the segment's first request
    arrivals=None,  # (C, N) arrival times: the open loop
    concurrency: int | None = None,  # the closed loop's requests in flight
    xfer=None,  # (C, L) per-stage entry transfers, or None
    emit: bool = False,  # also return the (C, N) arrivals and completions
    sketch: tuple = (32, 0),  # (bins_per_octave, min_exp) of the sketch
):
    """One segment of the streaming replay over C configs ->
    ``(carry', (t_arr, comp) or None)``, float64 on the tables' device.

    Every request runs VT's recurrence against the carried lanes; its
    latency goes into the sketch (bucket count, n, min, max, Welford mean
    and m2) and its completion into the horizon (and the ring's slot
    ``r % concurrency`` in the closed loop).  Bucket counts, n, min, max and
    horizon are bit-identical to the reference's numpy replay and to
    ``FabricSim(service_sampling="hash")``; mean and m2 are the same
    operations in the same order.  ``carry`` is not modified.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and add one to ``vtime_stream.launches``; CPU tensors
    run ``vtime_stream_ref``.  A failure to build or launch raises."""
    s = _prepare_stream(tables, variant, lanes, carry, n_requests, patches, salts, idx, plans, r0, arrivals,
                        concurrency, xfer, sketch)
    if s.p.device.type == "cpu":
        return _stream_plain(s, bool(emit))
    if s.p.device.type != "cuda":
        raise ValueError(f"no kernel for device {s.p.device}")
    return _stream_launch(s, bool(emit))


vtime_stream.launches = 0

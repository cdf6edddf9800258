"""VT: the virtual-time scan of the fabric engines, one launch per call.

The reference runs its batched fabric engine as one ``jax.jit(jax.vmap(...))``
of ``run_fabric_kernel`` per sub-batch (``src/repro/fabric/vtime.py:629-674``),
whose loop over requests and jobs is a ``lax.scan`` on the device.  No
Pallas kernel is involved, but the recurrence is serial in jobs (1,448 a
VGG11 request, 30,233 a ResNet18 one), so in eager PyTorch it would cost five
to seven launches a job.  ``vtime_scan`` is its counterpart: one launch of
``csrc/vtime_scan.cu`` for C (allocation, trace) pairs, a block per pair.

The problem, for config c: layer l has B_l pools, pool p holding
``lanes[c, off_l + p]`` servers (0 for a pool that is not used).  Request r
brings P_l jobs to every pool of layer l, job j with service time
``tables[l][variant[c], idx[l][r, j], p]``; pools are FIFO over sorted server
free-times (``fabric.vtime.dispatch_step``), a layer completes at its last
job's end (at least its ready time), and the next layer starts then, after
the stage transfer ``xfer[c, l]`` when given.  Requests arrive at
``arrivals[c, r]`` (open loop) or at the completion of request
``r - concurrency`` (closed loop).  Out: per request its arrival and
completion (C, N); with ``collect_stats`` the service cycles and queue waits
per layer (C, L).  Completions are bit-identical to ``FabricSim`` and to the
numpy engine; the two sums agree with the numpy engine to rtol 1e-12 (their
order differs).  Service times are cycles, so both versions take them >= 0
(the kernel's insert relies on it) and at most 512 servers a pool.

``vtime_scan`` launches the kernel on CUDA tensors (``kernel_plan`` makes
its host-side choices) and runs the plain PyTorch version ``vtime_scan_ref``
on CPU tensors.  The plain version is the same recurrence batched over the
configs, a Python loop over requests and jobs: it is the CPU tests' engine
and ``chip_smoke.py``'s yardstick, and nothing on the card's path calls it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["kernel_plan", "vtime_scan", "vtime_scan_ref"]

_F64 = torch.float64
MAX_SMEM = 232_448  # the most shared memory one block may use on the card
STATIC_SMEM = 12 * 1024  # the kernel's own shared arrays, kept out of the state's room
MAX_LAYERS = 64
MAX_POOLS = 1024
MAX_LANES = 512
SMALL_POOL = 8  # pools of at most this many servers run on one thread
CHUNK = 2048  # doubles of service times staged at a time, two buffers
LOADER_WARPS = 2  # warps of a block that stage the next chunk's service times


@functools.cache
def _launcher():
    fn = _build.load("vtime_scan").vtime_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class KernelPlan(NamedTuple):
    threads: int  # threads a block
    consumer_warps: int  # warps that run the pools; the other LOADER_WARPS stage
    kmax: int  # lanes a thread of the widest pool's warp holds: 1, 4 or 16
    chunk: int  # doubles of service times a staging buffer holds
    state_stride: int  # doubles of pool state a config
    smem_state: bool  # the pool state lives in shared memory
    smem_bytes: int  # dynamic shared memory a block takes


def pool_caps(lanes: np.ndarray) -> np.ndarray:
    """Lanes of state VT gives each pool: the power of two above its servers
    for a pool of at most 8 (one thread runs it), at least 32 above (a warp
    runs it, 32 / 64 / ... / 512 lanes), none for a pool without servers."""
    d = np.asarray(lanes, dtype=np.int64)
    pow2 = np.where(d <= 1, 1, 1 << np.ceil(np.log2(np.maximum(d, 1))).astype(np.int64))
    return np.where(d == 0, 0, np.where(d <= SMALL_POOL, pow2, np.maximum(32, pow2)))


def kernel_plan(lanes: np.ndarray, blocks, patches) -> KernelPlan:
    """VT's host-side choices for (C, pools) lane counts over layers of
    ``blocks`` pools and ``patches`` jobs a request: consumer warps with a
    thread for every pool of the widest layer and a warp for every pool of
    more than 8 servers in the layer that has most (at most 14, or 6 for the
    widest build, whose threads hold up to 16 lanes), beside
    ``LOADER_WARPS`` warps that stage service times; the build for the widest
    pool (``kmax``); staging buffers of ``CHUNK`` doubles (fewer when no
    layer needs them, at least the widest layer's pools); the pool state
    (``pool_caps`` summed over a config's pools, the largest config) in
    shared memory when it fits beside them."""
    lanes = np.asarray(lanes, dtype=np.int64)
    if lanes.size and lanes.max() > MAX_LANES:
        raise ValueError(f"VT holds at most {MAX_LANES} servers a pool, got {int(lanes.max())}")
    wide, off = 0, 0
    for b in blocks:
        wide = max(wide, int((lanes[:, off : off + b] > SMALL_POOL).sum(axis=1).max(initial=0)))
        off += b
    top = int(pool_caps(lanes).max(initial=1))
    kmax = 1 if top <= 32 else 4 if top <= 128 else 16
    warps = 8 if kmax == 16 else 16  # the build's launch bound: 256 or 512 threads
    consumers = min(warps - LOADER_WARPS, max(1, -(-max(blocks) // 32), wide))
    chunk = max(max(blocks), min(CHUNK, max(b * p for b, p in zip(blocks, patches))))
    stride = int(pool_caps(lanes).sum(axis=1).max(initial=1))
    smem = 8 * (2 * chunk + stride) <= MAX_SMEM - STATIC_SMEM
    return KernelPlan(32 * (consumers + LOADER_WARPS), consumers, kmax, chunk, stride, smem,
                      8 * (2 * chunk + (stride if smem else 0)))


class _Problem(NamedTuple):
    """Checked inputs on one device."""

    tables: list  # per layer (V, S_l, B_l) float64
    idx: list  # per layer (N, P_l) int32
    variant: torch.Tensor  # (C,) int32
    lanes: torch.Tensor  # (C, Ptot) int32
    arrivals: torch.Tensor | None  # (C, N) float64, open loop
    xfer: torch.Tensor | None  # (C, L) float64
    n_requests: int
    concurrency: int  # 0: open loop


def _prepare(tables, idx, variant, lanes, n_requests, arrivals, concurrency, xfer) -> _Problem:
    tables, idx = list(tables), list(idx)
    tensors = [*tables, *idx, variant, lanes] + [t for t in (arrivals, xfer) if t is not None]
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("vtime_scan takes torch tensors")
    dev = variant.device
    if any(t.device != dev for t in tensors):
        raise ValueError("vtime_scan: every input must lie on one device")
    L = len(tables)
    if L < 1 or L > MAX_LAYERS or len(idx) != L:
        raise ValueError(f"vtime_scan: {L} layer tables and {len(idx)} index tables (1 to {MAX_LAYERS})")
    N = int(n_requests)
    tables = [t.to(_F64).contiguous() for t in tables]
    V = tables[0].shape[0]
    if any(t.dim() != 3 or t.shape[0] != V or min(t.shape) < 1 for t in tables):
        raise ValueError(f"tables must be (V, S_l, B_l) with one V, got {[tuple(t.shape) for t in tables]}")
    idx = [i.to(torch.int32).contiguous() for i in idx]
    if any(i.dim() != 2 or i.shape[0] != N for i in idx):
        raise ValueError(f"idx must be (N={N}, P_l) per layer, got {[tuple(i.shape) for i in idx]}")
    variant = variant.reshape(-1).to(torch.int32).contiguous()
    C = variant.shape[0]
    n_pools = sum(t.shape[2] for t in tables)
    lanes = lanes.to(torch.int32).contiguous()
    if tuple(lanes.shape) != (C, n_pools):
        raise ValueError(f"lanes {tuple(lanes.shape)} != (C={C}, pools={n_pools})")
    if (arrivals is None) == (concurrency is None):
        raise ValueError("give arrivals (open loop) or concurrency (closed loop), not both")
    if arrivals is not None:
        arrivals = arrivals.to(_F64).contiguous()
        if tuple(arrivals.shape) != (C, N):
            raise ValueError(f"arrivals {tuple(arrivals.shape)} != ({C}, {N})")
    elif int(concurrency) < 1:
        raise ValueError(f"concurrency must be >= 1, got {concurrency}")
    if xfer is not None:
        xfer = xfer.to(_F64).contiguous()
        if tuple(xfer.shape) != (C, L):
            raise ValueError(f"xfer {tuple(xfer.shape)} != ({C}, {L})")
    if n_pools > MAX_POOLS:
        raise ValueError(f"vtime_scan: {n_pools} pools, at most {MAX_POOLS}")
    # the indices, loop bounds and values the kernel trusts, read back in one
    # transfer; service times are cycles: >= 0, which VT's insert relies on
    checks = [((variant >= 0) & (variant < V)).all(), ((lanes >= 0) & (lanes <= MAX_LANES)).all(),
              torch.stack([(t >= 0).all() for t in tables]).all()]
    checks += [((i >= 0) & (i < t.shape[1])).all() for i, t in zip(idx, tables)]
    ok = torch.stack(checks).tolist() if C else [True] * len(checks)
    if not ok[0]:
        raise ValueError(f"variant out of range for {V} variants")
    if not ok[1]:
        raise ValueError(f"lanes must lie in [0, {MAX_LANES}]")
    if not ok[2]:
        raise ValueError("service times must be >= 0 (and not NaN)")
    if not all(ok[3:]):
        raise ValueError("a sample index is out of range of its layer's table")
    return _Problem(tables, idx, variant, lanes, arrivals, xfer, N,
                    0 if concurrency is None else int(concurrency))


def _plain(p: _Problem, collect_stats: bool):
    """The recurrence in torch, batched over the configs, float64."""
    dev = p.variant.device
    C, N, L = p.variant.shape[0], p.n_requests, len(p.tables)
    inf = float("inf")
    D = max(1, int(p.lanes.max())) if C else 1
    v = p.variant.long()
    frees, masks, cyc = [], [], []
    off = 0
    for t in p.tables:
        B = t.shape[2]
        d = p.lanes[:, off : off + B].long()
        off += B
        lane = torch.arange(D, device=dev)
        frees.append(torch.where(lane < d[..., None], 0.0, inf).to(_F64))  # (C, B, D)
        masks.append(d > 0)  # pools that have servers
        cyc.append(t[v])  # (C, S_l, B_l)
    t_arr = torch.zeros((C, N), dtype=_F64, device=dev)
    comp = torch.zeros((C, N), dtype=_F64, device=dev)
    busy = torch.zeros((C, L), dtype=_F64, device=dev) if collect_stats else None
    wait = torch.zeros((C, L), dtype=_F64, device=dev) if collect_stats else None
    pad = torch.full((C, 1, 1), inf, dtype=_F64, device=dev)
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
            svc = cyc[li][:, p.idx[li][r].long(), :]  # (C, P_l, B_l)
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
    """A checked problem as the kernel reads it: flat device buffers."""

    p: _Problem
    plan: KernelPlan
    tables: torch.Tensor  # every layer's (V, S_l, B_l) table, flat
    tbl_off: torch.Tensor  # (L, V) int64 offsets into tables
    meta: torch.Tensor  # (L, 4) int64: B_l, P_l, pool offset, offset into idx
    idx: torch.Tensor  # every layer's (N, P_l) indices, flat int32
    n_pools: int


def _pack(p: _Problem) -> _Packed:
    dev = p.variant.device
    C, N = p.variant.shape[0], p.n_requests
    V = p.tables[0].shape[0]
    blocks = torch.tensor([t.shape[2] for t in p.tables], dtype=torch.int64)
    patches = torch.tensor([i.shape[1] for i in p.idx], dtype=torch.int64)
    n_pools = int(blocks.sum())
    plan = kernel_plan(p.lanes.cpu().numpy(), blocks.tolist(), patches.tolist())
    sizes = torch.tensor([t.numel() for t in p.tables], dtype=torch.int64)
    per_v = torch.tensor([t.shape[1] * t.shape[2] for t in p.tables], dtype=torch.int64)
    tbl_off = (torch.cumsum(sizes, 0) - sizes)[:, None] + torch.arange(V)[None, :] * per_v[:, None]
    idx_sizes = patches * N
    meta = torch.stack([blocks, patches, torch.cumsum(blocks, 0) - blocks,
                        torch.cumsum(idx_sizes, 0) - idx_sizes], dim=1)
    return _Packed(
        p, plan, torch.cat([t.reshape(-1) for t in p.tables]), tbl_off.to(dev), meta.to(dev),
        torch.cat([i.reshape(-1) for i in p.idx]), n_pools,
    )


def _launch(k: _Packed, collect_stats: bool):
    """One launch on packed buffers: allocates the outputs (and the global
    pool state when it does not fit in shared memory) and runs VT."""
    p, plan = k.p, k.plan
    dev = p.variant.device
    C, N, L = p.variant.shape[0], p.n_requests, len(p.tables)
    t_arr = torch.empty((C, N), dtype=_F64, device=dev)
    comp = torch.empty((C, N), dtype=_F64, device=dev)
    busy = torch.empty((C, L), dtype=_F64, device=dev) if collect_stats else None
    wait = torch.empty((C, L), dtype=_F64, device=dev) if collect_stats else None
    gstate = None if plan.smem_state else torch.empty((C, plan.state_stride), dtype=_F64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _launcher()(
            k.tables.data_ptr(), k.tbl_off.data_ptr(), k.meta.data_ptr(), k.idx.data_ptr(),
            p.variant.data_ptr(), p.lanes.data_ptr(), ptr(p.arrivals), ptr(p.xfer),
            t_arr.data_ptr(), comp.data_ptr(), ptr(busy), ptr(wait), ptr(gstate), plan.state_stride,
            C, N, L, p.tables[0].shape[0], k.n_pools, p.concurrency, plan.kmax, plan.chunk, plan.threads,
            plan.consumer_warps, int(plan.smem_state), int(collect_stats), stream,
        )
    if rc != 0:
        raise RuntimeError(f"vtime_scan kernel launch failed: CUDA error {rc}")
    vtime_scan.launches += 1
    return t_arr, comp, busy, wait


def vtime_scan_ref(
    tables, idx, variant, lanes, *, n_requests, arrivals=None, concurrency=None,
    xfer=None, collect_stats=False,
):
    """Plain PyTorch version of VT, on the inputs' device: the recurrence
    batched over the configs, a Python loop over requests and jobs.
    Arguments and outputs as for ``vtime_scan``."""
    p = _prepare(tables, idx, variant, lanes, n_requests, arrivals, concurrency, xfer)
    return _plain(p, bool(collect_stats))


def vtime_scan(
    tables,  # per layer (V, S_l, B_l) float64 service tables, one per variant
    idx,  # per layer (N, P_l) sample indices, int32
    variant,  # (C,) the table variant of each config
    lanes,  # (C, sum_l B_l) servers per pool, layer by layer (0: unused pool)
    *,
    n_requests: int,
    arrivals=None,  # (C, N) arrival times in cycles: the open loop
    concurrency: int | None = None,  # the closed loop's requests in flight
    xfer=None,  # (C, L) per-stage entry transfers, or None
    collect_stats: bool = False,
):
    """VT over C configs -> ``(t_arr, comp, busy, wait)``: (C, N) arrivals
    and completions, and with ``collect_stats`` the (C, L) service cycles and
    queue waits (else None), float64 on the inputs' device.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and add one to ``vtime_scan.launches``; CPU tensors run
    ``vtime_scan_ref``.  Inputs are checked first (shapes, index ranges),
    which reads the flags back from the device in one transfer; a failure to
    build or launch raises."""
    p = _prepare(tables, idx, variant, lanes, n_requests, arrivals, concurrency, xfer)
    if p.variant.device.type == "cpu":
        return _plain(p, bool(collect_stats))
    if p.variant.device.type != "cuda":
        raise ValueError(f"no kernel for device {p.variant.device}")
    return _launch(_pack(p), bool(collect_stats))


vtime_scan.launches = 0

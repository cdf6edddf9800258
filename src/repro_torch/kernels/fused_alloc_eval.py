"""K2: fused greedy allocate + replica scatter + throughput eval.

The fused sweep's ``engine="kernel"`` evaluates every (ADC, policy,
PE-budget) config against bank statistics shared per variant.  For each
config this computes, in one kernel, the lock-step greedy of
``core.alloc.greedy.greedy_batch_kernel`` (80-step bisection + residual
argmax loop) on the allocation bases of variant ``a_idx``, the scatter of
the unit replicas onto the (L, B) replica matrix, and the
``core.cim.simulate._eval_kernel`` formulas on bank slot ``sel``.

Both greedy families share the unit axis: the layer family passes units =
layers (unit l covers every block column of layer l), the block family
passes one unit per (layer, block) cell; proportional configs ride along
at budget 0 with their host-computed replicas as the warm start, where the
greedy changes nothing.

``fused_alloc_eval`` launches the CUDA kernel (``csrc/fused_alloc_eval.cu``,
which replaces the Pallas ``fused_alloc_eval_kernel`` of
``src/repro/kernels/fused_alloc_eval.py:48``) on CUDA tensors and runs the
plain PyTorch version ``fused_alloc_eval_ref`` on CPU tensors.  Both take
the reference's arguments and return its outputs in its order, all
float64.  The one-hot unit map is turned into a per-cell unit index, so
the scatter is an index read in both, never a matrix product.

The kernel runs one warp per config in persistent blocks of 16 warps that
take configs from a counter.  ``kernel_plan`` makes its two host-side
choices: the units a lane holds in registers (``ceil(N / 32)`` up to 8;
above 256 units they are read from memory at every step), and whether the
eval's tables (the bank stacks, per-layer vectors and the cells' unit
index and mask) are staged in shared memory, which they are when they fit
beside the warps' replica rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.alloc.greedy import greedy_batch_kernel
from ..core.cim.simulate import _eval_kernel
from . import _build

__all__ = ["fused_alloc_eval", "fused_alloc_eval_ref", "kernel_plan"]

_F64 = torch.float64
MAX_SMEM = 232_448  # the most shared memory one block may use on the card


@functools.cache
def _launcher():
    fn = _build.load("fused_alloc_eval").fused_alloc_eval_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 23
        + [ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_double] * 2
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


class KernelPlan(NamedTuple):
    units_per_lane: int  # units a lane keeps in registers; 0: read from memory (N > 256)
    warps: int  # configs in flight per block, one a warp
    staged: bool  # the eval's tables are staged in shared memory
    smem_bytes: int  # dynamic shared memory a block takes


def kernel_plan(N: int, V: int, L: int, B: int) -> KernelPlan:
    """K2's host-side choices for N units and (V, L, B) banks, as
    ``csrc/fused_alloc_eval.cu`` makes them: units a lane holds
    (``ceil(N / 32)`` for N <= 256, else 0); warps a block (32 where a lane
    holds one unit, else 16); and whether the eval's tables fit in
    shared memory beside the warps' replica rows (N doubles each, register
    path only).  The tables: mean and max (V, L, B), pm_mean, pm_max and
    busy (V, L), ppi, width and layer_arrays (L) as float64; the cells' unit
    index (L, B) int32 and mask (L, B) uint8.  ResNet18's rows-128 block
    family (N 247; V 16, L 20, B 36) needs 196,080 B of tables and 31,616 B
    of rows: 227,696 of the 232,448 a block may use."""
    upl = -(-N // 32) if N <= 256 else 0
    warps = 32 if upl == 1 else 16
    rows = 8 * warps * N if upl else 0
    tables = 8 * (2 * V * L * B + 3 * V * L + 3 * L) + 5 * L * B
    staged = rows + tables <= MAX_SMEM
    return KernelPlan(upl, warps, staged, rows + (tables if staged else 0))


class _Problem(NamedTuple):
    """Checked, contiguous inputs on one device."""

    base: torch.Tensor  # (A, N) float64
    cost: torch.Tensor  # (N,) float64
    cell_unit: torch.Tensor  # (L*B,) int32, -1 where no unit covers the cell
    banks: tuple  # mean, max (V, L, B); pm_mean, pm_max, busy (V, L); float64
    b_mask: torch.Tensor  # (L, B) bool
    ppi: torch.Tensor  # (L,) float64
    width: torch.Tensor  # (L,)
    layer_arrays: torch.Tensor  # (L,)
    budgets: torch.Tensor  # (C,) float64
    a_idx: torch.Tensor  # (C,) int32
    sel: torch.Tensor  # (C,) int32
    layerwise: torch.Tensor  # (C,) bool
    r0: torch.Tensor  # (C, N) float64


def _prepare(
    base, cost, unit_map, banks, b_mask, ppi, width, layer_arrays,
    budgets, a_idx, sel, layerwise, r0,
) -> _Problem:
    tensors = [base, cost, unit_map, *banks, b_mask, ppi, width, layer_arrays,
               budgets, a_idx, sel, layerwise, r0]
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("fused_alloc_eval takes torch tensors")
    dev = base.device
    if any(t.device != dev for t in tensors):
        raise ValueError("fused_alloc_eval: every input must lie on one device")

    def f64(t):
        return t.to(_F64).contiguous()

    base = f64(base)
    if base.dim() != 2 or base.shape[1] == 0:
        raise ValueError(f"base must be (A, N) with N >= 1, got {tuple(base.shape)}")
    A, N = base.shape
    cost = f64(cost).reshape(-1)
    if cost.shape != (N,):
        raise ValueError(f"cost has {cost.numel()} entries, want N={N}")
    if len(banks) != 5:
        raise ValueError("banks must be (mean, max, pm_mean, pm_max, busy)")
    banks = tuple(f64(b) for b in banks)
    V, L, B = banks[0].shape
    want = [(V, L, B), (V, L, B), (V, L), (V, L), (V, L)]
    if [tuple(b.shape) for b in banks] != want:
        raise ValueError(f"bank shapes {[tuple(b.shape) for b in banks]} != {want}")
    if tuple(b_mask.shape) != (L, B):
        raise ValueError(f"b_mask {tuple(b_mask.shape)} != ({L}, {B})")
    ppi, width, layer_arrays = (f64(x).reshape(-1) for x in (ppi, width, layer_arrays))
    if not ppi.shape == width.shape == layer_arrays.shape == (L,):
        raise ValueError(f"ppi / width / layer_arrays must have L={L} entries")
    budgets = f64(budgets).reshape(-1)
    C = budgets.shape[0]
    a_idx = a_idx.reshape(-1).to(torch.int32).contiguous()
    sel = sel.reshape(-1).to(torch.int32).contiguous()
    layerwise = layerwise.reshape(-1).to(torch.bool).contiguous()
    if not a_idx.shape == sel.shape == layerwise.shape == (C,):
        raise ValueError(f"a_idx / sel / layerwise must have C={C} entries")
    r0 = f64(torch.broadcast_to(r0, (C, N)))

    umap = unit_map.reshape(N, L * B)
    covered = umap.sum(dim=0)
    # the map's shape and the indices and loop bounds the kernel trusts, read
    # back from the device in one transfer
    ok = torch.stack([
        ((umap == 0) | (umap == 1)).all() & (covered <= 1).all(),
        ((a_idx >= 0) & (a_idx < A)).all(),
        ((sel >= 0) & (sel < V)).all(),
        (cost > 0).all(),
        torch.isfinite(budgets).all() & torch.isfinite(base).all(),
        (r0 >= 1).all(),
    ]).tolist()
    if not ok[0]:
        raise ValueError("unit_map must be one-hot: each cell covered by at most one unit")
    if not ok[1]:
        raise ValueError(f"a_idx out of range for {A} allocation variants")
    if not ok[2]:
        raise ValueError(f"sel out of range for {V} bank slots")
    if not ok[3]:
        raise ValueError("cost must be strictly positive")
    if not ok[4]:
        raise ValueError("budgets and base must be finite")
    if not ok[5]:
        raise ValueError("every unit needs at least one replica")
    cell_unit = torch.where(covered > 0, umap.argmax(dim=0), -1).to(torch.int32).contiguous()
    return _Problem(base, cost, cell_unit, banks, b_mask.to(torch.bool).contiguous(),
                    ppi, width, layer_arrays, budgets, a_idx, sel, layerwise, r0)


def _plain(p: _Problem, n_images: int, clock_hz: float):
    C, N = p.r0.shape
    L, B = p.b_mask.shape
    r, rem = greedy_batch_kernel(
        p.base[p.a_idx.long()], p.cost.expand(C, N), p.budgets, p.r0
    )
    cu = p.cell_unit.long()
    covered = cu >= 0
    dups = torch.ones((C, L * B), dtype=_F64, device=r.device)
    dups[:, covered] = 1.0 + (r[:, cu[covered]] - 1.0)
    T, ips, layer_T, util = _eval_kernel(
        *p.banks, p.b_mask, p.ppi, p.width, p.layer_arrays,
        dups.view(C, L, B), p.layerwise, n_images, clock_hz, sel=p.sel.long(),
    )
    return T, ips, layer_T, util, r, rem


def _launch(p: _Problem, n_images: int, clock_hz: float):
    C, N = p.r0.shape
    L, B = p.b_mask.shape
    dev = p.base.device
    T = torch.empty(C, dtype=_F64, device=dev)
    ips = torch.empty(C, dtype=_F64, device=dev)
    layer_T = torch.empty((C, L), dtype=_F64, device=dev)
    util = torch.empty((C, L), dtype=_F64, device=dev)
    r = torch.empty((C, N), dtype=_F64, device=dev)
    rem = torch.empty(C, dtype=_F64, device=dev)
    ins = (p.base, p.cost, p.cell_unit, *p.banks, p.b_mask, p.ppi, p.width,
           p.layer_arrays, p.budgets, p.a_idx, p.sel, p.layerwise, p.r0)
    outs = (T, ips, layer_T, util, r, rem)
    V = p.banks[0].shape[0]
    plan = kernel_plan(N, V, L, B)
    if plan.smem_bytes > MAX_SMEM:
        raise ValueError(f"K2 at N={N} needs {plan.smem_bytes} B of shared memory for its replica rows "
                         f"(at most {MAX_SMEM})")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(
        *(t.data_ptr() for t in ins + outs), C, N, L, B, V, int(plan.staged),
        float(n_images), float(clock_hz),
        _build.work_queue(dev, stream).data_ptr(), dev.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_alloc_eval kernel launch failed: CUDA error {rc}")
    fused_alloc_eval.launches += 1
    return outs


def fused_alloc_eval_ref(
    base, cost, unit_map, banks, b_mask, ppi, width, layer_arrays,
    budgets, a_idx, sel, layerwise, r0, *, n_images: int = 64, clock_hz: float = 1e9,
):
    """Plain PyTorch version of K2, on the inputs' device: the port's
    ``greedy_batch_kernel``, an index write for the scatter, and
    ``_eval_kernel`` with ``sel``.  Arguments and outputs as for
    ``fused_alloc_eval``."""
    p = _prepare(base, cost, unit_map, banks, b_mask, ppi, width, layer_arrays,
                 budgets, a_idx, sel, layerwise, r0)
    return _plain(p, int(n_images), float(clock_hz))


def fused_alloc_eval(
    base,  # (A, N) per-variant unit base latencies
    cost,  # (N,) cost per extra replica of each unit
    unit_map,  # (N, L, B) one-hot unit -> (layer, block) map
    banks,  # (mean (V,L,B), max (V,L,B), pm_mean (V,L), pm_max (V,L), busy (V,L))
    b_mask,  # (L, B) bool
    ppi,  # (L,)
    width,  # (L,)
    layer_arrays,  # (L,)
    budgets,  # (C,) replica budget per config (0 = the warm start is final)
    a_idx,  # (C,) variant of the allocation bases
    sel,  # (C,) bank slot for the eval
    layerwise,  # (C,) bool: layer-wise barrier dataflow
    r0,  # (C, N) or (N,) warm-start replicas
    *,
    n_images: int = 64,
    clock_hz: float = 1e9,
):
    """K2 over C configs -> ``(T, ips, layer_T, util, r, rem)``, shaped
    ``(C,)/(C,)/(C, L)/(C, L)/(C, N)/(C,)``, float64, on the inputs' device.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation; its choices are ``kernel_plan``'s) and add one to
    ``fused_alloc_eval.launches``; CPU
    tensors run ``fused_alloc_eval_ref``.  Inputs are checked first (shapes,
    one-hot map, index ranges, positive costs, finite budgets), which reads
    six flags back from the device in one transfer."""
    p = _prepare(base, cost, unit_map, banks, b_mask, ppi, width, layer_arrays,
                 budgets, a_idx, sel, layerwise, r0)
    if p.base.device.type == "cpu":
        return _plain(p, int(n_images), float(clock_hz))
    if p.base.device.type != "cuda":
        raise ValueError(f"no kernel for device {p.base.device}")
    return _launch(p, int(n_images), float(clock_hz))


fused_alloc_eval.launches = 0

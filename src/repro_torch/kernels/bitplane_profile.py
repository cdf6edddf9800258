"""K1: bit-plane popcount + zero-skip block costing, the profiler's hot loop.

For every sampled patch and every crossbar block (a contiguous row slice of
the lowered matrix) the profiler needs the number of '1' bits per input
bit-plane and the zero-skip cycle count
``cycles_per_read * sum_p max(1, ceil(ones_p / rows_per_read))``.

One CUDA kernel (``csrc/bitplane_profile.cu``, which replaces the Pallas
``bitplane_profile_kernel`` of ``src/repro/kernels/bitplane_profile.py:37``)
serves two entries, each with a plain PyTorch version beside it:

* ``bitplane_grouped_cycles`` — the derive's entry: every layer's (S, rows)
  sample matrix, read in place, in one launch, to one flat int64 buffer of
  each layer's (S, B) cycles after the last; plain version
  ``bitplane_grouped_cycles_ref``.
* ``bitplane_block_profile`` — the Pallas kernel's (B, S, r) block entry
  (ones (B, 8, S) and cycles (B, S), int32), the one-entry case of the same
  kernel; plain version ``bitplane_block_profile_ref``.

A CUDA tensor launches the kernel on the current stream (no
synchronisation) and adds one to the wrapper's ``launches``; a CPU tensor
runs the plain version.  The kernel reads a small device table of entries
(``GroupedPlan``), built once per (tensors, block rows) and cached; it
reaches the card from pinned memory.  ``bitplane_profile`` slices a (S,
rows) patch matrix into zero-padded blocks around the block entry, as the
reference's wrapper does; ``bitplane_cycle_bank`` re-costs one popcount for
several ADC precisions (the fused sweep's derive).
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import NamedTuple, Sequence

import torch

from . import _build

__all__ = [
    "GroupedPlan",
    "bitplane_block_profile",
    "bitplane_block_profile_ref",
    "bitplane_cycle_bank",
    "bitplane_grouped_cycles",
    "bitplane_grouped_cycles_ref",
    "bitplane_profile",
    "grouped_plan",
]

PLANES = 8  # uint8 word-line inputs: one bit-plane per bit
TILE = 128  # samples a work item takes: the kernel's threads a block
MAX_BLOCK_ROWS = 512  # two staged tiles of TILE rows and the table fit in shared memory
MAX_ENTRIES = 256
MAX_ROWS_PER_READ = 32768  # the kernel's ceil division is exact below this
_PLAN_CACHE_SIZE = 64


@functools.cache
def _launcher():
    fn = _build.load("bitplane_profile").bitplane_grouped_launch
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


class GroupedPlan(NamedTuple):
    """K1's problem table on the card and what a launch needs beside it."""

    table: torch.Tensor  # (entries, 16) int64, the kernel's ``Entry`` rows
    n_items: int  # work items: (entry, block, TILE samples)
    total: int  # cycles the launch writes
    row_pitch: int  # shared-memory bytes a staged row takes
    offsets: tuple[int, ...]  # each entry's first cycle in the output


_PLANS: OrderedDict = OrderedDict()


def _row_pitch(block_rows: int) -> int:
    """Shared-memory bytes of a staged row: the smallest odd number of
    16-byte units above the block's units (odd, so threads reading their own
    rows 16 bytes at a time do not share banks; above, so an unaligned row's
    covering words, one more than its units hold, fit)."""
    units = -(-block_rows // 16) + 1
    return 16 * (units + 1 - units % 2)


def _plan(key, entries: list[tuple[int, ...]], device: torch.device) -> GroupedPlan:
    """Table rows from (ptr, S, rows, br, stride_s, stride_b, out_off, cs_s,
    cs_b) per entry, cached under ``key``: the table is a function of the
    key alone, so a reused key (a new tensor at a freed address with the
    same shape) gets the same, right, table."""
    rows, item, total, offsets = [], 0, 0, []
    for ptr, S, nrows, br, st_s, st_b, out_off, cs_s, cs_b in entries:
        n_blocks, tiles = -(-nrows // br), -(-S // TILE)
        aligned = int(all(v % 16 == 0 for v in (ptr, st_s, st_b, nrows, br)))
        rows.append((ptr, S, nrows, br, st_s, st_b, out_off, cs_s, cs_b, item, tiles, aligned,
                     0, 0, 0, 0))
        item += n_blocks * tiles
        total += S * n_blocks
        offsets.append(out_off)
    table = torch.tensor(rows, dtype=torch.int64)
    if device.type == "cuda":
        table = table.pin_memory().to(device, non_blocking=True)
    pitch = _row_pitch(max(e[3] for e in entries))
    plan = _PLANS[key] = GroupedPlan(table, item, total, pitch, tuple(offsets))
    if len(_PLANS) > _PLAN_CACHE_SIZE:
        _PLANS.popitem(last=False)
    return plan


def grouped_plan(qs: Sequence[torch.Tensor], block_rows: Sequence[int]) -> GroupedPlan:
    """The derive's table: one entry per (S, rows) uint8 CUDA matrix, its
    (S, ceil(rows / block_rows)) cycles after the previous entry's; cached
    by the matrices' addresses and shapes and the block rows."""
    block_rows = tuple(block_rows)
    key = (qs[0].get_device(), tuple((q.data_ptr(), q.shape) for q in qs), block_rows)
    plan = _PLANS.get(key)
    if plan is not None:
        _PLANS.move_to_end(key)
        return plan
    entries, off = [], 0
    for q, br in zip(qs, block_rows):
        s, rows = q.shape
        nb = -(-rows // br)
        entries.append((q.data_ptr(), s, rows, br, rows, br, off, nb, 1))
        off += s * nb
    return _plan(key, entries, qs[0].device)


def _block_plan(q_blocks: torch.Tensor) -> GroupedPlan:
    """The (B, S, r) block entry as one table entry: rows B*r, stride_s r,
    stride_b S*r; cycles and ones in the Pallas kernel's (B, ...) layout."""
    b, s, r = q_blocks.shape
    key = ("block", q_blocks.get_device(), q_blocks.data_ptr(), b, s, r)
    plan = _PLANS.get(key)
    if plan is not None:
        _PLANS.move_to_end(key)
        return plan
    return _plan(key, [(q_blocks.data_ptr(), s, b * r, r, r, s * r, 0, 1, s)], q_blocks.device)


def launch_plan(plan: GroupedPlan, cycles: torch.Tensor, ones: torch.Tensor | None,
                rows_per_read: int, cycles_per_read: int) -> None:
    """One launch of K1 on ``plan``'s table, with no checks and no count:
    ``cycles`` int64 (the derive) or int32 (the block entry), ``ones``
    int32 or None.  The wrappers call this after checking their inputs."""
    if plan.n_items == 0:
        return
    dev = cycles.device
    rc = _launcher()(
        plan.table.data_ptr(), plan.table.shape[0], plan.n_items,
        cycles.data_ptr(), int(cycles.dtype == torch.int64),
        0 if ones is None else ones.data_ptr(),
        plan.row_pitch, rows_per_read, cycles_per_read,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"bitplane_profile kernel launch failed: CUDA error {rc}")


def _check_costing(rows_per_read: int, block_rows: tuple[int, ...], device: torch.device) -> None:
    if rows_per_read < 1:
        raise ValueError(f"rows_per_read must be >= 1, got {rows_per_read}")
    if min(block_rows) < 1:
        raise ValueError(f"block rows must be >= 1, got {min(block_rows)}")
    if device.type == "cuda" and (max(block_rows) > MAX_BLOCK_ROWS or rows_per_read > MAX_ROWS_PER_READ):
        raise ValueError(
            f"the kernel takes block rows <= {MAX_BLOCK_ROWS} and rows_per_read <= "
            f"{MAX_ROWS_PER_READ}, got {max(block_rows)} and {rows_per_read}"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")


def bitplane_block_profile_ref(
    q_blocks: torch.Tensor, *, rows_per_read: int = 8, cycles_per_read: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1's block entry: a shift-and-mask sum per
    plane.  (B, S, r) uint8 -> (ones (B, 8, S) int32, cycles (B, S) int32)."""
    ones = torch.stack(
        [
            ((q_blocks >> (PLANES - 1 - p)) & 1).sum(dim=-1, dtype=torch.int64)
            for p in range(PLANES)
        ],
        dim=1,
    )
    reads = torch.clamp((ones + rows_per_read - 1) // rows_per_read, min=1)
    cycles = cycles_per_read * reads.sum(dim=1)
    return ones.to(torch.int32), cycles.to(torch.int32)


def bitplane_block_profile(
    q_blocks: torch.Tensor, *, rows_per_read: int = 8, cycles_per_read: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's block entry: (B, S, r) uint8 quantized patch rows, one block per
    slot, rows beyond a block's true extent zero-padded -> (ones (B, 8, S)
    int32, cycles (B, S) int32).

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation) and adds one to ``bitplane_block_profile.launches``; a
    CPU tensor runs ``bitplane_block_profile_ref``.  Anything else raises.
    """
    if not isinstance(q_blocks, torch.Tensor) or q_blocks.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 tensor, got {getattr(q_blocks, 'dtype', q_blocks)}")
    if q_blocks.dim() != 3:
        raise ValueError(f"expected (B, S, r), got shape {tuple(q_blocks.shape)}")
    b, s, r = q_blocks.shape
    _check_costing(rows_per_read, (r,), q_blocks.device)
    if q_blocks.device.type == "cpu":
        return bitplane_block_profile_ref(
            q_blocks, rows_per_read=rows_per_read, cycles_per_read=cycles_per_read
        )
    if not q_blocks.is_contiguous():
        raise ValueError("q_blocks must be contiguous")
    dev = q_blocks.device
    ones = torch.empty((b, PLANES, s), dtype=torch.int32, device=dev)
    cycles = torch.empty((b, s), dtype=torch.int32, device=dev)
    plan = _block_plan(q_blocks)
    if plan.n_items:
        launch_plan(plan, cycles, ones, rows_per_read, cycles_per_read)
        bitplane_block_profile.launches += 1
    return ones, cycles


bitplane_block_profile.launches = 0


def _check_grouped(qs, block_rows):
    """The matrices and block rows as tuples, after one pass of checks: uint8,
    2-D, all on one device and, on a CUDA device, contiguous."""
    qs, block_rows = tuple(qs), tuple(int(br) for br in block_rows)
    if not qs or len(qs) != len(block_rows):
        raise ValueError(f"{len(qs)} matrices for {len(block_rows)} block row counts")
    if len(qs) > MAX_ENTRIES:
        raise ValueError(f"at most {MAX_ENTRIES} matrices a launch, got {len(qs)}")
    device = qs[0].get_device() if isinstance(qs[0], torch.Tensor) else None
    for q in qs:
        if not isinstance(q, torch.Tensor) or q.dtype != torch.uint8:
            raise TypeError(f"expected uint8 tensors, got {getattr(q, 'dtype', q)}")
        if q.ndim != 2:
            raise ValueError(f"expected (S, rows) matrices, got shape {tuple(q.shape)}")
        if q.get_device() != device:
            raise ValueError(f"matrices on {q.device} and {qs[0].device}")
        if device >= 0 and not q.is_contiguous():
            raise ValueError("every matrix must be contiguous")
    return qs, block_rows


def bitplane_grouped_cycles_ref(
    qs: Sequence[torch.Tensor],
    block_rows: Sequence[int],
    *,
    rows_per_read: int = 8,
    cycles_per_read: int = 8,
) -> torch.Tensor:
    """Plain PyTorch version of K1's grouped entry: per matrix, the blocks
    zero-padded and a shift-and-mask sum per plane.  Returns the flat int64
    cycles, each (S, B) matrix after the previous one."""
    qs, block_rows = _check_grouped(qs, block_rows)
    out = []
    for q, br in zip(qs, block_rows):
        s, rows = q.shape
        nb = -(-rows // br)
        padded = q.new_zeros((s, nb * br))
        padded[:, :rows] = q
        x = padded.view(s, nb, br)
        ones = torch.stack(
            [((x >> (PLANES - 1 - p)) & 1).sum(dim=-1, dtype=torch.int64) for p in range(PLANES)]
        )  # (8, S, B)
        reads = torch.clamp((ones + rows_per_read - 1) // rows_per_read, min=1)
        out.append((cycles_per_read * reads.sum(dim=0)).reshape(-1))
    return torch.cat(out)


def bitplane_grouped_cycles(
    qs: Sequence[torch.Tensor],
    block_rows: Sequence[int],
    *,
    rows_per_read: int = 8,
    cycles_per_read: int = 8,
) -> torch.Tensor:
    """K1's grouped entry: (S_l, rows_l) uint8 matrices, contiguous, each cut
    into ceil(rows_l / block_rows_l) blocks of consecutive rows (the last
    may be short and costs as if zero-padded) -> flat int64 cycles, each
    matrix's (S_l, B_l) after the previous one (``grouped_plan(...).offsets``
    gives where each starts).

    CUDA tensors launch the kernel once for all matrices on the current
    stream and add one to ``bitplane_grouped_cycles.launches``; CPU tensors
    run ``bitplane_grouped_cycles_ref``.  Anything else raises."""
    qs, block_rows = _check_grouped(qs, block_rows)
    dev = qs[0].device
    _check_costing(rows_per_read, block_rows, dev)
    if dev.type == "cpu":
        return bitplane_grouped_cycles_ref(
            qs, block_rows, rows_per_read=rows_per_read, cycles_per_read=cycles_per_read
        )
    plan = grouped_plan(qs, block_rows)
    out = torch.empty(plan.total, dtype=torch.int64, device=dev)
    if plan.n_items:
        launch_plan(plan, out, None, rows_per_read, cycles_per_read)
        bitplane_grouped_cycles.launches += 1
    return out


bitplane_grouped_cycles.launches = 0


def bitplane_profile(
    patches_u8: torch.Tensor,
    *,
    block_rows: int,
    rows_per_read: int = 8,
    cycles_per_read: int = 8,
    block_fn=bitplane_block_profile,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's profiler-facing wrapper: slice a (S, rows) uint8 patch
    matrix into ``ceil(rows / block_rows)`` word-line blocks (zero-padding
    the last) and run ``block_fn`` (K1's block entry, or its plain version)
    on them.  Returns (ones (S, B, 8) int64, cycles (S, B) int64) on the
    input's device."""
    if not isinstance(patches_u8, torch.Tensor) or patches_u8.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 tensor, got {getattr(patches_u8, 'dtype', patches_u8)}")
    if patches_u8.dim() != 2:
        raise ValueError(f"expected (S, rows), got shape {tuple(patches_u8.shape)}")
    s, rows = patches_u8.shape
    n_blocks = -(-rows // block_rows)
    padded = patches_u8.new_zeros((s, n_blocks * block_rows))
    padded[:, :rows] = patches_u8
    blocks = padded.view(s, n_blocks, block_rows).transpose(0, 1).contiguous()
    ones, cyc = block_fn(
        blocks, rows_per_read=rows_per_read, cycles_per_read=cycles_per_read
    )
    return ones.permute(2, 0, 1).to(torch.int64), cyc.T.to(torch.int64)


def bitplane_cycle_bank(
    q_blocks: torch.Tensor,
    rows_per_read: tuple[int, ...],
    *,
    cycles_per_read: int = 8,
) -> torch.Tensor:
    """Multi-ADC zero-skip costing: one popcount, A re-costings.

    (..., S, r) uint8 blocks with zero-padded rows -> (A, ..., S) int32
    cycles, one slice per entry of ``rows_per_read``.  The '1' bits per
    plane come from ``bitplane_block_profile`` once (K1 on a CUDA tensor,
    its plain version on a CPU tensor); they do not depend on
    ``rows_per_read``, so re-costing them per ADC precision in torch gives
    the reference's integers exactly.  Padded (all-zero) blocks cost the
    1-read floor per plane and must be masked by the caller."""
    if not isinstance(q_blocks, torch.Tensor) or q_blocks.dim() < 2:
        raise ValueError("expected a (..., S, r) tensor")
    if not rows_per_read or min(rows_per_read) < 1:
        raise ValueError(f"rows_per_read must be >= 1, got {rows_per_read}")
    *lead, s, r = q_blocks.shape
    flat = q_blocks.reshape(-1, s, r).contiguous()
    ones, _ = bitplane_block_profile(
        flat, rows_per_read=int(rows_per_read[0]), cycles_per_read=cycles_per_read
    )  # (M, 8, S)
    banks = [
        cycles_per_read
        * torch.clamp((ones + rpr - 1) // rpr, min=1).sum(dim=1, dtype=torch.int32)
        for rpr in rows_per_read
    ]
    return torch.stack(banks).reshape(len(rows_per_read), *lead, s)

"""K1: bit-plane popcount + zero-skip block costing, the profiler's hot loop.

For every sampled patch and every crossbar block (a contiguous row slice of
the lowered matrix) the profiler needs the number of '1' bits per input
bit-plane and the zero-skip cycle count
``cycles_per_read * sum_p max(1, ceil(ones_p / rows_per_read))``.

``bitplane_block_profile`` launches the CUDA kernel
(``csrc/bitplane_profile.cu``, which replaces the Pallas
``bitplane_profile_kernel`` of ``src/repro/kernels/bitplane_profile.py:37``)
on a CUDA tensor, and runs the plain PyTorch version
``bitplane_block_profile_ref`` on a CPU tensor.  ``bitplane_profile`` slices
a (S, rows) patch matrix into zero-padded blocks around either one;
``bitplane_cycle_bank`` re-costs one popcount for several ADC precisions
(the fused sweep's derive).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = [
    "bitplane_block_profile",
    "bitplane_block_profile_ref",
    "bitplane_cycle_bank",
    "bitplane_profile",
]

PLANES = 8  # uint8 word-line inputs: one bit-plane per bit


@functools.cache
def _launcher():
    fn = _build.load("bitplane_profile").bitplane_profile_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bitplane_block_profile_ref(
    q_blocks: torch.Tensor, *, rows_per_read: int = 8, cycles_per_read: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: a shift-and-mask sum per plane.
    (B, S, r) uint8 -> (ones (B, 8, S) int32, cycles (B, S) int32)."""
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
    """K1: (B, S, r) uint8 quantized patch rows, one block per slot, rows
    beyond a block's true extent zero-padded -> (ones (B, 8, S) int32,
    cycles (B, S) int32).

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation) and adds one to ``bitplane_block_profile.launches``; a
    CPU tensor runs ``bitplane_block_profile_ref``.  Anything else raises.
    """
    if not isinstance(q_blocks, torch.Tensor) or q_blocks.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 tensor, got {getattr(q_blocks, 'dtype', q_blocks)}")
    if q_blocks.dim() != 3:
        raise ValueError(f"expected (B, S, r), got shape {tuple(q_blocks.shape)}")
    if rows_per_read < 1:
        raise ValueError(f"rows_per_read must be >= 1, got {rows_per_read}")
    if q_blocks.device.type == "cpu":
        return bitplane_block_profile_ref(
            q_blocks, rows_per_read=rows_per_read, cycles_per_read=cycles_per_read
        )
    if q_blocks.device.type != "cuda":
        raise ValueError(f"no kernel for device {q_blocks.device}")
    if not q_blocks.is_contiguous():
        raise ValueError("q_blocks must be contiguous")
    b, s, r = q_blocks.shape
    dev = q_blocks.device
    ones = torch.empty((b, PLANES, s), dtype=torch.int32, device=dev)
    cycles = torch.empty((b, s), dtype=torch.int32, device=dev)
    rc = _launcher()(
        q_blocks.data_ptr(), ones.data_ptr(), cycles.data_ptr(),
        b, s, r, rows_per_read, cycles_per_read,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"bitplane_profile kernel launch failed: CUDA error {rc}")
    bitplane_block_profile.launches += 1
    return ones, cycles


bitplane_block_profile.launches = 0


def bitplane_profile(
    patches_u8: torch.Tensor,
    *,
    block_rows: int,
    rows_per_read: int = 8,
    cycles_per_read: int = 8,
    block_fn=bitplane_block_profile,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Profiler-facing wrapper: slice a (S, rows) uint8 patch matrix into
    ``ceil(rows / block_rows)`` word-line blocks (zero-padding the last) and
    run ``block_fn`` (K1, or its plain version) on them.  Returns (ones
    (S, B, 8) int64, cycles (S, B) int64) on the input's device."""
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

"""K3: the zero-skip matmul.

``zskip_matmul`` takes the Pallas kernel's arguments: A (M, K), B (K, N) and
an int32 block mask (M/bm, K/bk), 0 where the A tile is skipped, and returns
A @ B with the skipped A tiles taken as zero, summed in float32 and written
in A's type (or ``out_dtype``).  M, N and K must be multiples of the tiles,
as the reference asserts.  On CUDA tensors it launches the CUDA kernel
(``csrc/zskip_matmul.cu``, which replaces the Pallas ``zskip_matmul_kernel``
of ``src/repro/kernels/zskip_matmul.py:28``); on CPU tensors it runs the
plain version ``zskip_matmul_ref``.

``zskip_matmul_op`` is the model's entry point (``kernels.ops``): it builds
the mask on A's device ("any nonzero in the (bm, bk) tile", one reduction,
``block_mask``) and takes any M, N and K.  A ragged last row tile counts
only its real rows; a K that is not a multiple of ``bk`` (no config's
d_ff, but any MLP width) is padded with zero columns first, a copy.  Both kernel entry points
count their launches on ``zskip_matmul.launches``.  ``zero_tiles`` counts
the tiles of A that the op's mask skips.

``block_mask_ref`` and ``zskip_matmul_ref`` are copies of the reference's
``kernels/ref.py`` oracles; ``zskip_matmul_op_ref`` is the op's plain
version.  The source holds one kernel per type: bf16 on the tensor cores
(``wgmma`` fed by TMA, one persistent block per SM), float32 on the CUDA
cores in float32.  TMA reads rows that start on 16 bytes, so a bf16 operand
whose base or row stride is not (B with N not a multiple of 8, a view at an
odd offset) is copied first, B with zero columns added; the kernel stores
only the real N columns.

Under autograd (grad mode on and an input that requires a gradient)
``zskip_matmul_op`` runs through ``ZSkipMatmulFn``: the forward is the op
above, the kernel on the card (the plain version on the host); the backward
is the gradient of the product A @ B that the kernel computes, ``dA = dY @
B^T`` and ``dB = A^T @ dY`` with ``torch.matmul`` in the operands' type, as
the reference's autodiff differentiates the model's product outside any
Pallas kernel (the Pallas kernel has no backward).  The mask takes no
gradient; K's padding never leaves the forward.  In a skipped tile dA is
the product's gradient, where autograd of the plain version gives 0 (it
takes the mask as a constant); the model's squared-ReLU backward multiplies
both by 0 there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._autograd import wants_grad

__all__ = [
    "ZSkipMatmulFn",
    "block_mask",
    "block_mask_ref",
    "zero_tiles",
    "zskip_matmul",
    "zskip_matmul_op",
    "zskip_matmul_op_ref",
    "zskip_matmul_ref",
]

TILES = (64, 128)  # the mask granularities the kernel takes, as bm, bn and bk
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' own tiles (csrc/zskip_matmul.cu): (rows, columns, K step)
_KERNEL_TILE = {torch.float32: (64, 64, 16), torch.bfloat16: (128, 256, 64)}
_MAX_SPLITS = 16


@functools.cache
def _launcher():
    fn = _build.load("zskip_matmul").zskip_matmul_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 6
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def block_mask_ref(a: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """(M/bm, K/bk) int32 map: 1 where the A tile has any nonzero."""
    M, K = a.shape
    tiles = a.reshape(M // bm, bm, K // bk, bk)
    return (tiles.abs().sum(dim=(1, 3)) > 0).to(torch.int32)


def zskip_matmul_ref(a, b, block_mask, bm: int, bk: int, out_dtype=None) -> torch.Tensor:
    """Matmul with zeroed-out skipped A tiles (== exact matmul when the mask
    marks exactly the all-zero tiles), in float32, out in A's type or
    ``out_dtype``.  A ragged last row tile of A takes its mask row."""
    M, K = a.shape
    mask_full = block_mask.repeat_interleave(bm, dim=0).repeat_interleave(bk, dim=1)[:M, :K]
    a_eff = a * mask_full.to(a.dtype)
    return (a_eff.float() @ b.float()).to(out_dtype or a.dtype)


def block_mask(a: torch.Tensor, bm: int = 128, bk: int = 128) -> torch.Tensor:
    """(ceil(M/bm), K/bk) int32 on A's device, 1 where the tile has any
    nonzero: one reduction over A, a ragged last row tile over its real rows
    only.  Equal to ``block_mask_ref`` wherever that is defined."""
    M, K = a.shape
    if K % bk:
        raise ValueError(f"K {K} is not a multiple of bk {bk}")
    nz = a.ne(0)
    rows = -(-M // bm)
    if rows * bm != M:
        nz = torch.cat([nz, nz.new_zeros((rows * bm - M, K))])
    return nz.view(rows, bm, K // bk, bk).any(dim=3).any(dim=1).to(torch.int32)


def zero_tiles(a: torch.Tensor, bm: int = 128, bk: int = 128) -> tuple[int, int]:
    """(zero tiles, tiles) of A at the op's granularity: the tiles K3 skips.
    Reads the count back to the host."""
    m = block_mask(a, bm, bk)
    return int(m.numel() - m.sum()), m.numel()


def _check_tiles(bm, bn, bk):
    for name, t in (("bm", bm), ("bn", bn), ("bk", bk)):
        if t not in TILES:
            raise ValueError(f"K3 takes {name} in {TILES}, got {t}")


def _check_operands(a, b):
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        raise TypeError("zskip_matmul takes torch tensors")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a and b must be 2-D, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ in K")
    if a.dtype != b.dtype:
        raise TypeError(f"a and b must share a dtype, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")


def _splits(M, N, K, dtype, device) -> tuple[int, int]:
    """(K steps per split, splits): K is split across blocks when the
    output tiles alone leave SMs idle.  float32 launches a block per tile
    and aims at two a SM; bf16 runs one persistent block per SM and splits
    so that the (tile, split) units make one wave."""
    tm, tn, tk = _KERNEL_TILE[dtype]
    steps = K // tk
    blocks = -(-M // tm) * -(-N // tn)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if blocks >= sms or steps <= 1:
        return steps, 1
    if dtype == torch.float32:
        want = min(steps, -(-2 * sms // blocks), _MAX_SPLITS)
    else:
        want = max(1, min(steps, sms // blocks, _MAX_SPLITS))
    per = -(-steps // want)
    return per, -(-steps // per)


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read the rows of bf16 ``t``: contiguous columns, a
    base and a row stride on 16 bytes (8 elements)."""
    return t.stride(1) == 1 and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0


def _for_tma(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when TMA can read it, else a copy that it can: rows of
    a multiple of 8 elements, any added columns zero."""
    if _tma_ready(t):
        return t
    rows, cols = t.shape
    out = t.new_zeros((rows, -(-cols // 8) * 8))
    out[:, :cols] = t
    return out


def _launch(a, b, mask, bm: int, bk: int, out_dtype) -> torch.Tensor:
    """Launch K3 on checked CUDA tensors; M and N any, K a multiple of bk,
    ``mask`` (ceil(M/bm), K/bk)."""
    if a.dtype not in _DTYPES:
        raise TypeError(f"K3 takes float32 or bfloat16, got {a.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"K3 writes float32 or bfloat16, got {out_dtype}")
    M, K = a.shape
    N = b.shape[1]
    if a.dtype == torch.bfloat16:
        a, b = _for_tma(a), _for_tma(b)
    else:
        a = a if a.stride(1) == 1 else a.contiguous()
        b = b if b.stride(1) == 1 else b.contiguous()
    mask = mask.to(device=a.device, dtype=torch.int32).contiguous()
    o = torch.empty((M, N), dtype=out_dtype, device=a.device)
    per, splits = _splits(M, N, K, a.dtype, a.device)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=a.device) if splits > 1 else None
    dev = a.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    queue = _build.work_queue(dev, stream) if a.dtype == torch.bfloat16 else None
    rc = _launcher()(
        a.data_ptr(), b.data_ptr(), mask.data_ptr(), o.data_ptr(), 0 if ws is None else ws.data_ptr(),
        0 if queue is None else queue.data_ptr(),
        _DTYPES[a.dtype], int(out_dtype == torch.bfloat16), M, N, K,
        a.stride(0), b.stride(0), o.stride(0), bm, bk, mask.shape[1], per, splits,
        dev.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"zskip_matmul kernel launch failed: CUDA error {rc}")
    zskip_matmul.launches += 1
    return o


def zskip_matmul(a, b, block_mask, *, bm: int = 128, bn: int = 128, bk: int = 128, out_dtype=None):
    """K3: a (M, K) @ b (K, N) with the A tiles whose ``block_mask`` entry
    is 0 skipped -> (M, N) in a's type or ``out_dtype``.

    M, N and K must be multiples of bm, bn and bk (each 64 or 128), and the
    mask (M/bm, K/bk).  CUDA tensors launch the kernel on the current stream
    (no synchronisation) and add one to ``zskip_matmul.launches``; CPU
    tensors run ``zskip_matmul_ref``."""
    _check_operands(a, b)
    _check_tiles(bm, bn, bk)
    M, K = a.shape
    N = b.shape[1]
    if M % bm or N % bn or K % bk:
        raise ValueError(f"(M, N, K) = {(M, N, K)} must be multiples of (bm, bn, bk) = {(bm, bn, bk)}")
    if tuple(block_mask.shape) != (M // bm, K // bk):
        raise ValueError(f"block_mask {tuple(block_mask.shape)} != {(M // bm, K // bk)}")
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return zskip_matmul_ref(a, b, block_mask, bm, bk, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    return _launch(a, b, block_mask, bm, bk, out_dtype)


def _pad_k(a, b, bk: int):
    """a and b with K padded by zero columns / rows to a multiple of bk."""
    pad = -a.shape[1] % bk
    if not pad:
        return a, b
    return torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, 0, 0, pad))


def zskip_matmul_op_ref(a, b, bm: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain version of ``zskip_matmul_op``: K padded as the op pads it, the
    op's mask, then ``zskip_matmul_ref``."""
    a, b = _pad_k(a, b, bk)
    return zskip_matmul_ref(a, b, block_mask(a, bm, bk), bm, bk)


def zskip_matmul_op(a, b, *, bm: int = 128, bn: int = 128, bk: int = 128) -> torch.Tensor:
    """The model's K3: a (M, K) @ b (K, N) -> (M, N) in a's type, skipping
    the all-zero (bm, bk) tiles of a (the mask is built on a's device).
    Any M, N and K (K padded with zeros to a multiple of bk).  CPU tensors
    run ``zskip_matmul_op_ref``; CUDA tensors launch the kernel."""
    _check_operands(a, b)
    _check_tiles(bm, bn, bk)
    if wants_grad(a, b):
        return ZSkipMatmulFn.apply(a, b, bm, bk)
    return _op_forward(a, b, bm, bk)


def _op_forward(a, b, bm: int, bk: int) -> torch.Tensor:
    if a.device.type == "cpu":
        return zskip_matmul_op_ref(a, b, bm, bk)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    a, b = _pad_k(a, b, bk)
    return _launch(a, b, block_mask(a, bm, bk), bm, bk, a.dtype)


class ZSkipMatmulFn(torch.autograd.Function):
    """``zskip_matmul_op`` under autograd: K3 (or, on the host, its plain
    version) forward; the product's gradients backward."""

    @staticmethod
    def forward(ctx, a, b, bm: int, bk: int):
        ctx.save_for_backward(a, b)
        return _op_forward(a, b, bm, bk)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dy = dy.to(a.dtype)
        da = torch.matmul(dy, b.T) if ctx.needs_input_grad[0] else None
        db = torch.matmul(a.T, dy) if ctx.needs_input_grad[1] else None
        return da, db, None, None


zskip_matmul.launches = 0

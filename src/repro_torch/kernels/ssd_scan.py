"""K5: the Mamba2 SSD per-chunk terms.

For every cell (one chunk of ``Q`` positions of one sequence) and head,
``ssd_chunk`` returns the intra-chunk output and the chunk's summary state:

    y_intra[q, h, :] = sum_{k<=q} (C_q . B_k) exp(cum_q,h - cum_k,h) xdt[k, h, :]
    S_chunk[h, n, :] = sum_k exp(cum_last,h - cum_k,h) B[k, n] xdt[k, h, :]

On CUDA tensors it launches the CUDA kernel (``csrc/ssd_chunk.cu``, which
replaces the Pallas ``_ssd_chunk_kernel`` of
``src/repro/kernels/ssd_scan.py:30``) over all cells in one launch; on CPU
tensors it runs the plain PyTorch version ``ssd_chunk_ref``, the
reference's ``kernels/ref.py::ssd_chunk_ref``.  The kernel keeps the
Pallas kernel's types: float32 scores, decays and sums, y in xdt's type, S
in float32, and the decayed B of the state rounded to B's type.

The source holds three kernels, chosen by type and shape:

* bf16 at the models' shapes (Q 128, P 64, N 64 or 128: Zamba2-1.2B and
  Mamba2-370M): the Hopper kernel, ``wgmma`` fed by TMA, one persistent
  block per SM with a producer warp and two consumer warpgroups, taking
  (cell, head group) work items from a work queue; y's float32 weights go
  to the tensor cores as two bf16 pieces (16 bits of the weight);
* bf16 at other shapes with Q <= 128, Q and N multiples of 16, P of 8 and
  P <= 128 (the SMOKE configs, the tests' small shapes): the ``mma.sync``
  kernel (y's weights as two tf32 parts); other bf16 shapes raise;
* float32: the CUDA-core kernel at any shape that fits in shared memory.

``head_group`` picks the heads of one work item (one block of the other
kernels) for the card's SM count.

Under autograd (grad mode on and an input that requires a gradient)
``ssd_chunk`` runs through ``SSDChunkFn``: the forward is the call above,
the kernel on the card (the plain version on the host); the backward
recomputes ``ssd_chunk_ref`` with grad on and returns the gradients of both
outputs, y_intra and S_chunk.  No backward kernel: the Pallas kernel has
none.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._autograd import recompute_grads, wants_grad

__all__ = ["SSDChunkFn", "head_group", "ssd_chunk", "ssd_chunk_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232_448  # the most shared memory one block may use on the card


@functools.cache
def _lib():
    lib = _build.load("ssd_chunk")
    lib.ssd_chunk_launch.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    )
    lib.ssd_chunk_launch.restype = ctypes.c_int
    lib.ssd_chunk_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd_chunk_ref(cum, xdt, B, C) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5, in float32: cum (nc, Q, H), xdt
    (nc, Q, H, P), B and C (nc, Q, N) -> (y_intra (nc, Q, H, P) in xdt's
    type, S_chunk (nc, H, N, P) float32).  The decay is masked before the
    exponential: its upper triangle overflows.  The state's decayed B is
    rounded to B's type, as the Pallas kernel's ``B * decay.astype(B.dtype)``."""
    cum = cum.float()
    Q = cum.shape[1]
    diff = cum[:, :, None, :] - cum[:, None, :, :]  # (nc, Q, Q, H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()[None, :, :, None]
    L = torch.exp(diff.masked_fill(~tri, float("-inf")))
    scores = torch.einsum("cqn,ckn->cqk", C.float(), B.float())
    y = torch.einsum("cqkh,ckhp->cqhp", scores[..., None] * L, xdt.float())
    decay_end = torch.exp(cum[:, -1:, :] - cum)  # (nc, Q, H)
    decay_end = decay_end.to(B.dtype).float()
    bw = (decay_end[..., None] * B.float()[:, :, None, :]).to(B.dtype).float()  # (nc, Q, H, N)
    S = torch.einsum("ckhn,ckhp->chnp", bw, xdt.float())
    return y.to(xdt.dtype), S


def _check(cum, xdt, B, C):
    for t in (cum, xdt, B, C):
        if not isinstance(t, torch.Tensor):
            raise TypeError("ssd_chunk takes torch tensors")
    if cum.dim() != 3 or xdt.dim() != 4 or B.dim() != 3 or C.dim() != 3:
        raise ValueError("want cum (nc, Q, H), xdt (nc, Q, H, P), B and C (nc, Q, N)")
    nc, Q, H = cum.shape
    if xdt.shape[:3] != (nc, Q, H):
        raise ValueError(f"xdt {tuple(xdt.shape)} does not match cum {tuple(cum.shape)}")
    if B.shape != C.shape or B.shape[:2] != (nc, Q):
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must be ({nc}, {Q}, N)")
    if not (cum.device == xdt.device == B.device == C.device):
        raise ValueError("ssd_chunk: every input must lie on one device")


@functools.lru_cache(maxsize=256)
def head_group(nc: int, H: int, sms: int) -> int:
    """Heads of one work item (a cell's B, C and scores serve them all):
    the size that finishes soonest on ``sms`` SMs when every item costs its
    heads plus one (its scores and its B and C), the larger on a tie.  The
    items, ``nc * ceil(H / group)``, then run in ``ceil(items / sms)`` waves.
    Zamba2-1.2B's prefill (32 cells x 64 heads) takes groups of 16 on the
    H100's 132 SMs (128 items, one wave), Mamba2-370M's (8 x 32) groups of 2."""
    if nc < 1 or H < 1 or sms < 1:
        raise ValueError(f"head_group needs nc, H and sms >= 1, got {nc}, {H}, {sms}")
    best, group = None, 1
    for hg in range(1, H + 1):
        cost = -(-(nc * -(-H // hg)) // sms) * (hg + 1)
        if best is None or cost <= best:
            best, group = cost, hg
    return group


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=64)
def _smem_bytes(dtype: int, Q: int, N: int, P: int) -> int:
    return _lib().ssd_chunk_smem_bytes(dtype, Q, N, P)


def _launch_args(cum, xdt, B, C, y, S) -> tuple:
    """The arguments of ``ssd_chunk_launch`` for checked, contiguous, 16-byte
    aligned CUDA tensors of one type, writing y and S on the current stream."""
    nc, Q, H, P = xdt.shape
    N = B.shape[-1]
    dev = xdt.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    return (
        cum.data_ptr(), xdt.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), S.data_ptr(),
        _DTYPES[xdt.dtype], nc, Q, H, P, N, head_group(nc, H, _sm_count(dev.index)),
        _build.work_queue(dev, stream).data_ptr(), dev.index, stream,
    )


def ssd_chunk(cum, xdt, B, C):
    """K5 over nc cells -> (y_intra (nc, Q, H, P) in xdt's type, S_chunk
    (nc, H, N, P) float32).

    CUDA tensors (float32, or bfloat16 at a tensor-core kernel's shapes,
    all four of one type) launch the kernel once on the current stream (no
    synchronisation), ``head_group`` heads per work item, and add one to
    ``ssd_chunk.launches``; other bfloat16 shapes raise.  CPU tensors run
    ``ssd_chunk_ref``."""
    _check(cum, xdt, B, C)
    if wants_grad(cum, xdt, B, C):
        return SSDChunkFn.apply(cum, xdt, B, C)
    return _forward(cum, xdt, B, C)


def _forward(cum, xdt, B, C):
    if cum.device.type == "cpu":
        return ssd_chunk_ref(cum, xdt, B, C)
    if cum.device.type != "cuda":
        raise ValueError(f"no kernel for device {cum.device}")
    dtype = xdt.dtype
    if dtype not in _DTYPES or not (cum.dtype == B.dtype == C.dtype == dtype):
        raise TypeError(
            f"K5 takes float32 or bfloat16, all of one type; got cum {cum.dtype}, "
            f"xdt {xdt.dtype}, B {B.dtype}, C {C.dtype}"
        )
    nc, Q, H, P = xdt.shape
    N = B.shape[-1]
    smem = _smem_bytes(_DTYPES[dtype], Q, N, P)
    if smem < 0:
        raise ValueError(
            f"K5 in bfloat16 takes Q <= 128, Q and N multiples of 16, P a multiple of 8 up to 128; "
            f"got Q={Q}, N={N}, P={P}"
        )
    if smem > MAX_SMEM:
        raise ValueError(f"K5 at Q={Q}, N={N}, P={P} needs {smem} B of shared memory (at most {MAX_SMEM})")
    # contiguous and 16-byte aligned (the bf16 kernels' loads): else a fresh copy
    cum, xdt, B, C = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                      else t.clone(memory_format=torch.contiguous_format) for t in (cum, xdt, B, C))
    y = torch.empty((nc, Q, H, P), dtype=dtype, device=xdt.device)
    S = torch.empty((nc, H, N, P), dtype=torch.float32, device=xdt.device)
    rc = _lib().ssd_chunk_launch(*_launch_args(cum, xdt, B, C, y, S))
    if rc != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error {rc}")
    ssd_chunk.launches += 1
    return y, S


class SSDChunkFn(torch.autograd.Function):
    """``ssd_chunk`` under autograd: K5 (or, on the host, its plain version)
    forward; the backward differentiates a recomputation of
    ``ssd_chunk_ref`` through both outputs."""

    @staticmethod
    def forward(ctx, cum, xdt, B, C):
        ctx.save_for_backward(cum, xdt, B, C)
        return _forward(cum, xdt, B, C)

    @staticmethod
    def backward(ctx, dy, dS):
        return recompute_grads(ssd_chunk_ref, ctx.saved_tensors, (dy, dS), ctx.needs_input_grad)


ssd_chunk.launches = 0

"""K4: flash attention forward.

``flash_attention`` takes the Pallas kernel's arguments, (bh, s, hd) query,
key and value with the heads folded into the batch axis, and returns the
attention output in q's type.  On CUDA tensors it launches the CUDA kernel
(``csrc/flash_attention.cu``, which replaces the Pallas ``_fa_kernel`` of
``src/repro/kernels/flash_attention.py:31``); on CPU tensors it runs the
plain PyTorch version ``flash_attention_ref``, the dense float32 softmax of
the reference's ``kernels/ref.py::flash_attention_ref``.

``flash_attention_op`` is the same kernel on the model's (b, s, h, hd)
layout: the kernel takes each tensor's strides, so the heads need no
transpose.  k and v may hold fewer heads than q (grouped kv heads): query
head h reads kv head ``h // (nq // nkv)``, the grouping of the reference
model's ``_sdpa_block``, and k and v are never repeated per head.
``flash_attention_op_ref`` is its plain version.  Both kernel
entry points count their launches on ``flash_attention.launches``.

``flash_attention_op(..., round_scores=True)`` rounds each score q . k to
the inputs' type before the float32 scale and softmax, as the reference
model's ``_sdpa_block`` does (its bf16 einsum, then the division by
``np.sqrt(hd)`` in float32); the model's prompt attention passes it.  By
default, and always in ``flash_attention``, the scores stay float32, the
Pallas kernel's function.  In float32 the rounding changes nothing.

The source holds one kernel per type: bf16 runs on the tensor cores (head
dims 64 and 128 with ``wgmma`` fed by TMA, 16 and 32 with ``mma.sync``),
which read rows that start on 16 bytes, so bf16 tensors whose rows do not
(none that the models pass) are copied first; float32 runs on the CUDA cores
in float32 at any strides.

Under autograd (grad mode on and an input that requires a gradient)
``flash_attention_op`` runs through ``FlashAttentionFn``: the forward is the
call above, the kernel on the card (the plain version on the host); the
backward recomputes ``flash_attention_op_ref`` with grad on, with the same
``round_scores``, and returns its gradients (grouped kv heads sum their
group's through ``repeat_interleave``'s backward).  Its (b*h, s, s) float32
scores live only inside one call's backward.  No backward kernel: the
Pallas kernel has none.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from ._autograd import recompute_grads, wants_grad

__all__ = [
    "FlashAttentionFn",
    "flash_attention",
    "flash_attention_op",
    "flash_attention_op_ref",
    "flash_attention_ref",
]

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def flash_attention_ref(q, k, v, causal: bool = True, *, round_scores: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K4: (bh, sq, hd) dense softmax attention in
    float32, the causal mask counted from position 0 in q and in k, out in
    q's type.  ``round_scores`` rounds q . k to q's type before the scale."""
    sq, hd = q.shape[1], q.shape[2]
    sk = k.shape[1]
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float())
    if round_scores:
        s = s.to(q.dtype).float()
    s = s / math.sqrt(hd)
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)


def _check(q, k, v, layout: str):
    for t in (q, k, v):
        if not isinstance(t, torch.Tensor):
            raise TypeError("flash attention takes torch tensors")
    if q.dim() != len(layout) or k.dim() != len(layout) or v.dim() != len(layout):
        raise ValueError(f"q, k, v must be {layout}, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or head dim")
    if layout == "bshd" and q.shape[2] % k.shape[2] != 0:
        raise ValueError(
            f"K4 takes q heads that are a multiple of the kv heads, got {q.shape[2]} and {k.shape[2]}"
        )
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash attention needs at least one query and one key")


def _rows_aligned(t) -> bool:
    """Whether every row of bf16 ``t`` starts on 16 bytes (8 elements)."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1])


def _launch(q, k, v, causal: bool, round_scores: bool = False) -> torch.Tensor:
    """Launch K4 on checked CUDA tensors: (bh, s, hd) when 3-D (one head per
    batch row), (b, s, h, hd) when 4-D, k and v with h / group heads; each
    is passed by its (batch, seq, head) element strides and the output is
    contiguous in q's shape."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"K4 takes float32 or bfloat16, got {q.dtype}")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"K4 takes head dims {HEAD_DIMS}, got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous head dim")
    if q.dtype == torch.bfloat16:
        q, k, v = (t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    queue = _build.work_queue(dev, stream) if q.dtype == torch.bfloat16 else None
    four_d = q.dim() == 4

    def strides(t):
        return (t.stride(0), t.stride(1), t.stride(2) if four_d else 0)

    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
        q.shape[0], q.shape[2] if four_d else 1, q.shape[2] // k.shape[2] if four_d else 1,
        q.shape[1], k.shape[1], hd,
        *strides(q), *strides(k), *strides(v), *strides(o),
        int(bool(causal)), int(bool(round_scores)), 0 if queue is None else queue.data_ptr(),
        dev.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return o


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """K4: q (bh, sq, hd), k and v (bh, sk, hd) -> (bh, sq, hd) in q's type.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and add one to ``flash_attention.launches``; CPU tensors
    run ``flash_attention_ref``.  Any sq and sk; hd in 16/32/64/128; float32
    or bfloat16."""
    _check(q, k, v, "bsd")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(q, k, v, causal)


def flash_attention_op_ref(q, k, v, causal: bool = True, *, round_scores: bool = False) -> torch.Tensor:
    """Plain version of ``flash_attention_op``: each kv head repeated for
    its group of query heads (head h reads kv head h // group), then the
    heads folded into the batch axis for ``flash_attention_ref``."""
    b, sq, h, hd = q.shape
    group = h // k.shape[2]
    k, v = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)

    def fold(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], hd)

    o = flash_attention_ref(fold(q), fold(k), fold(v), causal, round_scores=round_scores)
    return o.reshape(b, h, sq, hd).transpose(1, 2)


def flash_attention_op(q, k, v, *, causal: bool = True, round_scores: bool = False) -> torch.Tensor:
    """K4 on the model's layout: q (b, sq, h, hd), k and v (b, sk, nkv, hd)
    with h a multiple of nkv -> (b, sq, h, hd), query head i attending to kv
    head i // (h // nkv); ``round_scores`` rounds q . k to q's type before
    the scale, as the reference model does.  CPU tensors run
    ``flash_attention_op_ref``; on CUDA tensors the kernel reads the heads
    by stride, with no copy of k or v per query head."""
    _check(q, k, v, "bshd")
    if wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, round_scores)
    return _op_forward(q, k, v, causal, round_scores)


def _op_forward(q, k, v, causal: bool, round_scores: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_op_ref(q, k, v, causal, round_scores=round_scores)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(q, k, v, causal, round_scores)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention_op`` under autograd: K4 (or, on the host, its plain
    version) forward; the backward differentiates a recomputation of
    ``flash_attention_op_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, round_scores: bool):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, round_scores=round_scores)
        return _op_forward(q, k, v, causal, round_scores)

    @staticmethod
    def backward(ctx, do):
        grads = recompute_grads(flash_attention_op_ref, ctx.saved_tensors, (do,), ctx.needs_input_grad[:3],
                                **ctx.kw)
        return (*grads, None, None)


flash_attention.launches = 0

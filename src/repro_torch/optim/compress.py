"""Gradient compression: per-tensor int8 with error feedback (reference:
``src/repro/optim/compress.py``).

At two pods and more the ``pod`` axis rides the slowest links, so the
gradient is reduced in full precision within a pod and as int8 across
pods, the quantisation error carried to the next step (error feedback).

``quantize_int8`` / ``dequantize_int8`` and the error-feedback helpers are
the reference's expressions; stochastic rounding draws its uniforms from a
``torch.Generator`` (the reference's from a ``jax.random`` key: the same
distribution, other numbers).  ``compressed_psum`` is the reference's int8
ring over a process group: ``axis_size - 1`` hops, each sending the int8
tensor and its float32 scale one rank on (``batch_isend_irecv``), the
received values dequantised and added in float32 in the reference's order,
each product and sum (and the error's product and difference) rounded
once, as XLA compiles the reference's expressions (a fused multiply-add).
The int8 payload is what travels: 4x less than a float32 all-reduce.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .adamw import named

__all__ = [
    "apply_error_feedback",
    "compressed_psum",
    "dequantize_int8",
    "init_error_feedback",
    "quantize_int8",
]


def quantize_int8(x: torch.Tensor, generator: torch.Generator | None = None):
    """Per-tensor symmetric int8, rounded to nearest (ties to even, as
    ``jnp.round``) or, with ``generator``, stochastically.  Returns (q int8,
    scale float32)."""
    # a tensor divisor: CUDA divides by a Python scalar as a product by its
    # reciprocal, one float32 step off the division
    scale = torch.max(torch.abs(x)).float() / torch.full((), 127.0, device=x.device) + 1e-30
    y = x.float() / scale
    if generator is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=generator, device=y.device))
    else:
        y = torch.round(y)
    return torch.clamp(y, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _ring_hop(q: torch.Tensor, scale: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """Send (q, scale) to the next rank of ``group`` and receive the
    previous rank's (the reference's ``ppermute`` by ``i -> i + 1``)."""
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    rq, rs = torch.empty_like(q), torch.empty_like(scale)
    nxt, prv = dist.get_global_rank(group, (me + 1) % n), dist.get_global_rank(group, (me - 1) % n)
    ops = [dist.P2POp(dist.isend, q, nxt, group), dist.P2POp(dist.isend, scale, nxt, group),
           dist.P2POp(dist.irecv, rq, prv, group), dist.P2POp(dist.irecv, rs, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return rq, rs


def _fma(c: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """c + q * scale in float32, rounded once, as XLA compiles the
    reference's expressions (a fused multiply-add): exact in float64 here,
    q being int8."""
    return (c.double() + q.double() * scale.double()).float()


def compressed_psum(x: torch.Tensor, group=None, generator: torch.Generator | None = None):
    """int8 mean over the ranks of ``group`` (a process group; ``None`` is
    the world), with the int8 payload on the wire.  Returns (the mean in
    x's type, this rank's quantisation error in float32, for feedback).
    One rank (or no process group) is the identity ring: the mean is the
    dequantised value itself.  A DTensor ``x`` (the automatic axes of a
    ``shard_map`` region) is quantised as one tensor, its scale the max
    over every shard, and each rank sends its shard of the int8 tensor."""
    q, scale = quantize_int8(x, generator)
    err = _fma(x.float(), q, -scale)
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    total = dequantize_int8(q, scale)
    if n > 1:
        sharded = isinstance(q, DTensor)
        rq = (q.to_local() if sharded else q).contiguous()
        rs = (scale.to_local() if sharded else scale).reshape(1).contiguous()
        acc = total.to_local() if sharded else total
        for _ in range(n - 1):
            rq, rs = _ring_hop(rq, rs, group)
            acc = _fma(acc, rq, rs[0])
        total = DTensor.from_local(acc, q.device_mesh, q.placements, run_check=False, shape=q.shape,
                                   stride=q.stride()) if sharded else acc
    return (total / n).to(x.dtype), err


def init_error_feedback(params) -> dict:
    """Zero float32 residuals keyed like ``params`` (a module or a dict)."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in named(params).items()}


def apply_error_feedback(grads: dict, residual: dict) -> dict:
    """Add last step's quantization error before compressing this step."""
    return {k: g.float() + residual[k] for k, g in grads.items()}

"""Gradient compression: per-tensor int8 with error feedback (reference:
``src/repro/optim/compress.py``).

``quantize_int8`` / ``dequantize_int8`` and the error-feedback helpers are
the reference's expressions; stochastic rounding draws its uniforms from a
``torch.Generator`` (the reference's from a ``jax.random`` key: the same
distribution, other numbers).  ``compressed_psum`` reduces over a mesh's
pod axis, which needs the distrib slice's mesh: it raises.
"""

from __future__ import annotations

import torch

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
    scale = torch.max(torch.abs(x)).float() / 127.0 + 1e-30
    y = x.float() / scale
    if generator is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=generator, device=y.device))
    else:
        y = torch.round(y)
    return torch.clamp(y, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x, axis: str, axis_size: int, generator=None):
    """The int8 ring reduce over a mesh axis: needs a mesh."""
    raise NotImplementedError(
        "compressed_psum reduces over a mesh's pod axis: it comes with the distrib slice "
        "(ROADMAP.md section 1, item 6)"
    )


def init_error_feedback(params) -> dict:
    """Zero float32 residuals keyed like ``params`` (a module or a dict)."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in named(params).items()}


def apply_error_feedback(grads: dict, residual: dict) -> dict:
    """Add last step's quantization error before compressing this step."""
    return {k: g.float() + residual[k] for k, g in grads.items()}

"""Serving steps (reference: ``src/repro/train/step.py``).

``make_prefill_step`` and ``make_decode_step`` only, for every ported
family (dense, MoE, ssm, hybrid); the training steps come with the training
slice (ROADMAP.md).  PyTorch runs eagerly, so these
return plain functions where the reference returns functions to ``jit``.
"""

from __future__ import annotations

import torch

from ..models import lm
from ..models.config import ModelConfig

__all__ = ["make_decode_step", "make_prefill_step"]


def make_prefill_step(cfg: ModelConfig):
    """Prefill without a cache: the full prompt's last-position logits."""

    def prefill_step(params, tokens):
        logits, _ = lm.forward(params, cfg, tokens)
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """One new token against a preallocated KV/SSM cache (written in
    place): ``(params, cache, tokens (b, 1)) -> (next token (b,), cache)``,
    the next token the greedy argmax of the last logits."""

    def decode_step(params, cache, tokens):
        logits, cache = lm.forward(params, cfg, tokens, cache=cache)
        return torch.argmax(logits[:, -1, :], dim=-1), cache

    return decode_step

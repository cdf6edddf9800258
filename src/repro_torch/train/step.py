"""Training and serving steps (reference: ``src/repro/train/step.py``).

``make_train_step(cfg, opt)``         (params, opt_state, batch)         -> (params, opt_state, metrics)
``make_prefill_step(cfg)``            (params, tokens)                   -> last-position logits
``make_decode_step(cfg)``             (params, cache, tokens)            -> (next token, cache)
``make_encdec_train_step(cfg, opt)``  (params, opt_state, batch)         -> (params, opt_state, metrics)
``make_encdec_prefill_step(cfg)``     (params, frames, tokens)           -> last-position logits
``make_encdec_decode_step(cfg)``      (params, cache, enc_out, tokens)   -> (next token, cache)

PyTorch runs eagerly, so these return plain functions where the reference
returns functions to ``jit``.  A train step is its loss (``lm.loss_fn``, or
``encdec.encdec_loss_fn`` on a batch's ``frames``, ``tokens`` and
``targets``; remat as the model says, K3 / K4 / K5 through their autograd
Functions), ``backward`` and ``adamw_update``: it turns on
``requires_grad`` for its model's parameters while it runs, updates them
and the optimizer state in place, and frees each ``.grad`` after the
update, so serving the same module builds no graph.  A parameter that gets
no gradient is an error, not a zero.

The compressed step reduces over a mesh's pod axis (the distrib slice): it
raises ``NotImplementedError`` (ROADMAP.md section 1).
"""

from __future__ import annotations

import torch

from ..models import encdec, lm
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_update, named

__all__ = [
    "make_compressed_train_step",
    "make_decode_step",
    "make_encdec_decode_step",
    "make_encdec_prefill_step",
    "make_encdec_train_step",
    "make_prefill_step",
    "make_train_step",
]


def _train_step(opt: AdamWConfig, loss_of):
    """One AdamW step on ``loss_of(params, batch)``: metrics ``loss``,
    ``grad_norm`` and ``lr`` are device scalars (nothing is read back)."""

    def train_step(params, opt_state, batch):
        ps = named(params)
        for p in ps.values():
            p.requires_grad_(True)
        try:
            loss = loss_of(params, batch)
            loss.backward()
            grads = {k: p.grad for k, p in ps.items()}
            missing = [k for k, g in grads.items() if g is None]
            if missing:
                raise RuntimeError(f"no gradient reached {missing}")
            params, opt_state, metrics = adamw_update(opt, grads, params, opt_state)
        finally:
            for p in ps.values():
                p.grad = None
                p.requires_grad_(False)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_train_step(cfg: ModelConfig, opt: AdamWConfig):
    """One AdamW step on ``lm.loss_fn`` of ``batch["tokens"]`` and
    ``batch["targets"]``."""
    return _train_step(opt, lambda params, b: lm.loss_fn(params, cfg, b["tokens"], b["targets"]))


def make_compressed_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh):
    """The int8 pod-axis reduction needs a mesh: it comes with distrib."""
    raise NotImplementedError(
        "make_compressed_train_step (an int8 reduction over a mesh's pod axis) comes with the distrib slice "
        "(ROADMAP.md section 1)"
    )


def make_encdec_train_step(cfg: ModelConfig, opt: AdamWConfig):
    """One AdamW step on ``encdec.encdec_loss_fn`` of ``batch["frames"]``,
    ``batch["tokens"]`` and ``batch["targets"]``."""
    return _train_step(opt, lambda params, b: encdec.encdec_loss_fn(params, cfg, b["frames"], b["tokens"],
                                                                    b["targets"]))


def make_encdec_prefill_step(cfg: ModelConfig):
    """Encode the frames, then decode the prompt without a cache: the last
    position's logits."""

    def prefill_step(params, frames, tokens):
        enc = encdec.encode(params, cfg, frames)
        logits, _ = encdec.decode(params, cfg, tokens, enc)
        return logits[:, -1, :]

    return prefill_step


def make_encdec_decode_step(cfg: ModelConfig):
    """One new token against the decoder's cache (written in place) and the
    encoder's output: ``(params, cache, enc_out, tokens (b, 1)) -> (next
    token (b,), cache)``, the greedy argmax of the last logits."""

    def decode_step(params, cache, enc_out, tokens):
        logits, cache = encdec.decode(params, cfg, tokens, enc_out, cache=cache)
        return torch.argmax(logits[:, -1, :], dim=-1), cache

    return decode_step


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

"""Training and serving steps (reference: ``src/repro/train/step.py``).

``make_train_step(cfg, opt)``  (params, opt_state, batch) -> (params, opt_state, metrics)
``make_prefill_step(cfg)``     (params, tokens)           -> last-position logits
``make_decode_step(cfg)``      (params, cache, tokens)    -> (next token, cache)

PyTorch runs eagerly, so these return plain functions where the reference
returns functions to ``jit``.  The train step is ``loss_fn`` (remat as the
config says, K3 / K4 / K5 through their autograd Functions), ``backward``
and ``adamw_update``: it turns on ``requires_grad`` for its model's
parameters while it runs, updates them and the optimizer state in place,
and frees each ``.grad`` after the update, so serving the same module builds
no graph.  A parameter that gets no gradient is an error, not a zero.

The compressed step reduces over a mesh's pod axis (the distrib slice), and
the enc-dec steps need ``models/encdec.py`` (the enc-dec slice): each raises
``NotImplementedError`` (ROADMAP.md section 1, item 6).
"""

from __future__ import annotations

import torch

from ..models import lm
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


def make_train_step(cfg: ModelConfig, opt: AdamWConfig):
    """One AdamW step on ``lm.loss_fn``: metrics ``loss``, ``grad_norm`` and
    ``lr`` are device scalars (nothing is read back)."""

    def train_step(params, opt_state, batch):
        ps = named(params)
        for p in ps.values():
            p.requires_grad_(True)
        try:
            loss = lm.loss_fn(params, cfg, batch["tokens"], batch["targets"])
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


def _later(what: str, slice_: str):
    raise NotImplementedError(f"{what} comes with {slice_} (ROADMAP.md section 1, item 6)")


def make_compressed_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh):
    """The int8 pod-axis reduction needs a mesh: it comes with distrib."""
    _later("make_compressed_train_step (an int8 reduction over a mesh's pod axis)", "the distrib slice")


def make_encdec_train_step(cfg: ModelConfig, opt: AdamWConfig):
    _later("make_encdec_train_step", "the enc-dec slice (models/encdec.py)")


def make_encdec_prefill_step(cfg: ModelConfig):
    _later("make_encdec_prefill_step", "the enc-dec slice (models/encdec.py)")


def make_encdec_decode_step(cfg: ModelConfig):
    _later("make_encdec_decode_step", "the enc-dec slice (models/encdec.py)")


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

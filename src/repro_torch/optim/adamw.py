"""AdamW with decoupled weight decay, global-norm clipping and a
linear-warmup cosine schedule (reference: ``src/repro/optim/adamw.py``).

Written expression for expression as the reference writes it, over float32
tensors: the clip scale ``min(1, clip / (norm + 1e-9))``, bias corrections
``1 - b ** step`` in float32, ``p - lr * (upd + wd * p)``.  It is not
``torch.optim.AdamW``, whose decay (``p *= 1 - lr * wd`` before the step)
and ``eps`` placement round differently.

Parameters are an ``nn.Module`` or a dict of tensors keyed by name; the
state is ``{"m", "v"}`` (float32 dicts keyed like the parameters) and
``"step"`` (an int32 scalar on the parameters' device).  Where the
reference returns new pytrees, ``adamw_update`` writes the new parameters,
``m`` and ``v`` into the given tensors, one leaf at a time, so that a step
holds one leaf's temporaries beside the parameters, gradients and moments
(for Zamba2-1.2B those are 18.7 GB in float32); it returns the same objects.
Nothing here reads a value back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "named"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def named(params) -> dict[str, torch.Tensor]:
    """The parameters by name: a module's ``named_parameters``, or the dict."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def adamw_init(params) -> dict:
    """Zero float32 moments keyed like ``params`` and step 0."""
    p = named(params)
    dev = next(iter(p.values())).device

    def zeros():
        return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in p.items()}

    return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, params, state: dict) -> tuple:
    """One AdamW step: (params, state, metrics {"grad_norm", "lr"}), the
    parameters and moments updated in place (module docstring)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = _schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(g, p, m, v):
        g = g.float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p_new = p.float() - lr * (u + cfg.weight_decay * p.float())
        return p_new.to(p.dtype), m_new, v_new

    for name, p in named(params).items():
        p_new, m_new, v_new = upd(grads[name], p, state["m"][name], state["v"][name])
        p.copy_(p_new)
        state["m"][name].copy_(m_new)
        state["v"][name].copy_(v_new)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

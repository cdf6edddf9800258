"""Slot-based decode engine with per-slot cache positions (reference:
``src/repro/serve/engine.py``).

A decode slot is the request-level "generalized compute unit" of the
paper's block-wise dataflow: when a request finishes, its slot refills from
the queue at once instead of waiting for the whole batch.  Per-slot state
means per-sample cache lengths: each step writes slot b's new k and v at
``lens[b]`` and masks its attention at ``lens[b]``.  That attention is plain
torch here, as the reference computes it outside any Pallas kernel; the
MLP is the model's ``mlp_fwd``, so a ``sq_relu`` config's down-projection
is K3.  ``prefill_slot`` feeds a prompt one decode step at a time, as the
reference does, so K4 is not on this path.

The engine covers dense GQA configs only, as the reference asserts.  The
state's caches are written in place (the reference returns new arrays); a
write at a length past the cache's end is dropped, as JAX's scatter drops
an index out of bounds.
"""

from __future__ import annotations

import math

import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.layers import apply_rope, mlp_fwd, rmsnorm

__all__ = ["init_slot_state", "prefill_slot", "reset_slots", "slot_decode_step"]


def init_slot_state(cfg: ModelConfig, n_slots: int, max_seq: int, dtype=None,
                    device: str | torch.device = "cuda") -> dict:
    """Stacked per-layer k and v (L, n_slots, max_seq, nkv, hd) on
    ``device`` (the card by default) and per-slot lengths ``lens``
    (n_slots,) int32."""
    if cfg.family != "dense" or cfg.attn.kind != "gqa":
        raise ValueError(
            f"the slot engine covers dense GQA configs, not {cfg.name} "
            f"({cfg.family}, {cfg.attn.kind}); other families use launch.serve"
        )
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    _, nkv, hd = cfg.attn_dims()
    shape = (cfg.n_layers, n_slots, max_seq, nkv, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "lens": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
    }


def _slot_attn(p, cfg: ModelConfig, x, k_cache, v_cache, lens):
    """One token per slot against per-slot cache lengths.  x (b, d); k_cache
    and v_cache (b, S, nkv, hd), written at ``lens`` in place; lens (b,),
    the lengths before the write.  Returns out (b, d)."""
    a = cfg.attn
    nh, nkv, hd = cfg.attn_dims()
    b, _ = x.shape
    dt = x.dtype
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if a.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    pos = lens[:, None]  # (b, 1): each slot at its own position
    q = apply_rope(q.reshape(b, 1, nh, hd), pos, a.rope_theta, a.mrope_sections)
    k = apply_rope(k.reshape(b, 1, nkv, hd), pos, a.rope_theta, a.mrope_sections)
    v = v.reshape(b, 1, nkv, hd)
    # per-slot scatter at lens[b]; a slot already at the end writes nothing
    S = k_cache.shape[1]
    bi = torch.arange(b, device=x.device)
    at = lens.long().clamp(max=S - 1)
    inside = (lens < S)[:, None, None]
    k_cache[bi, at] = torch.where(inside, k[:, 0], k_cache[bi, at])
    v_cache[bi, at] = torch.where(inside, v[:, 0], v_cache[bi, at])
    # per-sample masked attention over the whole cache
    qg = q.reshape(b, nkv, nh // nkv, hd)
    scores = torch.einsum("bkrh,bskh->bkrs", qg, k_cache) / math.sqrt(hd)
    valid = torch.arange(S, device=x.device)[None, :] <= lens[:, None]  # (b, S)
    scores = scores.masked_fill(~valid[:, None, None, :], torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(dt)
    out = torch.einsum("bkrs,bskh->bkrh", probs, v_cache)
    return out.reshape(b, nh * hd) @ p.wo.to(dt)


def slot_decode_step(params, cfg: ModelConfig, state: dict, tokens):
    """tokens (b,) -> (logits (b, vocab), state): each slot advances by one
    at its own position.  ``params`` is a dense ``models.lm.LM``."""
    if params.cfg != cfg:
        raise ValueError(f"params were built for {params.cfg.name}, not {cfg.name}")
    eps = cfg.norm_eps
    x = params.embed[tokens].to(getattr(torch, cfg.dtype))  # (b, d)
    lens = state["lens"]
    for i, blk in enumerate(params.layers):
        h = _slot_attn(blk.attn, cfg, rmsnorm(x, blk.attn_norm.scale, eps), state["k"][i],
                       state["v"][i], lens)
        x = x + h
        x = x + mlp_fwd(blk.mlp, rmsnorm(x, blk.mlp_norm.scale, eps), cfg.activation)
    x = rmsnorm(x, params.final_norm.scale, eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head.to(x.dtype)
    return logits, {"k": state["k"], "v": state["v"], "lens": lens + 1}


def reset_slots(state: dict, slot_mask) -> dict:
    """Zero the lengths of refilled slots (slot_mask (b,) bool, True = the
    slot goes to a new request).  Stale k and v past ``lens`` are masked by
    the per-sample valid mask, so the buffers are not cleared."""
    lens = torch.where(slot_mask, torch.zeros_like(state["lens"]), state["lens"])
    return dict(state, lens=lens)


def prefill_slot(params, cfg: ModelConfig, state: dict, tokens, slot_mask):
    """Feed prompt tokens (b, P) one decode step at a time.  Slots where
    ``slot_mask`` is False get their lengths back afterwards (their cache
    rows past those lengths were written, as in the reference)."""
    keep_lens = state["lens"]
    last_logits = None
    for t in range(tokens.shape[1]):
        last_logits, state = slot_decode_step(params, cfg, state, tokens[:, t])
    lens = torch.where(slot_mask, state["lens"], keep_lens)
    return last_logits, dict(state, lens=lens)

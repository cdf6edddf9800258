"""Encoder-decoder (Whisper-style) backbone.

Map to the reference (``src/repro/models/encdec.py``):

  ``_init_enc_layer`` / ``encode``'s ``body``  -> ``EncLayer``
  ``_init_cross`` / ``_cross_fwd``             -> ``CrossAttention`` / ``cross_fwd``
  ``_enc_kv``                                  -> ``enc_kv``
  ``_init_dec_layer`` / ``decode``'s ``body``  -> ``DecLayer``
  ``init_encdec_params``  -> ``init_encdec_params(cfg, generator=, device=)``:
                             an ``EncDec`` module (``enc_layers``,
                             ``enc_norm``, ``embed``, ``dec_layers``,
                             ``final_norm``, ``lm_head``), so that its
                             ``state_dict`` keys are the reference's tree with
                             the stacked layers as ``enc_layers.<i>`` and
                             ``dec_layers.<i>``
  ``encode``, ``decode``, ``encdec_loss_fn``  -> the same names
  ``init_decoder_cache``  -> ``init_decoder_cache(cfg, batch, max_seq, device=)``

The conv / mel frontend is a stub, as in the reference: ``encode`` takes
precomputed frame embeddings (b, encoder_seq, d_model), cast to
``cfg.dtype`` before the first layer.  Parameters are float32 and are cast
to the activations' type at each product, as in ``models.layers``.

Attention, by where it runs:

  * the encoder's self-attention is ``layers.gqa_fwd`` under a copy of the
    config with ``causal=False`` (the reference's ``noncausal``): RoPE at
    positions 0..s-1, then K4 non-causal over the whole frame sequence;
  * the decoder's self-attention is ``layers.gqa_fwd`` as the LM runs it:
    K4 causal over a whole prompt from cache position 0, ``_sdpa`` in plain
    torch over the cache on later steps;
  * cross-attention is K4 non-causal with the scores rounded to the
    activations' type (``round_scores``) everywhere it runs, at any query
    length (a prompt, a training sequence, one decode token) against the
    encoder's keys: it has no RoPE, no mask, no ``q_offset`` and no
    ``kv_len``, so it is the reference's unmasked ``_sdpa_block`` exactly.
    It calls K4 through ``layers.attention_op`` (a ``shard_map`` over heads
    for DTensors under a mesh), which calls ``layers.flash_attention_op``,
    the models' one K4 entry point, so that what swaps or counts that entry
    sees every attention.  As in the reference, each decoder layer recomputes the
    encoder's K and V from ``enc_out`` on every call, decode steps
    included: there is no cross-K/V cache.

K4 launches: ``encode`` one per encoder layer; ``decode`` over a prompt
without a cache or into an empty one two per decoder layer (self and
cross); a decode step onto a non-empty cache one per decoder layer (cross
only).

The cache is the dense LM's: ``{"layers": {"k", "v" (L, b, max_seq, nkv,
hd), "len"}}``, written in place, with one host-int ``len`` where the
reference stacks one per layer.

Remat runs only with gradients on, a parameter requiring one and no cache
(so serving never checkpoints): each encoder layer and each decoder layer
is checkpointed alone with ``lm._remat(..., policy=False)``, the
reference's plain ``jax.checkpoint`` of ``body``, for any ``cfg.remat``
other than ``"none"``.  A recomputation runs through its layer (the MLP's
down-projection, which the backward saves, comes last), so under remat a
train step launches K4 twice per attention: 2 per encoder layer and 4 per
decoder layer.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import resolve_device
from . import layers
from .config import ModelConfig
from .layers import MLP, GQAttention, RMSNorm, _dense, gold_logits, gqa_fwd, init_gqa_cache, settle
from .lm import _dtype, _remat, _remat_on, _stacked_attn_cache

__all__ = [
    "CrossAttention",
    "DecLayer",
    "EncDec",
    "EncLayer",
    "cross_fwd",
    "decode",
    "enc_kv",
    "encdec_loss_fn",
    "encode",
    "init_decoder_cache",
    "init_encdec_params",
]


def _check(cfg: ModelConfig):
    if cfg.family != "encdec":
        raise ValueError(f"models.encdec builds the encdec family, not {cfg.family!r} ({cfg.name})")


class CrossAttention(nn.Module):
    """Cross-attention's projections (reference: ``_init_cross``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        nh, nkv, hd = cfg.attn_dims()
        d = cfg.d_model
        self.wq = _dense((d, nh * hd), generator, device)
        self.wk = _dense((d, nkv * hd), generator, device)
        self.wv = _dense((d, nkv * hd), generator, device)
        self.wo = _dense((nh * hd, d), generator, device)


def enc_kv(p: CrossAttention, cfg: ModelConfig, enc_out: torch.Tensor):
    """The encoder's keys and values for one decoder layer, (b, s_enc, nkv,
    hd) each (reference: ``_enc_kv``)."""
    _, nkv, hd = cfg.attn_dims()
    b, s, _ = enc_out.shape
    dt = enc_out.dtype
    k = layers.as_heads(enc_out @ p.wk.to(dt), b, s, nkv, hd)
    v = layers.as_heads(enc_out @ p.wv.to(dt), b, s, nkv, hd)
    return k, v


def cross_fwd(p: CrossAttention, cfg: ModelConfig, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Cross-attention of x (b, s, d) against the encoder's k and v: K4,
    non-causal, scores rounded to x's type (reference: ``_cross_fwd``)."""
    nh, _, hd = cfg.attn_dims()
    b, s, _ = x.shape
    dt = x.dtype
    q = layers.as_heads(x @ p.wq.to(dt), b, s, nh, hd)
    out = layers.attention_op(q, k, v, False)
    return out.reshape(b, s, nh * hd) @ p.wo.to(dt)


class EncLayer(nn.Module):
    """Pre-norm bidirectional self-attention + MLP (reference:
    ``_init_enc_layer`` and ``encode``'s ``body``)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.noncausal = cfg.with_(attn=dataclasses.replace(cfg.attn, causal=False))
        self.attn_norm = RMSNorm(cfg.d_model, device=device)
        self.attn = GQAttention(cfg, generator, device)
        self.mlp_norm = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, generator, device)

    def forward(self, x, positions):
        eps = self.cfg.norm_eps
        h, _ = gqa_fwd(self.attn, self.noncausal, self.attn_norm(x, eps), positions)
        x = x + settle(h)
        return x + settle(self.mlp(self.mlp_norm(x, eps)))


class DecLayer(nn.Module):
    """Pre-norm causal self-attention, cross-attention and MLP (reference:
    ``_init_dec_layer`` and ``decode``'s ``body``)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = RMSNorm(cfg.d_model, device=device)
        self.attn = GQAttention(cfg, generator, device)
        self.cross_norm = RMSNorm(cfg.d_model, device=device)
        self.cross = CrossAttention(cfg, generator, device)
        self.mlp_norm = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, generator, device)

    def forward(self, x, positions, enc_out, cache=None):
        cfg = self.cfg
        eps = cfg.norm_eps
        h, new_cache = gqa_fwd(self.attn, cfg, self.attn_norm(x, eps), positions, cache)
        x = x + settle(h)
        k, v = enc_kv(self.cross, cfg, enc_out)
        x = x + settle(cross_fwd(self.cross, cfg, self.cross_norm(x, eps), k, v))
        x = x + settle(self.mlp(self.mlp_norm(x, eps)))
        return x, new_cache


class EncDec(nn.Module):
    """The enc-dec model of one ``encdec`` ``ModelConfig``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        _check(cfg)
        self.cfg = cfg
        self.enc_layers = nn.ModuleList(EncLayer(cfg, generator, device) for _ in range(cfg.n_encoder_layers))
        self.enc_norm = RMSNorm(cfg.d_model, device=device)
        self.embed = _dense((cfg.vocab, cfg.d_model), generator, device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, generator, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        self.lm_head = _dense((cfg.d_model, cfg.vocab), generator, device)

    def encode(self, frames):
        """frames (b, s, d_model) -> the normed encoder output in ``cfg.dtype``."""
        cfg = self.cfg
        x = frames.to(_dtype(cfg))
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        remat = _remat_on(self)
        for layer in self.enc_layers:
            x = _remat(lambda xx, f=layer: f(xx, positions), cfg, policy=False)(x) if remat else layer(x, positions)
        return self.enc_norm(x, cfg.norm_eps)

    def decode(self, tokens, enc_out, cache: dict | None = None):
        """(logits (b, s, vocab) in ``cfg.dtype``, cache); with a cache its
        k and v are written in place and its ``len`` advanced."""
        cfg = self.cfg
        x = layers.embed_lookup(self.embed, tokens).to(_dtype(cfg))
        b, s, _ = x.shape
        base = cache["layers"]["len"] if cache is not None else 0
        positions = (base + torch.arange(s, device=x.device))[None, :].expand(b, s)
        if cache is None and _remat_on(self):
            for layer in self.dec_layers:
                x = _remat(lambda xx, enc, f=layer: f(xx, positions, enc)[0], cfg, policy=False)(x, enc_out)
        else:
            new_len = None
            for i, layer in enumerate(self.dec_layers):
                c_l = None
                if cache is not None:
                    c_l = {k: v if k == "len" else v[i] for k, v in cache["layers"].items()}
                x, c_new = layer(x, positions, enc_out, c_l)
                if c_new is not None:
                    new_len = c_new["len"]
            if new_len is not None:
                cache["layers"]["len"] = new_len
        x = self.final_norm(x, cfg.norm_eps)
        return x @ self.lm_head.to(x.dtype), cache


def _same_cfg(params: EncDec, cfg: ModelConfig):
    if params.cfg != cfg:
        raise ValueError(f"params were built for {params.cfg.name}, not {cfg.name}")


def init_encdec_params(
    cfg: ModelConfig,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> EncDec:
    """An ``EncDec`` with random float32 parameters on ``device`` (the card
    by default; it raises without one), drawn with the reference's
    distributions.  ``generator`` must live on ``device``; by default one
    seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return EncDec(cfg, generator, dev)


def encode(params: EncDec, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (b, enc_seq, d_model) precomputed frontend embeddings."""
    _same_cfg(params, cfg)
    return params.encode(frames)


def decode(params: EncDec, cfg: ModelConfig, tokens, enc_out, cache: dict | None = None):
    """tokens (b, s), enc_out (b, enc_seq, d) -> (logits (b, s, vocab),
    cache)."""
    _same_cfg(params, cfg)
    return params.decode(tokens, enc_out, cache)


def init_decoder_cache(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    dtype: torch.dtype | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """The decoder's self-attention cache on ``device`` (the card by
    default): ``{"layers": {"k", "v" stacked over the decoder layers, "len":
    0}}``."""
    dev = resolve_device(device)
    _check(cfg)
    one = init_gqa_cache(cfg, batch, max_seq, dtype or _dtype(cfg), "meta")
    return {"layers": _stacked_attn_cache(one, cfg.n_layers, dev)}


def encdec_loss_fn(params: EncDec, cfg: ModelConfig, frames, tokens, targets) -> torch.Tensor:
    """Cross-entropy of the decoder's float32 logits, a plain mean (no
    z-loss, as the reference's ``encdec_loss_fn``); the gold logit is a
    gather."""
    enc_out = encode(params, cfg, frames)
    logits, _ = decode(params, cfg, tokens, enc_out)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = gold_logits(logits, targets)
    return (lse - gold).sum() / lse.numel()

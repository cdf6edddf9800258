"""Transformer layers of the serving path: norms, RoPE / M-RoPE, GQA
attention and the MLP.

Map to the reference (``src/repro/models/layers.py``):

  ``init_rmsnorm`` / ``rmsnorm``   -> ``RMSNorm`` / ``rmsnorm``
  ``rope_freqs``, ``apply_rope``   -> the same names (M-RoPE included)
  ``_dense``                       -> ``_dense`` (normal / sqrt(fan_in), from a
                                      ``torch.Generator``)
  ``init_gqa`` / ``gqa_fwd``       -> ``GQAttention`` / ``gqa_fwd``
  ``_sdpa_block``, ``_sdpa``       -> the same names (plain torch)
  ``init_gqa_cache``               -> ``init_gqa_cache``
  ``init_mlp`` / ``mlp_fwd``       -> ``MLP`` / ``mlp_fwd``

Parameters are float32 and are cast to the activations' type at each
product, as the reference's ``.astype(x.dtype)`` casts them; ``rmsnorm``
works in float32.  The parameters of this serving slice do not require
gradients.

Attention over a whole prompt from position 0 (no cache, or a cache of
length 0) is K4 (``kernels.ops.flash_attention_op``), which takes the
grouped kv heads as they are: it is the reference's ``_sdpa`` there,
causal or not, with the scores rounded to the activations' type before the
float32 scale as the reference rounds them (``round_scores``); only the
probabilities stay unnormalised when they are rounded for the product with
v, as in any flash attention.  Decode and prefill onto a non-empty cache run
``_sdpa`` in plain torch, as the reference computes them outside any Pallas
kernel.  The cache's ``len`` is a host int, so this choice reads nothing
back from the card, and the cache is written in place.  A write past the
cache's end starts at ``max_seq - s`` instead, as the reference's
``dynamic_update_slice_in_dim`` clamps its start index, and attends with
``q_offset = len`` and ``kv_len = len + s`` as the reference does.

The ``sq_relu`` MLP's down-projection is K3 (``kernels.ops.zskip_matmul_op``)
on the (b*s, d_ff) view, in prefill and decode alike: squared-ReLU
activations are the zero-skip kernel's input.  The other activations'
products stay ``torch.matmul``, as the reference computes them outside any
Pallas kernel.

The mesh-only paths (``_constrain_heads``, ``_decode_attn_seq_sharded``) are
identities on one device and are not ported; MLA and MoE come with their
slice (ROADMAP.md).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ops import flash_attention_op, zskip_matmul_op
from .config import ModelConfig

__all__ = [
    "MLP",
    "GQAttention",
    "RMSNorm",
    "apply_rope",
    "gqa_fwd",
    "init_gqa_cache",
    "mlp_fwd",
    "rmsnorm",
    "rope_freqs",
]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _dense(shape, generator: torch.Generator | None, device, scale: float = 1.0) -> nn.Parameter:
    """A float32 weight, Normal(0, 1) / sqrt(fan_in) * scale with fan_in the
    first axis; zeros with no generator (a shell that
    ``convert.lm_params_from_numpy`` fills)."""
    if generator is None:
        return _param(torch.zeros(shape, dtype=torch.float32, device=device))
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return _param(w.mul_(scale / math.sqrt(shape[0])))  # in place: no second copy


# --------------------------------------------------------------------- norms


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _param(torch.ones(d, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rmsnorm(x, self.scale, eps)


# ---------------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.cache
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as float32 on ``device``, made once per device: a copy
    from the host at every call would synchronise the card's stream.  Made
    outside inference mode, so that autograd may use it later."""
    with torch.inference_mode(False):
        return torch.tensor(rope_freqs(head_dim, theta), dtype=torch.float32, device=device)


def apply_rope(
    x: torch.Tensor,  # (b, s, h, hd)
    positions: torch.Tensor,  # (b, s) or (sections, b, s) for M-RoPE
    theta: float,
    mrope_sections: tuple[int, ...] = (),
) -> torch.Tensor:
    """Rotary embedding; with ``mrope_sections`` the frequency bands are
    split across (t, h, w) position streams (Qwen2-VL M-RoPE)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    pos = positions.to(torch.float32)
    if mrope_sections:
        if sum(mrope_sections) != hd // 2:
            raise ValueError(f"mrope_sections {mrope_sections} must sum to {hd // 2}")
        if pos.dim() == 2:  # text only: all streams share the positions
            pos = pos.expand(len(mrope_sections), *pos.shape)
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(pos[i][..., None] * freqs[start : start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)  # (b, s, hd/2)
    else:
        ang = pos[..., None] * freqs  # (b, s, hd/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ----------------------------------------------------------------- attention

_Q_CHUNK = 1024


def _sdpa_block(q, k, v, causal: bool, q_offset: int, kv_len: int | None):
    """One dense attention block: q . k in q's type (one rounding), scaled
    in float32 as the reference's division by the float64 ``np.sqrt(hd)``
    promotes it, masked with float32's finfo.min, softmax in float32,
    probabilities cast back to q's type before the product with v."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    qg = q.reshape(b, sq, kv, rep, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k).float() / math.sqrt(hd)
    sk = k.shape[1]
    mask = None
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
    if kv_len is not None:
        valid = torch.arange(sk, device=q.device)[None, :] < kv_len
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def _sdpa(q, k, v, causal: bool, q_offset: int = 0, kv_len: int | None = None, q_chunk: int = _Q_CHUNK):
    """Grouped attention in plain torch; long query runs go in q chunks so
    the live score tensor is (b, h, q_chunk, sk)."""
    b, sq, h, hd = q.shape
    if sq <= 2 * q_chunk or sq % q_chunk != 0:
        return _sdpa_block(q, k, v, causal, q_offset, kv_len)
    outs = [
        _sdpa_block(q[:, i : i + q_chunk], k, v, causal, q_offset + i, kv_len)
        for i in range(0, sq, q_chunk)
    ]
    return torch.cat(outs, dim=1)


class GQAttention(nn.Module):
    """Grouped-query attention with RoPE (reference: ``init_gqa``,
    ``gqa_fwd``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        nh, nkv, hd = cfg.attn_dims()
        d = cfg.d_model
        self.cfg = cfg
        self.wq = _dense((d, nh * hd), generator, device)
        self.wk = _dense((d, nkv * hd), generator, device)
        self.wv = _dense((d, nkv * hd), generator, device)
        self.wo = _dense((nh * hd, d), generator, device)
        if cfg.attn.qkv_bias:
            for name, width in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
                setattr(self, name, _param(torch.zeros(width, dtype=torch.float32, device=device)))

    def forward(self, x, positions, cache: dict | None = None):
        return gqa_fwd(self, self.cfg, x, positions, cache)


def gqa_fwd(p: GQAttention, cfg: ModelConfig, x, positions, cache: dict | None = None):
    """GQA attention.  With ``cache`` ({'k': (b, max_s, kv, hd), 'v': ...,
    'len': int}) it appends the s new tokens in place and returns the cache
    dict with ``len`` advanced."""
    a = cfg.attn
    nh, nkv, hd = cfg.attn_dims()
    b, s, _ = x.shape
    dt = x.dtype
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if a.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    q = apply_rope(q, positions, a.rope_theta, a.mrope_sections)
    k = apply_rope(k, positions, a.rope_theta, a.mrope_sections)
    if cache is None:
        out = flash_attention_op(q, k, v, causal=a.causal, round_scores=True)
        new_cache = None
    else:
        start = int(cache["len"])
        max_s = cache["k"].shape[1]
        if s > max_s:
            raise ValueError(f"cache holds {max_s} positions, {s} new tokens asked for")
        # past the end the write starts at max_s - s, as the reference's
        # dynamic_update_slice_in_dim clamps its start index
        at = min(start, max_s - s)
        new_len = start + s
        cache["k"][:, at : at + s] = k
        cache["v"][:, at : at + s] = v
        if start == 0:
            # a whole prompt from position 0: the reference's masked _sdpa
            # over the cache is exactly attention over the s new tokens
            out = flash_attention_op(q, k, v, causal=a.causal, round_scores=True)
        else:
            # positions past new_len are masked in the reference; they add
            # exp(finfo.min - max) = 0 to the softmax, so they are cut here
            # (past the cache's end the slice is the whole cache, all valid)
            out = _sdpa(q, cache["k"][:, :new_len], cache["v"][:, :new_len], a.causal,
                        q_offset=start, kv_len=new_len)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": new_len}
    y = out.reshape(b, s, nh * hd) @ p.wo.to(dt)
    return y, new_cache


def init_gqa_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device) -> dict:
    _, nkv, hd = cfg.attn_dims()
    return {
        "k": torch.zeros((batch, max_seq, nkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, nkv, hd), dtype=dtype, device=device),
        "len": 0,
    }


# ----------------------------------------------------------------------- MLP


class MLP(nn.Module):
    """Reference: ``init_mlp`` / ``mlp_fwd``."""

    def __init__(self, d: int, ff: int, activation: str,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.activation = activation
        self.w_up = _dense((d, ff), generator, device)
        self.w_down = _dense((ff, d), generator, device)
        if activation.endswith("_glu"):
            self.w_gate = _dense((d, ff), generator, device)

    def forward(self, x):
        return mlp_fwd(self, x, self.activation)


def mlp_fwd(p: MLP, x: torch.Tensor, activation: str) -> torch.Tensor:
    """``jax.nn.gelu`` is the tanh approximation, so gelu here is too.
    ``sq_relu``'s down-projection is K3."""
    dt = x.dtype
    up = x @ p.w_up.to(dt)
    if activation == "silu_glu":
        h = F.silu(x @ p.w_gate.to(dt)) * up
    elif activation == "gelu_glu":
        h = F.gelu(x @ p.w_gate.to(dt), approximate="tanh") * up
    elif activation == "sq_relu":  # Nemotron-4: squared ReLU
        h = torch.square(F.relu(up))
        # K3 skips the all-zero tiles of the squared-ReLU activations
        y = zskip_matmul_op(h.reshape(-1, h.shape[-1]), p.w_down.to(dt))
        return y.reshape(*h.shape[:-1], y.shape[-1])
    elif activation == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ p.w_down.to(dt)

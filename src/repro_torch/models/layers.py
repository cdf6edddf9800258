"""Transformer layers of the serving path: norms, RoPE / M-RoPE, GQA and MLA
attention, the MLP and the capacity-bucketed MoE.

Map to the reference (``src/repro/models/layers.py``):

  ``init_rmsnorm`` / ``rmsnorm``   -> ``RMSNorm`` / ``rmsnorm``
  ``rope_freqs``, ``apply_rope``   -> the same names (M-RoPE included)
  ``_dense``                       -> ``_dense`` (normal / sqrt(fan_in), from a
                                      ``torch.Generator``)
  ``init_gqa`` / ``gqa_fwd``       -> ``GQAttention`` / ``gqa_fwd``
  ``_sdpa_block``, ``_sdpa``       -> the same names (plain torch)
  ``init_gqa_cache``               -> ``init_gqa_cache``
  ``init_mlp`` / ``mlp_fwd``       -> ``MLP`` / ``mlp_fwd``
  ``init_mla`` / ``mla_fwd``       -> ``MLAttention`` / ``mla_fwd``
  ``init_mla_cache``               -> ``init_mla_cache``
  ``init_moe`` / ``moe_fwd``       -> ``MoE`` / ``moe_fwd`` (local path)

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

MLA (``init_mla`` / ``mla_fwd`` -> ``MLAttention`` / ``mla_fwd``, and
``init_mla_cache``) runs ``_sdpa`` in plain torch everywhere, as the
reference's ``mla_fwd`` does: its q and k have head dim 192 and its v 128, a
shape K4 (one head dim for all three) does not take.  Its cache holds the
compressed ``ckv`` and the shared rope key, written in place as ``gqa_fwd``
writes k and v, and is cut to the new length before the up-projections.

The MoE (``init_moe`` / ``moe_fwd`` -> ``MoE`` / ``moe_fwd``, with
``expert_replication_table``, ``capture_routing``, ``_route_and_bucket``,
``_expert_ffn``, ``_combine`` and ``_moe_capacity``) is the reference's
local path, the one it takes without a mesh: top-k routing, round-robin
over each expert's replicas, capacity buckets with a dump row, batched
expert products (``torch.bmm``, as the reference's ``jnp.einsum`` runs
outside any Pallas kernel) and the gated combine.  Three orders are the
reference's, so that routing and sums agree bit for bit: top-k keeps equal
logits in ascending expert order (``jax.lax.top_k``'s), the bucket order is
a stable sort of the slots (``jnp.argsort``'s), and each token's k
contributions are summed one at a time in ascending slot order from zero in
the output type (the order XLA's scatter-add takes on the host), which also
keeps the card's result free of atomics and the same from run to run.

The mesh-only paths (``_constrain_heads``, ``_decode_attn_seq_sharded``, and
``moe_fwd``'s expert- and tensor-parallel ``shard_map`` paths) need a mesh
and are not ported; on one device the reference takes the paths ported
here.
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
    "ExpertBank",
    "MLP",
    "GQAttention",
    "MLAttention",
    "MoE",
    "RMSNorm",
    "apply_rope",
    "capture_routing",
    "expert_replication_table",
    "gqa_fwd",
    "init_gqa_cache",
    "init_mla_cache",
    "mla_fwd",
    "mlp_fwd",
    "moe_fwd",
    "rmsnorm",
    "rope_freqs",
]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _dense(shape, generator: torch.Generator | None, device, scale: float = 1.0,
           scale_axis: int = 0) -> nn.Parameter:
    """A float32 weight, Normal(0, 1) / sqrt(fan_in) * scale with fan_in
    ``shape[scale_axis]``; zeros with no generator (a shell that
    ``convert.lm_params_from_numpy`` fills)."""
    if generator is None:
        return _param(torch.zeros(shape, dtype=torch.float32, device=device))
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return _param(w.mul_(scale / math.sqrt(shape[scale_axis])))  # in place: no second copy


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


# ------------------------------------------------------------------ MLA (DSv2)


class MLAttention(nn.Module):
    """Multi-head latent attention (reference: ``init_mla``, ``mla_fwd``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        a = cfg.attn
        d = cfg.d_model
        nh = a.n_heads
        self.cfg = cfg
        self.wdq = _dense((d, a.q_lora_rank), generator, device)
        self.q_norm = RMSNorm(a.q_lora_rank, device=device)
        self.wuq = _dense((a.q_lora_rank, nh * (a.qk_nope_dim + a.qk_rope_dim)), generator, device)
        self.wdkv = _dense((d, a.kv_lora_rank), generator, device)
        self.kv_norm = RMSNorm(a.kv_lora_rank, device=device)
        self.wkr = _dense((d, a.qk_rope_dim), generator, device)
        self.wuk = _dense((a.kv_lora_rank, nh * a.qk_nope_dim), generator, device)
        self.wuv = _dense((a.kv_lora_rank, nh * a.v_head_dim), generator, device)
        self.wo = _dense((nh * a.v_head_dim, d), generator, device)

    def forward(self, x, positions, cache: dict | None = None):
        return mla_fwd(self, self.cfg, x, positions, cache)


def mla_fwd(p: MLAttention, cfg: ModelConfig, x, positions, cache: dict | None = None):
    """MLA.  With ``cache`` ({'ckv': (b, max_s, kv_lora), 'k_rope': (b,
    max_s, 1, rope), 'len': int}) it writes the s new compressed entries in
    place, up-projects the cache's first ``len + s`` and returns the cache
    dict with ``len`` advanced."""
    a = cfg.attn
    nh = a.n_heads
    b, s, _ = x.shape
    dt = x.dtype
    eps = cfg.norm_eps
    cq = p.q_norm(x @ p.wdq.to(dt), eps)
    q = (cq @ p.wuq.to(dt)).reshape(b, s, nh, a.qk_nope_dim + a.qk_rope_dim)
    q_nope, q_rope = q.split([a.qk_nope_dim, a.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, a.rope_theta)

    ckv = p.kv_norm(x @ p.wdkv.to(dt), eps)
    k_rope = apply_rope((x @ p.wkr.to(dt))[:, :, None, :], positions, a.rope_theta)  # shared by the heads

    if cache is None:
        new_cache, q_offset, kv_len = None, 0, None
    else:
        start = int(cache["len"])
        max_s = cache["ckv"].shape[1]
        if s > max_s:
            raise ValueError(f"cache holds {max_s} positions, {s} new tokens asked for")
        at = min(start, max_s - s)  # clamped as gqa_fwd clamps it
        new_len = start + s
        cache["ckv"][:, at : at + s] = ckv
        cache["k_rope"][:, at : at + s] = k_rope
        # positions past new_len are masked in the reference and add nothing
        ckv, k_rope = cache["ckv"][:, :new_len], cache["k_rope"][:, :new_len]
        new_cache = {"ckv": cache["ckv"], "k_rope": cache["k_rope"], "len": new_len}
        q_offset, kv_len = start, new_len

    sk = ckv.shape[1]
    k_nope = (ckv @ p.wuk.to(dt)).reshape(b, sk, nh, a.qk_nope_dim)
    v = (ckv @ p.wuv.to(dt)).reshape(b, sk, nh, a.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(b, sk, nh, a.qk_rope_dim)], dim=-1)
    out = _sdpa(torch.cat([q_nope, q_rope], dim=-1), k, v, a.causal, q_offset=q_offset, kv_len=kv_len)
    y = out.reshape(b, s, nh * a.v_head_dim) @ p.wo.to(dt)
    return y, new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device) -> dict:
    a = cfg.attn
    return {
        "ckv": torch.zeros((batch, max_seq, a.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_seq, 1, a.qk_rope_dim), dtype=dtype, device=device),
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


# ----------------------------------------------------------------------- MoE


def expert_replication_table(replication: tuple[int, ...]) -> np.ndarray:
    """Logical expert -> its slice of physical slots, (E, 2) int32 [start,
    count]: the slots hold sum(replication) banks, the replicas of one expert
    side by side."""
    starts = np.concatenate([[0], np.cumsum(replication)[:-1]])
    return np.stack([starts, np.asarray(replication)], axis=1).astype(np.int32)


@functools.cache
def _replication_table_on(replication: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``expert_replication_table`` as int64 on ``device``, made once per
    device, as ``_rope_freqs_on`` is and for the same reason."""
    with torch.inference_mode(False):
        return torch.tensor(expert_replication_table(replication), dtype=torch.int64, device=device)


def _replication(cfg: ModelConfig) -> tuple[int, ...]:
    m = cfg.moe
    return tuple(m.replication) or (1,) * m.n_experts


class ExpertBank(nn.Module):
    """The physical expert slots' weights, (n_phys, d, ff) and (n_phys, ff,
    d), each slot's fan-in its own (the reference's ``scale_axis=1``)."""

    def __init__(self, n_phys: int, d: int, ff: int, glu: bool,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.w_up = _dense((n_phys, d, ff), generator, device, scale_axis=1)
        self.w_down = _dense((n_phys, ff, d), generator, device, scale_axis=1)
        if glu:
            self.w_gate = _dense((n_phys, d, ff), generator, device, scale_axis=1)


class MoE(nn.Module):
    """Capacity-bucketed top-k MoE with expert replication (reference:
    ``init_moe`` / ``moe_fwd``): ``router`` (d, E), ``experts`` (an
    ``ExpertBank`` of sum(replication) slots) and, with shared experts,
    ``shared`` (an ``MLP`` of width n_shared * d_ff_expert)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        m = cfg.moe
        d = cfg.d_model
        self.cfg = cfg
        self.router = _dense((d, m.n_experts), generator, device)
        self.experts = ExpertBank(sum(_replication(cfg)), d, m.d_ff_expert,
                                  cfg.activation.endswith("_glu"), generator, device)
        if m.n_shared:
            self.shared = MLP(d, m.n_shared * m.d_ff_expert, cfg.activation, generator, device)

    def forward(self, x):
        return moe_fwd(self, self.cfg, x)


def _expert_ffn(bank: ExpertBank, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x: (E, C, d) -> (E, C, d), each slot's FFN as batched products."""
    dt = x.dtype
    up = torch.bmm(x, bank.w_up.to(dt))
    if activation.endswith("_glu"):
        gate = torch.bmm(x, bank.w_gate.to(dt))
        act = F.silu(gate) if activation == "silu_glu" else F.gelu(gate, approximate="tanh")
        h = act * up
    elif activation == "sq_relu":
        h = torch.square(F.relu(up))
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.bmm(h, bank.w_down.to(dt))


# The router-statistics capture (the paper's "profile the input
# distribution" step).  While a list is installed by ``capture_routing``,
# every ``moe_fwd`` call appends its top-k expert ids (numpy int32, (N, k))
# for the profile -> plan_replication -> redeploy flow.  The reference
# records its eager calls only; the port always runs eagerly.
_ROUTING_CAPTURE: list | None = None


class capture_routing:
    def __init__(self):
        self.records: list = []

    def __enter__(self):
        global _ROUTING_CAPTURE
        _ROUTING_CAPTURE = self.records
        return self.records

    def __exit__(self, *exc):
        global _ROUTING_CAPTURE
        _ROUTING_CAPTURE = None
        return False


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, equal values in
    ascending index order (``torch.topk`` leaves their order open)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_and_bucket(p: MoE, cfg: ModelConfig, xt: torch.Tensor, n_phys: int, capacity: int):
    """Top-k routing into capacity-bucketed slot buffers: (expert_in
    (n_phys, capacity, d), the combine's state (s_tok, s_gate, keep,
    buf_idx, n_tok)).  Assignments past a slot's capacity go to a dump row
    that is dropped."""
    m = cfg.moe
    n_tok, d = xt.shape
    dev = xt.device
    logits = (xt @ p.router.to(xt.dtype)).float()  # (N, E)
    gates, eids = _top_k(logits, m.top_k)  # (N, k)
    gates = torch.softmax(gates, dim=-1)
    if _ROUTING_CAPTURE is not None:
        _ROUTING_CAPTURE.append(eids.to(torch.int32).cpu().numpy())

    table = _replication_table_on(_replication(cfg), dev)
    starts, counts = table[:, 0][eids], table[:, 1][eids]
    # round-robin replica per (token, k): the paper's 'next available
    # duplicate' dispatch
    rr = torch.arange(n_tok, device=dev)[:, None] + torch.arange(m.top_k, device=dev)[None]
    slot = starts + torch.where(counts > 1, rr % counts, 0)  # (N, k)

    flat_slot = slot.reshape(-1)
    flat_tok = torch.arange(n_tok, device=dev).repeat_interleave(m.top_k)
    order = torch.argsort(flat_slot, stable=True)
    s_slot = flat_slot[order]
    s_tok = flat_tok[order]
    s_gate = gates.reshape(-1)[order]
    first = torch.searchsorted(s_slot, torch.arange(n_phys, device=dev), side="left")
    rank = torch.arange(s_slot.numel(), device=dev) - first[s_slot]
    keep = rank < capacity
    buf_idx = torch.where(keep, s_slot * capacity + rank, n_phys * capacity)

    # only the dump row receives repeated indices, and it is dropped
    buf = torch.zeros((n_phys * capacity + 1, d), dtype=xt.dtype, device=dev)
    buf[buf_idx] = xt[s_tok]
    expert_in = buf[:-1].reshape(n_phys, capacity, d)
    return expert_in, (s_tok, s_gate, keep, buf_idx, n_tok)


def _combine(expert_out: torch.Tensor, state, d: int) -> torch.Tensor:
    """Each token's gated contributions, summed one at a time in ascending
    slot order from zero in ``expert_out``'s type; dropped ones add 0."""
    s_tok, s_gate, keep, buf_idx, n_tok = state
    dt = expert_out.dtype
    n_slots = expert_out.shape[0] * expert_out.shape[1]
    flat_out = expert_out.reshape(n_slots, d)
    contrib = torch.where(keep[:, None], flat_out[buf_idx.clamp(max=n_slots - 1)], 0)
    contrib = contrib * s_gate[:, None].to(dt)
    # s_tok lists every token k times in slot order, so a stable sort of it
    # gives each token's entries in ascending slot order
    pos = torch.argsort(s_tok, stable=True).reshape(n_tok, -1)
    y = torch.zeros((n_tok, d), dtype=dt, device=expert_out.device)
    for j in range(pos.shape[1]):
        y = y + contrib[pos[:, j]]
    return y


def _moe_capacity(cfg: ModelConfig, n_tok: int, n_phys: int) -> int:
    c = int(np.ceil(n_tok * cfg.moe.top_k / n_phys * cfg.moe.capacity_factor))
    return max(c, 4)


def moe_fwd(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Capacity-bucketed top-k MoE with optional expert replication, the
    reference's local path (one device, no mesh)."""
    b, s, d = x.shape
    n_phys = sum(_replication(cfg))
    xt = x.reshape(b * s, d)
    expert_in, state = _route_and_bucket(p, cfg, xt, n_phys, _moe_capacity(cfg, b * s, n_phys))
    y = _combine(_expert_ffn(p.experts, expert_in, cfg.activation), state, d)
    if cfg.moe.n_shared:
        y = y + mlp_fwd(p.shared, xt, cfg.activation)
    return y.reshape(b, s, d)

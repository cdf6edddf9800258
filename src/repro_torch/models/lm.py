"""Decoder-only LM for the dense (GQA), MoE (GQA or MLA), SSM (Mamba2) and
hybrid (Zamba2) families.

Map to the reference (``src/repro/models/lm.py``):

  ``init_params``      -> ``init_params(cfg, generator=, device=)``: an ``LM``
                          module, float32 parameters drawn from a
                          ``torch.Generator`` with the reference's
                          distributions
  ``init_cache``       -> ``init_cache(cfg, batch, max_seq, device=)``: the
                          preallocated decode state, a dict of stacked tensors
                          as in the reference, with a host-int ``len``
  ``_block_fwd``       -> ``Block.forward`` (attention, GQA or MLA, + MLP or
                          MoE with pre-norms)
  ``_ssm_block_fwd``   -> ``SSMBlock.forward``
  ``forward``          -> ``forward(params, cfg, tokens, cache, positions)``
                          (= ``LM.forward``)

  ``_maybe_remat``, ``_block_size``, ``_scan_layers`` and the hybrid's
  group remat      -> ``_remat``, ``_block_size``, ``LM._remat_layers``
  ``loss_fn``      -> ``loss_fn(params, cfg, tokens, targets, z_loss)``

The reference scans homogeneous layer stacks with ``lax.scan``; here the
layers are an ``nn.ModuleList`` walked by a Python loop, in the same order:
for the hybrid family the shared block runs after every ``shared_every``-th
Mamba2 layer, with or without a cache.  The dense and MoE families are
stacks of ``Block``s; their cache is ``{"layers": {"k", "v" (L, b, max_seq,
nkv, hd), "len"}}``, or with MLA ``{"layers": {"ckv" (L, b, max_seq,
kv_lora), "k_rope" (L, b, max_seq, 1, rope), "len"}}``, with one host-int
``len`` where the reference stacks one per layer.  The family ``encdec``
is ``models.encdec``'s: here it raises ``ValueError``, as the reference's
``init_params`` does for a family it does not build.

Remat follows the reference's structure with
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, and only when
gradients are on, a parameter requires one and there is no cache, so
serving runs as before:

  * dense, MoE and SSM: each layer checkpointed (``cfg.remat``: ``"full"``
    saves the layer's input, ``"dots"`` also the outputs of the products
    without batch dims, ``mm`` and ``addmm``, through selective
    checkpointing), inside checkpointed blocks of ``_block_size(L)`` layers
    (the divisor of L nearest sqrt(L)) unless that is 1 or L;
  * hybrid: a checkpointed group of ``shared_every`` layers, each
    checkpointed, plus the shared block, then the remainder layers one by
    one.

So a kernel inside a checkpointed layer runs again in each recomputation,
and a recomputation stops once it has rebuilt what the backward saved
(``torch.utils.checkpoint``'s early stop, as XLA drops the unused rest of a
rematerialised block): with ``"full"`` a hybrid step launches K4 twice per
site (forward, group recompute) and K5 three times per grouped Mamba2 layer
(forward, group recompute, layer recompute; the shared block closes each
group, so its recompute runs through) and twice per remainder layer;
Zamba2-1.2B's step launches K4 12 times and K5 112.  In a block of the
other families the last layer's recompute is cut (the block saved only its
input), so it runs twice, the others three times.

With a cache, ``forward`` writes the new state into the cache's tensors in
place and returns the same dict.  Prefill (s > 1) with a cache carries the
SSM state out but leaves the Mamba2 conv windows as they were, as the
reference's ``_ssm_block_fwd`` does (ROADMAP.md F4): decode after such a
prefill is the reference's tokens, not the continuation of a full forward.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from .. import resolve_device
from .config import ModelConfig
from .layers import (MLP, GQAttention, MLAttention, MoE, RMSNorm, _dense, embed_lookup, gold_logits,
                     init_gqa_cache, settle,
                     init_mla_cache)
from .ssm import Mamba2, init_mamba2_cache, mamba2_step

__all__ = ["LM", "Block", "SSMBlock", "forward", "init_cache", "init_params", "loss_fn"]

FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _check_family(cfg: ModelConfig):
    if cfg.family in FAMILIES:
        return
    if cfg.family == "encdec":
        raise ValueError(
            f"family 'encdec' ({cfg.name}) is built by models.encdec (init_encdec_params, "
            "init_decoder_cache, encode, decode), not models.lm"
        )
    raise ValueError(f"unsupported family {cfg.family!r}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: save
    the products without batch dims, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig, policy: bool = True):
    """``fn`` checkpointed (reference: ``_maybe_remat``; ``policy=False``
    is the reference's plain ``jax.checkpoint`` of a block or group)."""
    kw = {}
    if policy and cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def _remat_on(model: nn.Module) -> bool:
    """Whether a forward of ``model`` without a cache checkpoints: its
    config asks for remat, grad mode is on and a parameter requires a
    gradient (so serving never checkpoints)."""
    return (model.cfg.remat != "none" and torch.is_grad_enabled()
            and any(p.requires_grad for p in model.parameters()))


def _block_size(L: int) -> int:
    """Divisor of L nearest sqrt(L): the size of the nested remat blocks."""
    best, target = 1, L**0.5
    for k in range(1, L + 1):
        if L % k == 0 and abs(k - target) < abs(best - target):
            best = k
    return best


class Block(nn.Module):
    """One transformer block with pre-norms (reference: ``_init_block`` /
    ``_block_fwd``): ``attn`` (MLA or GQA, by ``cfg.attn.kind``), then
    ``moe`` for the MoE family or ``mlp``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = RMSNorm(cfg.d_model, device=device)
        attn = MLAttention if cfg.attn.kind == "mla" else GQAttention
        self.attn = attn(cfg, generator, device)
        self.mlp_norm = RMSNorm(cfg.d_model, device=device)
        if cfg.family == "moe":
            self.moe = MoE(cfg, generator, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, generator, device)

    def forward(self, x, positions, cache=None):
        eps = self.cfg.norm_eps
        h, new_cache = self.attn(self.attn_norm(x, eps), positions, cache)
        x = x + settle(h)
        ffn = self.moe if self.cfg.family == "moe" else self.mlp
        x = x + settle(ffn(self.mlp_norm(x, eps)))
        return x, new_cache


class SSMBlock(nn.Module):
    """Pre-norm Mamba2 layer (reference: ``_init_ssm_block`` /
    ``_ssm_block_fwd``)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm = RMSNorm(cfg.d_model, device=device)
        self.mamba = Mamba2(cfg, generator, device)

    def forward(self, x, cache=None):
        z = self.norm(x, self.cfg.norm_eps)
        if cache is None:
            h, _ = self.mamba(z)
            return x + settle(h), None
        if x.shape[1] == 1:
            h, cache = mamba2_step(self.mamba, self.cfg, z, cache)
            return x + settle(h), cache
        # prefill with a cache: carry the SSM state out; the conv windows
        # stay as they were (the reference's behaviour, ROADMAP.md F4)
        h, S = self.mamba(z, init_state=cache["ssm"].to(z.dtype))
        cache["ssm"].copy_(S)
        return x + settle(h), cache


class LM(nn.Module):
    """The LM of one ``ModelConfig`` (families ``dense``, ``moe``, ``ssm``
    and ``hybrid``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = _dense((cfg.vocab, cfg.d_model), generator, device)
        block = Block if cfg.family in ("dense", "moe") else SSMBlock
        self.layers = nn.ModuleList(block(cfg, generator, device) for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared_block = Block(cfg, generator, device)
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = _dense((cfg.d_model, cfg.vocab), generator, device)

    def forward(self, tokens, cache: dict | None = None, positions=None):
        """(logits (b, s, vocab) in ``cfg.dtype``, cache).  tokens: (b, s)
        integer ids on the parameters' device."""
        cfg = self.cfg
        x = embed_lookup(self.embed, tokens).to(_dtype(cfg))
        b, s, _ = x.shape
        if positions is None:
            base = 0
            if cache is not None and cfg.family in ("dense", "moe"):
                base = cache["layers"]["len"]
            elif cache is not None and cfg.family == "hybrid":
                base = cache["shared_sites"]["len"]
            positions = (base + torch.arange(s, device=x.device))[None, :].expand(b, s)

        if cache is None and _remat_on(self):
            x = self._remat_layers(x, positions)
        elif cfg.family in ("dense", "moe"):
            x = self._dense_layers(x, positions, cache)
        else:
            x = self._ssm_layers(x, positions, cache)
        x = self.final_norm(x, cfg.norm_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        return x @ head.to(x.dtype), cache

    def _remat_layers(self, x, positions):
        """The layers without a cache under remat, in the reference's
        structure (module docstring)."""
        cfg = self.cfg

        def run(i):
            if cfg.family in ("dense", "moe"):
                return lambda xx: self.layers[i](xx, positions)[0]
            return lambda xx: self.layers[i](xx)[0]

        layer = [_remat(run(i), cfg) for i in range(cfg.n_layers)]

        def span(lo, hi, shared=False):
            def body(xx):
                for i in range(lo, hi):
                    xx = layer[i](xx)
                if shared:
                    xx = self.shared_block(xx, positions)[0]
                return xx

            return _remat(body, cfg, policy=False)

        if cfg.family == "hybrid" and cfg.shared_every and cfg.n_layers >= cfg.shared_every:
            se = cfg.shared_every
            main = cfg.n_layers // se * se
            for g in range(0, main, se):
                x = span(g, g + se, shared=True)(x)
            for i in range(main, cfg.n_layers):
                x = layer[i](x)
            return x
        L = cfg.n_layers
        k = _block_size(L)
        if k <= 1 or k == L:
            for f in layer:
                x = f(x)
            return x
        for lo in range(0, L, k):
            x = span(lo, lo + k)(x)
        return x

    def _dense_layers(self, x, positions, cache):
        """The blocks in order; with a cache each reads and writes its layer
        of the stacked k and v (or ckv and k_rope), and the new length is
        written back."""
        new_len = None
        for i, layer in enumerate(self.layers):
            c_l = None
            if cache is not None:
                c_l = {k: v if k == "len" else v[i] for k, v in cache["layers"].items()}
            x, c_new = layer(x, positions, c_l)
            if c_new is not None:
                new_len = c_new["len"]
        if new_len is not None:
            cache["layers"]["len"] = new_len
        return x

    def _ssm_layers(self, x, positions, cache):
        """Mamba2 layers, with the hybrid family's shared block after every
        ``shared_every``-th."""
        cfg = self.cfg
        hybrid = cfg.family == "hybrid" and cfg.shared_every
        site = 0
        new_len = None
        for i, layer in enumerate(self.layers):
            c_l = None if cache is None else {k: v[i] for k, v in cache["layers"].items()}
            x, _ = layer(x, c_l)
            if hybrid and (i + 1) % cfg.shared_every == 0:
                sc = None
                if cache is not None:
                    sites = cache["shared_sites"]
                    sc = {"k": sites["k"][site], "v": sites["v"][site], "len": sites["len"]}
                x, sc_new = self.shared_block(x, positions, sc)
                if sc_new is not None:
                    new_len = sc_new["len"]
                site += 1
        if new_len is not None:
            cache["shared_sites"]["len"] = new_len
        return x


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> LM:
    """An ``LM`` with random float32 parameters on ``device`` (the card by
    default; it raises without one).  ``generator`` must live on ``device``;
    by default one seeded with 0."""
    dev = resolve_device(device)
    _check_family(cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return LM(cfg, generator, dev)


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    dtype: torch.dtype | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Preallocated decode state on ``device`` (the card by default): for
    the dense and MoE families ``{"layers": {"k", "v" stacked over layers,
    "len": 0}}``, or with MLA ``{"layers": {"ckv", "k_rope" stacked over
    layers, "len": 0}}``; otherwise ``{"layers": {conv_x, conv_B, conv_C, ssm stacked over
    layers}}`` and, for the hybrid family, ``"shared_sites": {"k", "v"
    stacked over the n_layers // shared_every attention sites, "len": 0}``."""
    dev = resolve_device(device)
    _check_family(cfg)
    dtype = dtype or _dtype(cfg)
    if cfg.family in ("dense", "moe"):
        make = init_mla_cache if cfg.attn.kind == "mla" else init_gqa_cache
        return {"layers": _stacked_attn_cache(make(cfg, batch, max_seq, dtype, "meta"), cfg.n_layers, dev)}
    one = init_mamba2_cache(cfg, batch, dtype, dev)
    layers = {
        k: torch.zeros((cfg.n_layers, *v.shape), dtype=v.dtype, device=dev) for k, v in one.items()
    }
    cache = {"layers": layers}
    if cfg.family == "hybrid":
        n_sites = cfg.n_layers // cfg.shared_every
        site = init_gqa_cache(cfg, batch, max_seq, dtype, dev)
        cache["shared_sites"] = {
            "k": torch.zeros((n_sites, *site["k"].shape), dtype=dtype, device=dev),
            "v": torch.zeros((n_sites, *site["v"].shape), dtype=dtype, device=dev),
            "len": 0,
        }
    return cache


def _stacked_attn_cache(one: dict, n_layers: int, device) -> dict:
    """One layer's attention cache (made on the meta device) stacked over
    ``n_layers`` in zeros on ``device``, with one ``len`` of 0."""
    return {**{k: torch.zeros((n_layers, *v.shape), dtype=v.dtype, device=device)
               for k, v in one.items() if k != "len"}, "len": 0}


def forward(params: LM, cfg: ModelConfig, tokens, cache: dict | None = None, positions=None):
    """Returns (logits (b, s, vocab), cache); ``cfg`` must be the one
    ``params`` was built for."""
    if params.cfg != cfg:
        raise ValueError(f"params were built for {params.cfg.name}, not {cfg.name}")
    return params(tokens, cache=cache, positions=positions)


def loss_fn(params: LM, cfg: ModelConfig, tokens, targets, z_loss: float = 1e-4) -> torch.Tensor:
    """Causal LM cross-entropy over float32 logits, with z-loss (reference:
    ``loss_fn``): the mean of ``logsumexp - gold`` plus ``z_loss`` times the
    mean of ``logsumexp ** 2``.  The gold logit is a gather (the
    reference's one-hot contraction has one non-zero term), and each mean
    is a sum over a count."""
    logits, _ = forward(params, cfg, tokens)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = gold_logits(logits, targets)
    n = lse.numel()
    loss = (lse - gold).sum() / n
    if z_loss:
        loss = loss + z_loss * torch.square(lse).sum() / n
    return loss

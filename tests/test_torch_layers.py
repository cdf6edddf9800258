"""The port's transformer layers against the reference's, float32 and bf16.

``apply_rope`` (with M-RoPE on 2-D and 3-D positions), ``rmsnorm``,
``mlp_fwd`` for every activation (gelu is the tanh approximation in both),
and ``gqa_fwd`` with a cache grown in three calls: a prompt at length 0
(K4's plain version), more tokens at length 24 and one decode step (plain
``_sdpa`` against the cache); in bf16, ``_sdpa_block`` at the dense models'
head dim (its scores rounded once, as the reference's float32 promotion
rounds them) and ``gqa_fwd`` with grouped kv heads through a cache.
Parameters come from the reference's ``init_*`` and inputs from numpy; the
reference runs jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import layers as rlayers
from repro_torch.configs import get_config
from repro_torch.models import layers as tlayers


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("sections,pos_dims", [((), 2), ((2, 3, 3), 2), ((2, 3, 3), 3)])
def test_apply_rope_matches_reference(sections, pos_dims):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (3, 2, 9) if pos_dims == 3 else (2, 9))
    for dtype, tol in (("float32", 1e-6), ("bfloat16", 1e-2)):
        want = rlayers.apply_rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos), 10_000.0, sections)
        got = tlayers.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos), 10_000.0, sections)
        assert got.dtype == getattr(torch, dtype)
        assert _rel(got, want) <= tol


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 64)) * 3).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    for dtype, tol in (("float32", 1e-6), ("bfloat16", 1e-2)):
        want = rlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x).astype(dtype), 1e-5)
        got = tlayers.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale), 1e-5)
        assert got.dtype == getattr(torch, dtype) and _rel(got, want) <= tol


@pytest.mark.parametrize("activation", ["gelu_glu", "silu_glu", "sq_relu", "gelu"])
def test_mlp_matches_reference(activation):
    p = rlayers.init_mlp(jax.random.PRNGKey(4), 32, 48, activation)
    mlp = tlayers.MLP(32, 48, activation, None, "cpu")
    mlp.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    x = np.random.default_rng(3).standard_normal((2, 7, 32)).astype(np.float32)
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 3e-2)):
        want = jax.jit(rlayers.mlp_fwd, static_argnums=2)(p, jnp.asarray(x).astype(dtype), activation)
        got = mlp(torch.from_numpy(x).to(getattr(torch, dtype)))
        assert _rel(got, want) <= tol, (dtype, _rel(got, want))


def test_gqa_cache_grows_like_reference():
    """Prompt at length 0 (K4), more tokens at length 24 and one decode step
    (plain _sdpa with the cache), float32, against the reference."""
    rcfg = ref_config("zamba2-1.2b", smoke=True).with_(dtype="float32")
    tcfg = get_config("zamba2-1.2b", smoke=True).with_(dtype="float32")
    p = rlayers.init_gqa(jax.random.PRNGKey(5), rcfg)
    attn = tlayers.GQAttention(tcfg, None, "cpu")
    attn.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    rc = rlayers.init_gqa_cache(rcfg, 2, 40, jnp.float32)
    tc = tlayers.init_gqa_cache(tcfg, 2, 40, torch.float32, "cpu")
    rng = np.random.default_rng(6)
    ref_fwd = jax.jit(rlayers.gqa_fwd, static_argnums=1)
    start = 0
    for s in (24, 8, 1):
        x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(start + np.arange(s)[None], (2, s))
        y_w, rc = ref_fwd(p, rcfg, jnp.asarray(x), jnp.asarray(pos), rc)
        y, tc = tlayers.gqa_fwd(attn, tcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()), tc)
        start += s
        assert tc["len"] == int(rc["len"]) == start
        assert _rel(y, y_w) <= 1e-4
        assert _rel(tc["k"], rc["k"]) <= 1e-5 and _rel(tc["v"], rc["v"]) <= 1e-5


# The reference's _sdpa_block divides its bf16 scores by the float64
# np.sqrt(hd), which JAX promotes to float32: the scores are rounded once.
# Inputs N(0, 2^2) at the dense models' head dim, 12 q on 2 kv heads, causal,
# over a prompt and over a cache (q_offset 40, 240 valid of 260 positions).
_SDPA_CASES = {"prompt": (0, None, 200), "cache": (40, 240, 260)}


@pytest.mark.parametrize("case", sorted(_SDPA_CASES))
def test_sdpa_block_bf16_matches_reference(case):
    q_offset, kv_len, sk = _SDPA_CASES[case]
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((2, 200, 12, 128)) * 2).astype(np.float32)
    k, v = ((rng.standard_normal((2, sk, 2, 128)) * 2).astype(np.float32) for _ in range(2))
    want = np.asarray(rlayers._sdpa_block(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), True,
                                          q_offset, kv_len), np.float32)
    got = tlayers._sdpa_block(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), True, q_offset, kv_len)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= 2.0 ** -7 * np.maximum(1.0, np.abs(want))).all(), float(diff.max())
    assert (diff > 0).mean() <= 1e-3, float((diff > 0).mean())


def test_sdpa_block_float32_scores_unchanged():
    """In float32 the scale and the mask are what they were before the
    bf16 repair: one float32 einsum divided by sqrt(hd)."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 9, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 9, 2, 16)).astype(np.float32)) for _ in range(2))
    got = tlayers._sdpa_block(q, k, v, True, 3, 8)
    qg = q.reshape(2, 9, 2, 2, 16)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k) / 4.0
    mask = (torch.arange(9)[:, None] + 3 >= torch.arange(9)[None, :]) & (torch.arange(9)[None, :] < 8)
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    want = torch.einsum("bkrqs,bskh->bqkrh", torch.softmax(scores, dim=-1), v).reshape(2, 9, 4, 16)
    assert torch.equal(got, want)


def test_gqa_cache_bf16_matches_reference():
    """bf16 through gqa_fwd with grouped kv heads at head dim 128 (12 q on 2
    kv heads): a prompt at length 0 (K4 with the scores rounded as the
    reference rounds them), more tokens at length 24 and one decode step
    (_sdpa over the cache), against the reference's gqa_fwd."""
    import dataclasses

    def heads(cfg):
        return cfg.with_(attn=dataclasses.replace(cfg.attn, n_heads=12, n_kv_heads=2, head_dim=128))

    rcfg, tcfg = heads(ref_config("glm4-9b", smoke=True)), heads(get_config("glm4-9b", smoke=True))
    p = rlayers.init_gqa(jax.random.PRNGKey(5), rcfg)
    attn = tlayers.GQAttention(tcfg, None, "cpu")
    attn.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    rc = rlayers.init_gqa_cache(rcfg, 2, 48, jnp.bfloat16)
    tc = tlayers.init_gqa_cache(tcfg, 2, 48, torch.bfloat16, "cpu")
    rng = np.random.default_rng(6)
    ref_fwd = jax.jit(rlayers.gqa_fwd, static_argnums=1)
    start = 0
    for s in (24, 16, 1):
        x = (rng.standard_normal((2, s, tcfg.d_model)) * 4).astype(np.float32)
        pos = np.broadcast_to(start + np.arange(s)[None], (2, s))
        y_w, rc = ref_fwd(p, rcfg, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos), rc)
        y, tc = tlayers.gqa_fwd(attn, tcfg, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos.copy()), tc)
        start += s
        assert y.dtype == torch.bfloat16 and tc["len"] == int(rc["len"]) == start
        assert _rel(y, y_w) <= 2.0 ** -7, (s, _rel(y, y_w))
        assert _rel(tc["k"], rc["k"]) <= 2.0 ** -7 and _rel(tc["v"], rc["v"]) <= 2.0 ** -7

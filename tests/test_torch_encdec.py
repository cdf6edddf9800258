"""The port's enc-dec model (Whisper) against the reference, serving side.

Parameters come from the reference's ``encdec.init_encdec_params(cfg,
PRNGKey(0))`` and are carried across with ``convert.encdec_params_from_numpy``;
frames and tokens are made with numpy.  The reference runs jitted and
without a mesh; the port runs K4's plain version on the host (the encoder's
non-causal attention, the decoder's prompt attention and every
cross-attention).

On the Whisper SMOKE config (2 + 2 layers, d_model 64, 4 heads of 16, 32
frames):

* ``encode``, ``decode`` without a cache, and ``decode`` of a prompt into
  an empty cache then one token at a time (teacher-forced): float32 within
  1e-4 of max |ref| (the encoder's output, logits, the cache's k and v),
  bfloat16 within 5e-2 of max |logit|; the cache's ``len`` equal.
* Step-by-step cached decode equals the full decode (the reference's
  ``test_whisper_decode_cache_matches``, here at 1e-4 of max |logit| in
  float32).
* ``make_encdec_prefill_step``'s logits and ``make_encdec_decode_step``'s
  greedy tokens against the reference's steps.
* Cross-attention's function: K4's plain version with ``causal=False,
  round_scores=True`` at sq != sk against the reference's unmasked
  ``_sdpa_block``.
* The entry points ask for the card by default and raise without one; the
  family's refusals.
* On the card only: K4 at the enc-dec shapes against its plain version, and
  the SMOKE config on the card against the host.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.distrib.context import set_mesh
from repro.models import encdec as rencdec
from repro.models import layers as rlayers
from repro.train.step import make_encdec_decode_step as ref_decode_step
from repro.train.step import make_encdec_prefill_step as ref_prefill_step
from repro_torch.configs import get_config
from repro_torch.convert import encdec_params_from_numpy, encdec_params_to_numpy
from repro_torch.kernels.flash_attention import flash_attention as k4
from repro_torch.kernels.flash_attention import flash_attention_op, flash_attention_op_ref
from repro_torch.models import encdec
from repro_torch.models import lm as tlm
from repro_torch.train.step import make_encdec_decode_step, make_encdec_prefill_step

ARCH = "whisper-medium"
BATCH, PROMPT, GEN = 2, 6, 4
F32_TOL, BF16_TOL = 1e-4, 5e-2
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}


@pytest.fixture(scope="module", autouse=True)
def _no_mesh():
    set_mesh(None)
    yield


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.cache
def _reference():
    """(reference params, numpy tree) of the SMOKE config."""
    params = rencdec.init_encdec_params(ref_config(ARCH, smoke=True), jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _inputs(cfg, seed=0, s=PROMPT + GEN):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return frames, rng.integers(0, cfg.vocab, (BATCH, s)).astype(np.int32)


def _both(dtype):
    """(reference cfg, reference params, port cfg, port model)."""
    params, tree = _reference()
    cfg = get_config(ARCH, smoke=True).with_(dtype=dtype)
    return ref_config(ARCH, smoke=True).with_(dtype=dtype), params, cfg, encdec_params_from_numpy(tree, cfg, device="cpu")


_r_encode = jax.jit(rencdec.encode, static_argnums=1)
_r_decode = jax.jit(rencdec.decode, static_argnums=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_decode_match_reference(dtype):
    rcfg, params, cfg, model = _both(dtype)
    frames, toks = _inputs(cfg)
    renc = _r_encode(params, rcfg, jnp.asarray(frames))
    rlog, _ = _r_decode(params, rcfg, jnp.asarray(toks), renc)
    with torch.inference_mode():
        enc = encdec.encode(model, cfg, torch.from_numpy(frames))
        logits, cache = encdec.decode(model, cfg, torch.from_numpy(toks).long(), enc)
    assert cache is None
    assert enc.dtype == logits.dtype == getattr(torch, dtype)
    assert tuple(enc.shape) == (BATCH, cfg.encoder_seq, cfg.d_model)
    assert tuple(logits.shape) == (BATCH, PROMPT + GEN, cfg.vocab)
    assert _rel(enc, renc) <= TOL[dtype]
    assert _rel(logits, rlog) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_decode_matches_reference(dtype):
    """A prompt into an empty cache, then GEN tokens one at a time."""
    rcfg, params, cfg, model = _both(dtype)
    frames, toks = _inputs(cfg, seed=1)
    max_seq = PROMPT + GEN
    renc = _r_encode(params, rcfg, jnp.asarray(frames))
    rcache = rencdec.init_decoder_cache(rcfg, BATCH, max_seq)
    with torch.inference_mode():
        enc = encdec.encode(model, cfg, torch.from_numpy(frames))
        cache = encdec.init_decoder_cache(cfg, BATCH, max_seq, device="cpu")
        assert sorted(cache["layers"]) == ["k", "len", "v"] and cache["layers"]["len"] == 0
        assert tuple(cache["layers"]["k"].shape) == (cfg.n_layers, BATCH, max_seq, *cfg.attn_dims()[1:])
        spans = [(0, PROMPT)] + [(t, t + 1) for t in range(PROMPT, max_seq)]
        for a, b in spans:
            rlog, rcache = _r_decode(params, rcfg, jnp.asarray(toks[:, a:b]), renc, rcache)
            logits, cache = encdec.decode(model, cfg, torch.from_numpy(toks[:, a:b]).long(), enc, cache)
            assert _rel(logits, rlog) <= TOL[dtype], (a, b)
            assert cache["layers"]["len"] == b == int(rcache["layers"]["len"][0])
    for name in ("k", "v"):
        assert _rel(cache["layers"][name], rcache["layers"][name]) <= TOL[dtype]


def test_cached_decode_equals_full_decode():
    """The reference's test_whisper_decode_cache_matches on the port alone,
    float32, token by token from an empty cache."""
    cfg = get_config(ARCH, smoke=True).with_(dtype="float32")
    model = encdec.init_encdec_params(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    frames, toks = _inputs(cfg, seed=4, s=6)
    toks = torch.from_numpy(toks).long()
    with torch.inference_mode():
        enc = encdec.encode(model, cfg, torch.from_numpy(frames))
        full, _ = encdec.decode(model, cfg, toks, enc)
        cache = encdec.init_decoder_cache(cfg, BATCH, 8, device="cpu")
        outs = []
        for t in range(6):
            lg, cache = encdec.decode(model, cfg, toks[:, t:t + 1], enc, cache)
            outs.append(lg[:, 0])
    assert _rel(torch.stack(outs, 1), full.numpy()) <= F32_TOL


def test_steps_match_reference():
    """make_encdec_prefill_step's logits, then GEN greedy
    make_encdec_decode_step tokens from the prompt's cache, float32."""
    rcfg, params, cfg, model = _both("float32")
    frames, toks = _inputs(cfg, seed=2, s=PROMPT)
    rlast = jax.jit(ref_prefill_step(rcfg))(params, jnp.asarray(frames), jnp.asarray(toks))
    with torch.inference_mode():
        last = make_encdec_prefill_step(cfg)(model, torch.from_numpy(frames), torch.from_numpy(toks).long())
    assert tuple(last.shape) == (BATCH, cfg.vocab) and _rel(last, rlast) <= F32_TOL

    renc = _r_encode(params, rcfg, jnp.asarray(frames))
    rcache = rencdec.init_decoder_cache(rcfg, BATCH, PROMPT + GEN)
    rlog, rcache = _r_decode(params, rcfg, jnp.asarray(toks), renc, rcache)
    rtok = jnp.argmax(rlog[:, -1], axis=-1)
    rstep = jax.jit(ref_decode_step(rcfg))
    want = []
    for _ in range(GEN):
        rtok, rcache = rstep(params, rcache, renc, rtok[:, None])
        want.append(np.asarray(rtok))
    step = make_encdec_decode_step(cfg)
    with torch.inference_mode():
        enc = encdec.encode(model, cfg, torch.from_numpy(frames))
        cache = encdec.init_decoder_cache(cfg, BATCH, PROMPT + GEN, device="cpu")
        logits, cache = encdec.decode(model, cfg, torch.from_numpy(toks).long(), enc, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)
        got = []
        for _ in range(GEN):
            tok, cache = step(model, cache, enc, tok[:, None])
            got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    assert cache["layers"]["len"] == PROMPT + GEN


@pytest.mark.parametrize("sq, sk", [(1, 50), (7, 50), (64, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_plain_matches_unmasked_sdpa_block(sq, sk, dtype):
    """K4's plain version with causal=False and round_scores is the
    reference's unmasked _sdpa_block at sq != sk (cross-attention's
    function), N(0, 2^2): within 2^-6 of max(1, |ref|) in bf16 (the
    reference also rounds its normalised probabilities), 2e-5 in float32."""
    rng = np.random.default_rng(sq + sk)
    q = (rng.standard_normal((2, sq, 4, 16)) * 2).astype(np.float32)
    k, v = ((rng.standard_normal((2, sk, 4, 16)) * 2).astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(rlayers._sdpa_block(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), False, 0, None),
                      np.float32)
    got = flash_attention_op_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), False, round_scores=True)
    tol = 2.0 ** -6 if dtype == "bfloat16" else 2e-5
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= tol * np.maximum(1.0, np.abs(want))).all(), float(diff.max())


def test_params_round_trip_and_name_checks():
    _, tree = _reference()
    cfg = get_config(ARCH, smoke=True)
    model = encdec_params_from_numpy(tree, cfg, device="cpu")
    back = encdec_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert back["enc_layers"]["attn"]["wq"].shape[0] == cfg.n_encoder_layers
    assert back["dec_layers"]["cross"]["wk"].shape[0] == cfg.n_layers
    with pytest.raises(ValueError, match="unexpected"):
        encdec_params_from_numpy(dict(tree, extra={"w": np.zeros(3)}), cfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        encdec_params_from_numpy({k: v for k, v in tree.items() if k != "enc_norm"}, cfg, device="cpu")
    with pytest.raises(ValueError, match="leading axis"):
        encdec_params_from_numpy(dict(tree, enc_layers=jax.tree.map(lambda a: a[:1], tree["enc_layers"])), cfg,
                                 device="cpu")


def test_entry_points_ask_for_the_card(monkeypatch):
    """Without device= the entry points ask for the card, and raise where
    there is none; a config of another family is refused."""
    from repro_torch.examples import whisper_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, smoke=True)
    for call in (lambda: encdec.init_encdec_params(cfg), lambda: encdec.init_decoder_cache(cfg, 1, 8),
                 lambda: whisper_train.synth_batch(cfg, 0), lambda: whisper_train.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="encdec"):
        encdec.init_encdec_params(get_config("glm4-9b", smoke=True), device="cpu")
    with pytest.raises(ValueError, match="models.encdec"):
        tlm.init_params(cfg, device="cpu")
    model = encdec.init_encdec_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        encdec.encode(model, cfg.with_(dtype="float32"), torch.zeros((1, cfg.encoder_seq, cfg.d_model)))


# ------------------------------------------------------------ on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_encdec_shapes_on_card(dtype):
    """Whisper-medium's attention shapes, 16 heads of 64: the encoder's
    non-causal (4, 1500) and cross-attention at sq 1, 64 and 448 against
    1500 keys, with and without round_scores."""
    dev = _card()
    tol = 2e-5 if dtype == "float32" else 3e-2
    rng = np.random.default_rng(0)
    kv = [torch.from_numpy(rng.standard_normal((4, 1500, 16, 64), dtype=np.float32)).to(dev, getattr(torch, dtype))
          for _ in range(2)]
    for sq in (1500, 1, 64, 448):
        q = torch.from_numpy(rng.standard_normal((4, sq, 16, 64), dtype=np.float32)).to(dev, getattr(torch, dtype))
        for rounded in (False, True):
            before = k4.launches
            got = flash_attention_op(q, *kv, causal=False, round_scores=rounded)
            torch.cuda.synchronize()
            assert k4.launches == before + 1
            want = flash_attention_op_ref(q, *kv, False, round_scores=rounded)
            d = (got.float() - want.float()).abs() / (1 + want.float().abs())
            assert float(d.max()) <= tol, (sq, rounded, float(d.max()))


@pytest.mark.cuda
def test_smoke_card_vs_host():
    """The SMOKE config in float32 from one set of parameters: encode, a
    prompt into the cache and GEN greedy steps on the card (K4) and on the
    host (plain versions): logits within 1e-4 of max |logit|, tokens equal."""
    dev = _card()
    _, tree = _reference()
    cfg = get_config(ARCH, smoke=True).with_(dtype="float32")
    frames, toks = _inputs(cfg, seed=3, s=PROMPT)
    outs = []
    for d in ("cpu", dev):
        model = encdec_params_from_numpy(tree, cfg, device=d)
        with torch.inference_mode():
            enc = encdec.encode(model, cfg, torch.from_numpy(frames).to(d))
            cache = encdec.init_decoder_cache(cfg, BATCH, PROMPT + GEN, device=d)
            logits, cache = encdec.decode(model, cfg, torch.from_numpy(toks).long().to(d), enc, cache)
            tok, got = torch.argmax(logits[:, -1], -1), []
            for _ in range(GEN):
                tok, cache = make_encdec_decode_step(cfg)(model, cache, enc, tok[:, None])
                got.append(tok)
        outs.append((logits.float().cpu(), torch.stack(got, 1).cpu()))
    assert _rel(outs[1][0], outs[0][0].numpy()) <= F32_TOL
    assert torch.equal(outs[0][1], outs[1][1])

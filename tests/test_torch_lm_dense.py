"""The port's dense family (GQA transformer blocks) against the reference.

Parameters come from the reference's ``lm.init_params(cfg, PRNGKey(0))``
and are carried across with ``convert.lm_params_from_numpy``; prompts are
made with numpy.  The reference runs jitted, as its serve loop does; the
port runs its kernels' plain versions on the host: K4 for the prompt's
grouped-head attention, and K3 for Nemotron's squared-ReLU down-projection
(the ragged prompt gives K3 an M of 2 x 19 rows against its 128-row tile,
and the SMOKE d_model an N of 64).

On the SMOKE configs of GLM-4-9B, Nemotron-4-15B, Qwen2-VL-2B (M-RoPE on
text positions, qkv bias), Qwen2.5-32B and Qwen1.5-110B: ``forward``
without a cache, then prefill with a cache at a ragged prompt and 4 greedy
decode steps.
  - float32: logits and the k/v caches within 1e-4 of max |ref|, equal
    tokens and ``len``;
  - bfloat16, the configs' own dtype: logits within 5e-2 of max |logit|;
  - a cache too short for the decode (``max_seq`` 8, a prompt of 6, 4
    steps): the reference clamps the write's start index and attends with
    ``q_offset = len``, ``kv_len = len + s``; the port computes the same.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import lm as rlm
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import lm as tlm

ARCHS = ["glm4-9b", "nemotron-4-15b", "qwen2-vl-2b", "qwen2.5-32b", "qwen1.5-110b"]
PROMPT = 19
GEN = 4
BATCH = 2
F32_TOL = 1e-4
BF16_TOL = 5e-2


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch, reference params, numpy pytree): one reference init per arch."""
    params = rlm.init_params(ref_config(request.param, smoke=True), jax.random.PRNGKey(0))
    return request.param, params, jax.tree.map(np.asarray, params)


def _serve_both(arch, dtype, prompt=PROMPT, gen=GEN, max_seq=None, forward=True):
    """Both packages: (optionally) a no-cache forward, then prefill with a
    cache of ``max_seq`` positions (prompt + gen by default) and ``gen``
    greedy decode steps, each step's logits kept."""
    name, rparams, tree = arch
    rcfg = ref_config(name, smoke=True).with_(dtype=dtype)
    tcfg = get_config(name, smoke=True).with_(dtype=dtype)
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    max_seq = max_seq or prompt + gen
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (BATCH, prompt)).astype(np.int32)
    out = {}
    if forward:
        fwd = jax.jit(lambda p, t: rlm.forward(p, rcfg, t)[0])
        out["ref_logits"] = np.asarray(fwd(rparams, jnp.asarray(toks)), np.float32)
        out["logits"] = tlm.forward(model, tcfg, torch.from_numpy(toks).long())[0]

    step = jax.jit(lambda p, t, c: rlm.forward(p, rcfg, t, cache=c))
    rl, rc = step(rparams, jnp.asarray(toks), rlm.init_cache(rcfg, BATCH, max_seq))
    tc = tlm.init_cache(tcfg, BATCH, max_seq, device="cpu")
    tok, tl, tc = serve.prefill(model, tcfg, torch.from_numpy(toks).long(), tc)
    out["ref_steps"], out["steps"] = [np.asarray(rl, np.float32)], [tl]
    rtok = jnp.argmax(rl[:, -1], -1)
    rtoks, ttoks = [np.asarray(rtok)], [tok.numpy()]
    for _ in range(gen):
        rl, rc = step(rparams, rtok[:, None], rc)
        rtok = jnp.argmax(rl[:, -1], -1)
        tl, tc = tlm.forward(model, tcfg, tok[:, None], cache=tc)
        tok = torch.argmax(tl[:, -1], dim=-1)
        out["ref_steps"].append(np.asarray(rl, np.float32))
        out["steps"].append(tl)
        rtoks.append(np.asarray(rtok))
        ttoks.append(tok.numpy())
    out["ref_tokens"], out["tokens"] = np.stack(rtoks, 1), np.stack(ttoks, 1)
    out["ref_cache"], out["cache"] = rc, tc
    return out


@pytest.fixture(scope="module")
def float32_run(arch):
    return _serve_both(arch, "float32")


def test_forward_matches_reference_float32(float32_run):
    r = float32_run
    assert r["logits"].shape == r["ref_logits"].shape
    assert _rel(r["logits"], r["ref_logits"]) <= F32_TOL
    for got, want in zip(r["steps"], r["ref_steps"]):
        assert got.shape == want.shape
        assert _rel(got, want) <= F32_TOL


def test_decode_matches_reference_float32(float32_run):
    r = float32_run
    np.testing.assert_array_equal(r["tokens"], r["ref_tokens"])
    layers, ref_layers = r["cache"]["layers"], r["ref_cache"]["layers"]
    for k in ("k", "v"):
        assert layers[k].dtype == torch.float32 and layers[k].shape == ref_layers[k].shape
        assert _rel(layers[k], ref_layers[k]) <= F32_TOL, k
    assert layers["len"] == PROMPT + GEN
    assert np.all(np.asarray(ref_layers["len"]) == layers["len"])


def test_bf16_within_tolerance(arch):
    r = _serve_both(arch, "bfloat16")
    assert r["logits"].dtype == torch.bfloat16
    assert _rel(r["logits"], r["ref_logits"]) <= BF16_TOL
    for got, want in zip(r["steps"], r["ref_steps"]):
        assert torch.isfinite(got.float()).all()
        assert _rel(got, want) <= BF16_TOL


def test_decode_past_the_cache_end(arch):
    """max_seq 8, a prompt of 6 and 4 decode steps: the last two writes
    land at the clamped start 7, and the logits and tokens stay the
    reference's."""
    r = _serve_both(arch, "float32", prompt=6, gen=4, max_seq=8, forward=False)
    np.testing.assert_array_equal(r["tokens"], r["ref_tokens"])
    for got, want in zip(r["steps"], r["ref_steps"]):
        assert _rel(got, want) <= F32_TOL
    layers, ref_layers = r["cache"]["layers"], r["ref_cache"]["layers"]
    assert layers["len"] == 10 and np.all(np.asarray(ref_layers["len"]) == 10)
    for k in ("k", "v"):
        assert _rel(layers[k], ref_layers[k]) <= F32_TOL, k


def test_lm_params_from_numpy_carries_the_dense_tree(arch):
    name, _, tree = arch
    cfg = get_config(name, smoke=True)
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    np.testing.assert_array_equal(model.layers[1].attn.wq.numpy(), tree["layers"]["attn"]["wq"][1])
    np.testing.assert_array_equal(model.layers[0].mlp.w_down.numpy(), tree["layers"]["mlp"]["w_down"][0])
    if cfg.attn.qkv_bias:
        np.testing.assert_array_equal(model.layers[1].attn.bk.numpy(), tree["layers"]["attn"]["bk"][1])
    partial = dict(tree, layers=dict(tree["layers"], attn_norm={}))
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_numpy(partial, cfg, device="cpu")


def test_prompt_longer_than_the_cache_is_refused():
    cfg = get_config("glm4-9b", smoke=True).with_(dtype="float32")
    model = tlm.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    cache = tlm.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="positions"):
        tlm.forward(model, cfg, torch.zeros((1, 5), dtype=torch.long), cache=cache)


def test_serve_defaults_to_glm4_9b(capsys):
    """``launch.serve``'s ``--arch`` defaults to the reference's glm4-9b."""
    rc = serve.main(["--smoke", "--batch", "2", "--prompt-len", "10", "--gen", "3", "--device", "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "glm4-9b-smoke" and len(line["sample"]) == 3

"""The port's serving slice (Zamba2 hybrid, Mamba2 ssm) against the reference.

Parameters come from the reference's ``lm.init_params(cfg, PRNGKey(0))``
and are carried across with ``convert.lm_params_from_numpy``; prompts are
made with numpy.  The reference runs jitted, as its serve loop does; the
port runs its kernels' plain versions (K4, K5) on the host.

* The whole slice on the SMOKE configs: ``forward`` without a cache, then
  prefill with a cache at a ragged prompt (Zamba2: 24 tokens against chunk
  16; Mamba2: 40 against chunk 32) and 4 greedy decode steps.
  - float32 (``cfg.with_(dtype="float32")``): logits, the conv/SSM/KV
    caches and ``len`` within 1e-4 of max |ref|, and equal tokens.
  - bfloat16, the configs' own dtype, at 5e-2 of max |logit| (measured:
    0.032 Zamba2, 0.035 Mamba2), with each Mamba2 layer's ``dt_bias`` set
    as Mamba2's own initialisation sets it (dt log-uniform in [1e-3, 1e-1]).
    The reference's ``init_mamba2`` leaves ``dt_bias`` at 0, so dt ~ 0.7 and
    the decay cumsum reaches |cum| ~ 500 within a chunk, where a bf16 step
    is 2 to 4: given the same bf16 inputs, the reference's bf16 SSD scan is
    then 8.5% of max |y| from its float32 result and the port's 6.5%, in
    different directions, and no bf16 run meets 5e-2 against another.  At
    that init the check is that the port's bf16 logits are no farther from
    the float32 reference than twice the reference's own bf16 logits.
* ``launch.serve.main`` on the host, the enc-dec family refused by
  ``models.lm`` (``models.encdec`` builds it) and the MoE family's
  parameters and cache on the host.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import lm as rlm
from repro.train.step import make_decode_step as ref_decode_step
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.train.step import make_decode_step, make_prefill_step

PROMPT = {"zamba2-1.2b": 24, "mamba2-370m": 40}
GEN = 4
BATCH = 2
BF16_TOL = 5e-2


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -------------------------------------------------------------- the slice


@pytest.fixture(scope="module", params=["zamba2-1.2b", "mamba2-370m"])
def arch(request):
    """(arch, reference params, numpy pytree): one reference init per arch."""
    params = rlm.init_params(ref_config(request.param, smoke=True), jax.random.PRNGKey(0))
    return request.param, params, jax.tree.map(np.asarray, params)


def _mamba2_dt_init(params, seed=0):
    """``params`` with every Mamba2 layer's ``dt_bias`` as Mamba2's own
    initialisation sets it: dt log-uniform in [1e-3, 1e-1], and the bias its
    inverse softplus."""
    mamba = params["layers"]["mamba"]
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), mamba["dt_bias"].shape))
    bias = jnp.asarray((dt + np.log(-np.expm1(-dt))).astype(np.float32))
    return dict(params, layers=dict(params["layers"], mamba=dict(mamba, dt_bias=bias)))


def _serve_both(arch, dtype):
    """Run the slice in both packages: no-cache forward, prefill with a
    cache, GEN greedy decode steps.  Returns what each produced."""
    name, rparams, tree = arch
    rcfg = ref_config(name, smoke=True).with_(dtype=dtype)
    tcfg = get_config(name, smoke=True).with_(dtype=dtype)
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    s = PROMPT[name]
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (BATCH, s)).astype(np.int32)
    out = {"cfg": tcfg}

    fwd = jax.jit(lambda p, t: rlm.forward(p, rcfg, t)[0])
    out["ref_logits"] = np.asarray(fwd(rparams, jnp.asarray(toks)), np.float32)
    out["logits"] = tlm.forward(model, tcfg, torch.from_numpy(toks).long())[0]

    prefill = jax.jit(lambda p, t, c: rlm.forward(p, rcfg, t, cache=c))
    rl, rc = prefill(rparams, jnp.asarray(toks), rlm.init_cache(rcfg, BATCH, s + GEN))
    tc = tlm.init_cache(tcfg, BATCH, s + GEN, device="cpu")
    tok, tl, tc = serve.prefill(model, tcfg, torch.from_numpy(toks).long(), tc)
    out["ref_prefill"], out["prefill"] = np.asarray(rl, np.float32), tl
    out["conv_after_prefill"] = {k: tc["layers"][k].clone() for k in ("conv_x", "conv_B", "conv_C")}

    step = jax.jit(ref_decode_step(rcfg))
    rtok = jnp.argmax(rl[:, -1], -1)
    rtoks = [np.asarray(rtok)]
    for _ in range(GEN):
        rtok, rc = step(rparams, rc, rtok[:, None])
        rtoks.append(np.asarray(rtok))
    rest, tc = serve.decode(model, tcfg, tc, tok, GEN)
    out["ref_tokens"] = np.stack(rtoks, axis=1)
    out["tokens"] = torch.cat([tok[:, None], rest], dim=1).numpy()
    out["ref_cache"], out["cache"] = rc, tc
    return out


@pytest.fixture(scope="module")
def float32_run(arch):
    return _serve_both(arch, "float32")


@pytest.fixture(scope="module")
def bf16_run(arch):
    return _serve_both(arch, "bfloat16")


def test_forward_matches_reference_float32(float32_run):
    r = float32_run
    assert r["logits"].shape == r["ref_logits"].shape
    assert _rel(r["logits"], r["ref_logits"]) <= 1e-4
    assert _rel(r["prefill"], r["ref_prefill"]) <= 1e-4


def test_decode_matches_reference_float32(float32_run):
    r = float32_run
    np.testing.assert_array_equal(r["tokens"], r["ref_tokens"])
    for k, want in r["ref_cache"]["layers"].items():
        assert r["cache"]["layers"][k].dtype == torch.float32
        assert _rel(r["cache"]["layers"][k], want) <= 1e-4, k
    if "shared_sites" in r["ref_cache"]:
        sites, ref_sites = r["cache"]["shared_sites"], r["ref_cache"]["shared_sites"]
        assert _rel(sites["k"], ref_sites["k"]) <= 1e-4 and _rel(sites["v"], ref_sites["v"]) <= 1e-4
        assert sites["len"] == PROMPT["zamba2-1.2b"] + GEN
        assert np.all(np.asarray(ref_sites["len"]) == sites["len"])


def test_prefill_leaves_conv_windows(float32_run):
    """ROADMAP F4: prefill with a cache carries the SSM state out but not
    the conv windows, in the reference and so in the port."""
    for k, t in float32_run["conv_after_prefill"].items():
        assert not t.any(), k


def test_bf16_within_measured_tolerance(arch):
    """bf16 against the reference's bf16 at Mamba2's own dt init."""
    name, params, _ = arch
    params = _mamba2_dt_init(params)
    r = _serve_both((name, params, jax.tree.map(np.asarray, params)), "bfloat16")
    assert r["logits"].dtype == torch.bfloat16
    assert torch.isfinite(r["logits"].float()).all() and torch.isfinite(r["prefill"].float()).all()
    assert _rel(r["logits"], r["ref_logits"]) <= BF16_TOL
    assert _rel(r["prefill"], r["ref_prefill"]) <= BF16_TOL


def test_bf16_no_farther_from_float32_than_reference(bf16_run, float32_run):
    """At the reference's own init (|cum| ~ 500): the port's bf16 logits no
    farther from the float32 reference than twice the reference's own."""
    r = bf16_run
    assert r["logits"].dtype == torch.bfloat16
    assert torch.isfinite(r["logits"].float()).all() and torch.isfinite(r["prefill"].float()).all()
    truth = float32_run["ref_logits"]
    assert _rel(r["logits"], truth) <= 2 * _rel(r["ref_logits"], truth)


def test_prefill_step_is_the_last_logits(float32_run, arch):
    name, _, tree = arch
    cfg = float32_run["cfg"]
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT[name])))
    last = make_prefill_step(cfg)(model, toks)
    torch.testing.assert_close(last, float32_run["logits"][:, -1, :])
    nxt, _ = make_decode_step(cfg)(model, tlm.init_cache(cfg, BATCH, 8, device="cpu"), toks[:, :1])
    assert nxt.shape == (BATCH,)


# ---------------------------------------------------------- entry points


def test_serve_main_on_the_host(capsys):
    rc = serve.main(["--arch", "zamba2-1.2b", "--smoke", "--batch", "2", "--prompt-len", "20",
                     "--gen", "3", "--device", "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "zamba2-1.2b-smoke" and line["batch"] == 2
    assert len(line["sample"]) == 3 and line["prefill_s"] >= 0 and line["decode_tok_per_s"] > 0


@pytest.mark.parametrize("name", ["grok-1-314b", "deepseek-v2-236b", "whisper-medium"])
def test_other_families_wait_for_their_slice(name):
    """The enc-dec family is refused by ``models.lm`` with a ValueError that
    names ``models.encdec``, which builds its SMOKE tree; the MoE family
    (GQA and MLA) builds its parameters and cache on the host."""
    cfg = get_config(name, smoke=True)
    if cfg.family == "encdec":
        from repro_torch.models import encdec

        for call in (lambda: tlm.init_params(cfg, device="cpu"), lambda: tlm.init_cache(cfg, 1, 8, device="cpu"),
                     lambda: tlm.LM(cfg)):
            with pytest.raises(ValueError, match="models.encdec"):
                call()
        model = encdec.init_encdec_params(cfg, device="cpu")
        assert len(model.enc_layers) == cfg.n_encoder_layers and len(model.dec_layers) == cfg.n_layers
        assert all(hasattr(layer, "cross") for layer in model.dec_layers)
        cache = encdec.init_decoder_cache(cfg, 1, 8, device="cpu")
        assert sorted(cache["layers"]) == ["k", "len", "v"] and cache["layers"]["len"] == 0
        assert cache["layers"]["k"].shape[:3] == (cfg.n_layers, 1, 8)
        return
    model = tlm.init_params(cfg, device="cpu")
    assert all(hasattr(layer, "moe") and not hasattr(layer, "mlp") for layer in model.layers)
    n_slots = model.layers[0].moe.experts.w_up.shape[0]
    assert n_slots == cfg.moe.n_experts
    cache = tlm.init_cache(cfg, 1, 8, device="cpu")
    kv = ("ckv", "k_rope") if cfg.attn.kind == "mla" else ("k", "v")
    assert sorted(cache["layers"]) == sorted((*kv, "len")) and cache["layers"]["len"] == 0
    assert all(cache["layers"][k].shape[:3] == (cfg.n_layers, 1, 8) for k in kv)


def test_lm_params_from_numpy_checks_names(arch):
    name, _, tree = arch
    cfg = get_config(name, smoke=True)
    bad = dict(tree, extra={"w": np.zeros(3)})
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    partial = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_numpy(partial, cfg, device="cpu")

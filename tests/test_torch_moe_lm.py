"""The port's MoE family, DeepSeek-V2 (MLA + MoE) and Grok-1 (GQA + MoE),
as whole SMOKE LMs against the reference, and the redeployment with
replicated expert banks.

Parameters come from the reference's ``lm.init_params(cfg, PRNGKey(0))``
through ``convert.lm_params_from_numpy``; prompts are made with numpy.  The
reference runs jitted and without a mesh (its ``moe_fwd``'s local path);
the port runs Grok-1's prompt attention through K4's plain version on the
host.

* float32: a no-cache forward, then prefill with a cache and 4 greedy
  decode steps, logits and caches within 1e-4 of max |ref|, equal tokens.
* Decode equal to the full forward at ``capacity_factor=16`` (no drops), as
  the reference's ``tests/test_arch_smoke.py`` holds it.
* Redeploy: the routing profiled, ``plan_replication``, the expert banks'
  slots gathered by ``np.repeat(arange(E), replication)`` (as
  ``examples/expert_replication_flow.py`` expands them): at
  ``capacity_factor=16`` the logits equal the original's within 1e-5 and
  the reference's redeployment's within 1e-4.
* On the card only: the SMOKE configs in float32 card against host, logits
  within 1e-4, tokens and routing records equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.distrib.context import set_mesh
from repro.models import lm as rlm
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.alloc import expert as texp
from repro_torch.launch import serve
from repro_torch.models import layers as tlay
from repro_torch.models import lm as tlm

ARCHS = ["deepseek-v2-236b", "grok-1-314b"]
BATCH = 2
PROMPT = 13
GEN = 4
F32_TOL = 1e-4
LAYER_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _no_mesh():
    set_mesh(None)
    yield


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (BATCH, n)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch, reference params, numpy pytree): one reference init per arch."""
    params = rlm.init_params(ref_config(request.param, smoke=True), jax.random.PRNGKey(0))
    return request.param, params, jax.tree.map(np.asarray, params)


def _with_replication(cfg, replication, **moe):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, replication=tuple(replication), **moe))


def _replicated_tree(tree, replication):
    """The reference's pytree with every expert bank's slots gathered by
    ``np.repeat(arange(E), replication)`` (replicas are copies)."""
    idx = np.repeat(np.arange(len(replication)), replication)
    experts = {k: np.asarray(v)[:, idx] for k, v in tree["layers"]["moe"]["experts"].items()}
    moe = dict(tree["layers"]["moe"], experts=experts)
    return dict(tree, layers=dict(tree["layers"], moe=moe))


def test_lm_matches_reference_float32(arch):
    """No-cache forward, then prefill with a cache and GEN greedy steps."""
    name, rparams, tree = arch
    rcfg = ref_config(name, smoke=True).with_(dtype="float32")
    cfg = get_config(name, smoke=True).with_(dtype="float32")
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    toks = _tokens(cfg, PROMPT)
    fwd = jax.jit(lambda p, t: rlm.forward(p, rcfg, t)[0])
    assert _rel(tlm.forward(model, cfg, torch.from_numpy(toks).long())[0], fwd(rparams, jnp.asarray(toks))) <= F32_TOL

    step = jax.jit(lambda p, t, c: rlm.forward(p, rcfg, t, cache=c))
    rl, rc = step(rparams, jnp.asarray(toks), rlm.init_cache(rcfg, BATCH, PROMPT + GEN))
    tc = tlm.init_cache(cfg, BATCH, PROMPT + GEN, device="cpu")
    tok, tl, tc = serve.prefill(model, cfg, torch.from_numpy(toks).long(), tc)
    assert _rel(tl, rl) <= F32_TOL
    rtok = jnp.argmax(rl[:, -1], -1)
    for i in range(GEN):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok), err_msg=f"step {i}")
        rl, rc = step(rparams, rtok[:, None], rc)
        tl, tc = tlm.forward(model, cfg, tok[:, None], cache=tc)
        assert _rel(tl, rl) <= F32_TOL, i
        rtok, tok = jnp.argmax(rl[:, -1], -1), torch.argmax(tl[:, -1], dim=-1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
    for k, v in tc["layers"].items():
        if k == "len":
            assert v == PROMPT + GEN and np.all(np.asarray(rc["layers"]["len"]) == v)
        else:
            assert v.shape == rc["layers"][k].shape and _rel(v, rc["layers"][k]) <= F32_TOL, k


def test_decode_matches_forward(arch):
    """Token by token decode equals the full forward at capacity_factor 16
    (no drops), as the reference's ``tests/test_arch_smoke.py`` holds it."""
    name, _, tree = arch
    base = get_config(name, smoke=True).with_(dtype="float32")
    cfg = base.with_(moe=dataclasses.replace(base.moe, capacity_factor=16.0))
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, n=8, seed=2)).long()
    full = tlm.forward(model, cfg, toks)[0]
    cache = tlm.init_cache(cfg, BATCH, 16, device="cpu")
    steps = []
    for t in range(8):
        lg, cache = tlm.forward(model, cfg, toks[:, t : t + 1], cache=cache)
        steps.append(lg[:, 0])
    assert _rel(torch.stack(steps, dim=1), full.numpy()) <= F32_TOL


def test_redeploy_with_replicas(arch):
    """Profile the routing, plan, redeploy with replicated banks: at
    capacity_factor 16 the logits equal the original's (replicas are
    copies) and the reference's redeployment's."""
    name, rparams, tree = arch
    base = get_config(name, smoke=True).with_(dtype="float32")
    cfg = base.with_(moe=dataclasses.replace(base.moe, capacity_factor=16.0))
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, n=16, seed=6)).long()
    with tlay.capture_routing() as rec:
        want = tlm.forward(model, cfg, toks)[0]
    hist = np.bincount(np.concatenate([r.reshape(-1) for r in rec]), minlength=cfg.moe.n_experts)
    plan = texp.plan_replication(hist / hist.sum(), cfg.moe.n_experts + 3)
    assert plan.n_physical > cfg.moe.n_experts and max(plan.replication) > 1
    rtree = _replicated_tree(tree, plan.replication)
    rcfg = _with_replication(cfg, plan.replication)
    redeployed = lm_params_from_numpy(rtree, rcfg, device="cpu")
    assert redeployed.layers[0].moe.experts.w_up.shape[0] == plan.n_physical
    got = tlm.forward(redeployed, rcfg, toks)[0]
    assert _rel(got, want.numpy()) <= LAYER_TOL
    ref_cfg = _with_replication(ref_config(name, smoke=True).with_(dtype="float32"), plan.replication,
                                capacity_factor=16.0)
    ref = rlm.forward(jax.tree.map(jnp.asarray, rtree), ref_cfg, jnp.asarray(toks.numpy().astype(np.int32)))[0]
    assert _rel(got, ref) <= F32_TOL


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHS)
def test_smoke_card_vs_host(name):
    """The SMOKE config in float32 with the same parameters on the host and
    the card: logits within 1e-4, tokens and routing records equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_config(name, smoke=True).with_(dtype="float32")
    host = tlm.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = tlm.LM(cfg, None, torch.device("cuda"))
    card.load_state_dict(host.state_dict())
    toks = torch.from_numpy(_tokens(cfg, 40)).long()
    outs = []
    with torch.inference_mode():
        for model, d in ((host, "cpu"), (card, "cuda")):
            with tlay.capture_routing() as rec:
                cache = tlm.init_cache(cfg, BATCH, 44, device=d)
                tok, logits, cache = serve.prefill(model, cfg, toks.to(d), cache)
                rest, _ = serve.decode(model, cfg, cache, tok, 3)
            outs.append((logits.float().cpu(), torch.cat([tok[:, None], rest], dim=1).cpu(), rec))
    (lh, th, rh), (lc, tc, rc) = outs
    assert _rel(lc, lh.numpy()) <= F32_TOL
    assert torch.equal(th, tc)
    assert len(rh) == len(rc) and all(np.array_equal(a, b) for a, b in zip(rh, rc))

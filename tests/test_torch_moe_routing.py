"""The routing capture of the port's MoE family against the reference.

The reference's ``capture_routing`` records eager ``moe_fwd`` calls only,
so its side runs the eager ``_block_fwd`` loop of ``tests/test_alloc.py``
(then its final norm and head); parameters come from the reference's
``lm.init_params`` through ``convert.lm_params_from_numpy``, tokens from
numpy, and the reference runs without a mesh.

* DeepSeek-V2 SMOKE at ``PRNGKey(3)`` (``tests/test_alloc.py``'s): the
  port's records equal the reference's, and ``plan_replication`` of their
  histogram gives the same plan.
* Both SMOKE LMs in bf16, their own dtype: the records equal in at least
  99% of entries, and over the tokens whose routing agrees in every layer
  the logits within 5e-2 of max |logit| (the test prints the shares).
"""

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
from repro.core.alloc import expert as rexp
from repro.models import layers as rlay
from repro_torch.core.alloc import expert as texp
from repro_torch.models import layers as tlay
from repro_torch.models import lm as tlm

ARCHS = ["deepseek-v2-236b", "grok-1-314b"]
DSV2 = "deepseek-v2-236b"
BATCH = 2
BF16_TOL = 5e-2


@pytest.fixture(scope="module", autouse=True)
def _no_mesh():
    set_mesh(None)
    yield


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (BATCH, n)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch, reference params, numpy pytree): one reference init per arch."""
    params = rlm.init_params(ref_config(request.param, smoke=True), jax.random.PRNGKey(0))
    return request.param, params, jax.tree.map(np.asarray, params)


def _ref_block_loop(rparams, rcfg, toks):
    """The reference's eager ``_block_fwd`` loop (``tests/test_alloc.py``),
    which ``capture_routing`` records; then its final norm and head."""
    x = rparams["embed"].astype(jnp.dtype(rcfg.dtype))[toks]
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1])[None], toks.shape)
    with rlay.capture_routing() as records:
        for i in range(rcfg.n_layers):
            p_l = jax.tree.map(lambda a, i=i: a[i], rparams["layers"])
            x, _ = rlm._block_fwd(p_l, rcfg, x, pos, None)
    x = rlay.rmsnorm(rparams["final_norm"], x, rcfg.norm_eps)
    return np.asarray(x @ rparams["lm_head"].astype(x.dtype), np.float32), records


def test_capture_routing_matches_reference():
    rcfg = ref_config(DSV2, smoke=True)
    cfg = get_config(DSV2, smoke=True)
    rparams = rlm.init_params(rcfg, jax.random.PRNGKey(3))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    toks = _tokens(cfg, 32, seed=4)
    _, rrec = _ref_block_loop(rparams, rcfg, jnp.asarray(toks))
    with tlay.capture_routing() as trec:
        tlm.forward(model, cfg, torch.from_numpy(toks).long())
    assert len(trec) == len(rrec) == cfg.n_layers
    for t, r in zip(trec, rrec):
        assert t.dtype == r.dtype and t.shape == r.shape == (64, cfg.moe.top_k)
        np.testing.assert_array_equal(t, r)
    eids = np.concatenate([r.reshape(-1) for r in trec])
    hist = np.bincount(eids, minlength=cfg.moe.n_experts).astype(float)
    hist /= hist.sum()
    budget = cfg.moe.n_experts + 4
    plan = texp.plan_replication(hist, budget)
    assert plan.replication == rexp.plan_replication(hist, budget).replication
    assert plan.max_slot_load <= hist.max()


def test_lm_bf16_routing_and_logits(arch):
    """bf16, the configs' own dtype: the routing records agree in at least
    99% of entries; over the tokens whose routing agrees in every layer the
    logits are within 5e-2 of max |logit|."""
    name, rparams, tree = arch
    rcfg = ref_config(name, smoke=True)
    cfg = get_config(name, smoke=True)
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    toks = _tokens(cfg, 32, seed=5)
    rlogits, rrec = _ref_block_loop(rparams, rcfg, jnp.asarray(toks))
    with tlay.capture_routing() as trec:
        tlogits = tlm.forward(model, cfg, torch.from_numpy(toks).long())[0]
    assert len(trec) == len(rrec) == cfg.n_layers
    same = np.stack([t == r for t, r in zip(trec, rrec)])  # (L, N, k)
    share = float(same.mean())
    agree = same.all(axis=(0, 2)).reshape(toks.shape)
    print(f"{name} bf16: routing entries equal {share:.4f}; tokens agreeing in every layer {agree.mean():.4f}")
    assert share >= 0.99
    t, r = tlogits.float().numpy()[agree], rlogits[agree]
    assert float(np.abs(t - r).max() / np.abs(r).max()) <= BF16_TOL

"""The port's MoE layers (DeepSeek-V2's MLA, the capacity-bucketed MoE)
and the expert-replication planner against the reference.

Parameters come from the reference's ``init_*`` functions and are carried
across as numpy; inputs are made with numpy.  The reference's ``moe_fwd``
runs without a mesh (``set_mesh(None)``), its local path, the one the port
has; it runs jitted except where ``capture_routing`` must record (the
reference records eager calls only).

* Expert planning (``core.alloc.expert``): equal to the reference exactly.
* MLA: ``mla_fwd`` without a cache, and a prefill then two decode steps
  with one, float32 within 1e-5 of max |ref|.
* The MoE layer in float32 within 1e-5, with and without replicas; at a
  capacity that drops tokens the bucket state (``keep``, ``buf_idx``,
  ``s_tok``) is equal exactly.  A bf16 router built to tie gives the
  reference's expert ids and gates (``jax.lax.top_k`` keeps ties in
  ascending index order).  ``_combine`` on the same bf16 inputs is bit-equal
  to the reference's scatter-add, and on the card bit-identical over two
  runs and to the host.

The LMs are in ``test_torch_moe_lm.py``, the routing capture in
``test_torch_moe_routing.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core.alloc import expert as rexp
from repro.distrib.context import set_mesh
from repro.models import layers as rlay
from repro_torch.configs import get_config
from repro_torch.core.alloc import expert as texp
from repro_torch.models import layers as tlay

DSV2 = "deepseek-v2-236b"
BATCH = 2
LAYER_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _no_mesh():
    set_mesh(None)
    yield


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _load(module, tree):
    """``module`` holding the reference's parameter pytree ``tree``."""
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in _flat(tree)})
    return module


def _with_replication(cfg, replication, **moe):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, replication=tuple(replication), **moe))


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


# ------------------------------------------------------------ expert planning


def _pareto(e, seed=0):
    h = np.random.default_rng(seed).pareto(1.1, size=e) + 0.05
    return h / h.sum()


PLANS = {
    "pareto-160-to-256": (_pareto(160), 256, dict(pad_to=256)),  # benchmarks/run.py's expert_replication
    "pareto-160-budget-192": (_pareto(160, 1), 192, {}),
    "pareto-160-pad-to-192": (_pareto(160, 2), 170, dict(pad_to=192)),
    "tiny-budget": (_pareto(8, 3), 9, {}),
    "uniform": (np.full(16, 1 / 16), 24, {}),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_replication_matches_reference(case):
    hist, budget, kw = PLANS[case]
    r = rexp.plan_replication(hist, budget, **kw)
    t = texp.plan_replication(hist, budget, **kw)
    assert t.replication == r.replication and t.n_physical == r.n_physical
    np.testing.assert_array_equal(t.slot_load, r.slot_load)
    np.testing.assert_array_equal(t.histogram, r.histogram)
    assert t.max_slot_load == r.max_slot_load and t.balance == r.balance
    assert t.n_physical == kw.get("pad_to", budget)


def test_plan_replication_refuses_small_budgets():
    for kw in (dict(slot_budget=7), dict(slot_budget=9, pad_to=7)):
        for mod in (rexp, texp):
            with pytest.raises(ValueError):
                mod.plan_replication(_pareto(8), **kw)


def test_profile_expert_histogram_matches_reference():
    # integer logits: many ties, which np.argsort orders the same way in both
    logits = np.random.default_rng(4).integers(-3, 4, (500, 16)).astype(np.float32)
    np.testing.assert_array_equal(texp.profile_expert_histogram(logits, 6),
                                  rexp.profile_expert_histogram(logits, 6))


@pytest.mark.parametrize("of", ["histogram", "plan"])
def test_expected_max_load_and_drop_rate_match_reference(of):
    hist = _pareto(160)
    r_arg = rexp.plan_replication(hist, 256) if of == "plan" else hist
    t_arg = texp.plan_replication(hist, 256) if of == "plan" else hist
    assert texp.expected_max_load(t_arg, 4096, 6) == rexp.expected_max_load(r_arg, 4096, 6)
    for cf in (1.0, 1.25):
        assert texp.drop_rate(t_arg, 4096, 6, cf) == rexp.drop_rate(r_arg, 4096, 6, cf)
    if of == "plan":  # the paper's relief, on the port's numbers
        assert texp.expected_max_load(t_arg, 4096, 6) < texp.expected_max_load(hist, 4096, 6)
        assert texp.drop_rate(t_arg, 4096, 6, 1.25) < texp.drop_rate(hist, 4096, 6, 1.25)


def test_expert_replication_table_matches_reference():
    for repl in ((1,) * 8, (2, 1, 1, 3, 1, 1, 1, 2)):
        got = tlay.expert_replication_table(repl)
        want = rlay.expert_replication_table(repl)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------------ MLA


def _mla_pair(seed=0):
    cfg = get_config(DSV2, smoke=True).with_(dtype="float32")
    rcfg = ref_config(DSV2, smoke=True).with_(dtype="float32")
    tree = rlay.init_mla(jax.random.PRNGKey(seed), rcfg)
    return rcfg, tree, cfg, _load(tlay.MLAttention(cfg), jax.tree.map(np.asarray, tree))


def test_mla_fwd_matches_reference():
    rcfg, tree, cfg, mod = _mla_pair()
    x = np.random.default_rng(0).normal(size=(BATCH, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (BATCH, 11))
    ry, rc = jax.jit(lambda p, x, pos: rlay.mla_fwd(p, rcfg, x, pos))(tree, jnp.asarray(x), jnp.asarray(pos))
    ty, tc = tlay.mla_fwd(mod, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    assert rc is None and tc is None and ty.shape == ry.shape
    assert _rel(ty, ry) <= LAYER_TOL


def test_mla_cache_prefill_then_decode_matches_reference():
    rcfg, tree, cfg, mod = _mla_pair(1)
    rng = np.random.default_rng(1)
    max_seq, s = 12, 9
    rc = rlay.init_mla_cache(rcfg, BATCH, max_seq, jnp.float32)
    tc = tlay.init_mla_cache(cfg, BATCH, max_seq, torch.float32, "cpu")
    fwd = jax.jit(lambda p, x, pos, c: rlay.mla_fwd(p, rcfg, x, pos, c))
    for start, n in ((0, s), (s, 1), (s + 1, 1)):
        x = rng.normal(size=(BATCH, n, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(start, start + n), (BATCH, n))
        ry, rc = fwd(tree, jnp.asarray(x), jnp.asarray(pos), rc)
        ty, tc = tlay.mla_fwd(mod, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()), tc)
        assert _rel(ty, ry) <= LAYER_TOL, (start, n)
        assert tc["len"] == int(rc["len"]) == start + n
        for k in ("ckv", "k_rope"):
            assert tc[k].shape == rc[k].shape
            assert _rel(tc[k], rc[k]) <= LAYER_TOL, k


# ------------------------------------------------------------------------ MoE


def _moe_pair(replication=(), dtype="float32", seed=0, **moe):
    rcfg = _with_replication(ref_config(DSV2, smoke=True).with_(dtype=dtype), replication, **moe)
    cfg = _with_replication(get_config(DSV2, smoke=True).with_(dtype=dtype), replication, **moe)
    tree = rlay.init_moe(jax.random.PRNGKey(seed), rcfg)
    return rcfg, tree, cfg, _load(tlay.MoE(cfg), jax.tree.map(np.asarray, tree))


def _ref_moe(tree, rcfg, x):
    return jax.jit(lambda p, x: rlay.moe_fwd(p, rcfg, x))(tree, jnp.asarray(x))


def _ref_bucket(tree, rcfg, xt, n_phys, cap):
    return jax.jit(lambda p, x: rlay._route_and_bucket(p, rcfg, x, n_phys, cap))(tree, jnp.asarray(xt))


def _x(cfg, n=24, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(BATCH, n, cfg.d_model)).astype(dtype)


@pytest.mark.parametrize("replication", [(), (2, 1, 1, 3, 1, 1, 1, 2)])
def test_moe_fwd_matches_reference_float32(replication):
    rcfg, tree, cfg, mod = _moe_pair(replication)
    x = _x(cfg)
    ry = _ref_moe(tree, rcfg, x)
    ty = tlay.moe_fwd(mod, cfg, torch.from_numpy(x))
    assert ty.shape == ry.shape and ty.dtype == torch.float32
    assert _rel(ty, ry) <= LAYER_TOL


@pytest.mark.parametrize("replication", [(), (2, 1, 1, 3, 1, 1, 1, 2)])
def test_bucket_state_equal_when_dropping(replication):
    rcfg, tree, cfg, mod = _moe_pair(replication, capacity_factor=0.5)
    x = _x(cfg, n=40, seed=1)
    n_phys = sum(replication) or cfg.moe.n_experts
    cap = tlay._moe_capacity(cfg, x.shape[0] * x.shape[1], n_phys)
    assert cap == rlay._moe_capacity(rcfg, x.shape[0] * x.shape[1], n_phys)
    xt = x.reshape(-1, cfg.d_model)
    rin, rstate = _ref_bucket(tree, rcfg, xt, n_phys, cap)
    tin, tstate = tlay._route_and_bucket(mod, cfg, torch.from_numpy(xt), n_phys, cap)
    assert not bool(tstate[2].all()), "the capacity must drop some assignments"
    for name, i in (("s_tok", 0), ("keep", 2), ("buf_idx", 3)):
        np.testing.assert_array_equal(tstate[i].numpy(), np.asarray(rstate[i]), err_msg=name)
    assert tstate[4] == int(rstate[4])
    np.testing.assert_allclose(tstate[1].numpy(), np.asarray(rstate[1]), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(rin))  # copies of the tokens
    ry = _ref_moe(tree, rcfg, x)
    ty = tlay.moe_fwd(mod, cfg, torch.from_numpy(x))
    assert _rel(ty, ry) <= LAYER_TOL


def test_router_ties_in_bf16_follow_reference():
    rcfg, tree, cfg, mod = _moe_pair(dtype="bfloat16", seed=2)
    router = np.asarray(tree["router"]).copy()
    router[:, 3] = router[:, 1]  # experts 1, 3 and 6 tie on every token
    router[:, 6] = router[:, 1]
    router[:, 5] = router[:, 0]
    tree = dict(tree, router=jnp.asarray(router))
    mod.router.data.copy_(torch.from_numpy(router))
    x = _x(cfg, n=32, seed=2).astype(jnp.bfloat16)
    xt = x.reshape(-1, cfg.d_model)
    with rlay.capture_routing() as rrec:  # eager: the reference records only then
        _, rstate = rlay._route_and_bucket(tree, rcfg, jnp.asarray(xt), 8, 64)
    with tlay.capture_routing() as trec:
        _, tstate = tlay._route_and_bucket(mod, cfg, torch.from_numpy(xt.astype(np.float32)).bfloat16(), 8, 64)
    assert len(rrec) == len(trec) == 1 and trec[0].dtype == rrec[0].dtype
    np.testing.assert_array_equal(trec[0], rrec[0])
    tied = np.isin(rrec[0], (1, 3, 6)).sum(axis=1) >= 2
    assert tied.mean() > 0.1, "the router must tie on a good share of the tokens"
    np.testing.assert_array_equal(tstate[0].numpy(), np.asarray(rstate[0]))
    np.testing.assert_allclose(tstate[1].numpy(), np.asarray(rstate[1]), rtol=1e-6, atol=0)
    ry = _ref_moe(tree, rcfg, x)
    ty = tlay.moe_fwd(mod, cfg, torch.from_numpy(x.astype(np.float32)).bfloat16())
    assert _rel(ty, np.asarray(ry, np.float32)) <= 2.0 ** -7


def _combine_inputs(seed=0):
    """A bf16 top-6 routing over 16 experts with replicas, at a capacity
    that drops, and random bf16 expert outputs: (reference state, port
    state, expert_out as numpy float32 holding bf16 values)."""
    base = get_config(DSV2, smoke=True)
    repl = (1, 2, 1, 1, 3, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1)
    moe = dict(n_experts=16, top_k=6, capacity_factor=0.75)
    rcfg = _with_replication(ref_config(DSV2, smoke=True), repl, **moe)
    cfg = _with_replication(base, repl, **moe)
    tree = rlay.init_moe(jax.random.PRNGKey(seed), rcfg)
    x = _x(cfg, n=50, seed=seed).reshape(-1, cfg.d_model).astype(jnp.bfloat16)
    n_phys = sum(repl)
    cap = rlay._moe_capacity(rcfg, x.shape[0], n_phys)
    _, rstate = _ref_bucket(tree, rcfg, x, n_phys, cap)
    out = np.random.default_rng(seed).normal(size=(n_phys, cap, cfg.d_model)).astype(jnp.bfloat16)
    tstate = tuple(torch.from_numpy(np.array(a)) for a in rstate[:4]) + (int(rstate[4]),)
    return rstate, tstate, out.astype(np.float32)


def test_combine_bf16_bit_equal_to_reference():
    rstate, tstate, out = _combine_inputs()
    assert not bool(tstate[2].all())
    want = jax.jit(lambda o, st: rlay._combine(o, (*st, tstate[4]), out.shape[-1]))(
        jnp.asarray(out, jnp.bfloat16), rstate[:4])
    got = tlay._combine(torch.from_numpy(out).bfloat16(), tstate, out.shape[-1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), np.asarray(want).view(np.int16))
    # the order matters: the sum in descending slot order differs somewhere
    s_tok, s_gate, keep, buf_idx, n_tok = tstate
    flat = torch.from_numpy(out).bfloat16().reshape(-1, out.shape[-1])
    contrib = torch.where(keep[:, None], flat[buf_idx.clamp(max=flat.shape[0] - 1)], 0) * s_gate[:, None].bfloat16()
    pos = torch.argsort(s_tok, stable=True).reshape(n_tok, -1)
    rev = torch.zeros_like(got)
    for j in reversed(range(pos.shape[1])):
        rev = rev + contrib[pos[:, j]]
    assert not np.array_equal(_bits(rev), _bits(got))


# ---------------------------------------------------------------- the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_combine_deterministic_on_card():
    _need_card()
    _, tstate, out = _combine_inputs(1)
    dev = torch.device("cuda")
    state = tuple(a.to(dev) for a in tstate[:4]) + (tstate[4],)
    eo = torch.from_numpy(out).bfloat16().to(dev)
    a = tlay._combine(eo, state, out.shape[-1]).cpu()
    b = tlay._combine(eo, state, out.shape[-1]).cpu()
    host = tlay._combine(torch.from_numpy(out).bfloat16(), tstate, out.shape[-1])
    np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(_bits(a), _bits(host))

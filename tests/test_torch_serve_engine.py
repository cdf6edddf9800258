"""The port's slot engine and batching counters against the reference's
``src/repro/serve``.

Slot engine, on the GLM-4-9B and Nemotron-4-15B SMOKE configs in float32
with the reference's ``lm.init_params`` parameters carried across: three
slots are prefilled one decode step at a time (``prefill_slot``), decode
greedily, one slot is handed to a new request (``reset_slots`` then
``prefill_slot`` under a slot mask) and all decode on.  Every step's logits
within 1e-4 of max |ref|, equal tokens and ``lens``, and the k/v caches
within 1e-4.  Nemotron's MLP runs K3's plain version on the host.

Scheduler: ``sample_lengths``, ``simulate_static``,
``simulate_continuous``, ``fabric_slot_plan`` and ``brownout_plan`` on
seeded inputs give the reference's results exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import lm as rlm
from repro.serve import engine as reng
from repro.serve import scheduler as rsch
from repro_torch import serve as tserve
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.serve import engine as teng
from repro_torch.serve import scheduler as tsch

SLOTS, MAX_SEQ, TOL = 3, 16, 1e-4


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", params=["glm4-9b", "nemotron-4-15b"])
def engines(request):
    """Run the same request schedule through both engines; returns the
    per-step (ref logits, port logits) pairs and both final states."""
    rcfg = ref_config(request.param, smoke=True).with_(dtype="float32")
    tcfg = get_config(request.param, smoke=True).with_(dtype="float32")
    rparams = rlm.init_params(rcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, rparams), tcfg, device="cpu")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, tcfg.vocab, (SLOTS, 5)).astype(np.int32)
    refill = rng.integers(0, tcfg.vocab, (SLOTS, 3)).astype(np.int32)
    rstep = jax.jit(reng.slot_decode_step, static_argnums=1)

    rs = reng.init_slot_state(rcfg, SLOTS, MAX_SEQ)
    ts = teng.init_slot_state(tcfg, SLOTS, MAX_SEQ, device="cpu")
    assert tuple(ts["k"].shape) == rs["k"].shape and ts["lens"].dtype == torch.int32
    pairs, tokens = [], []
    everyone = np.ones(SLOTS, bool)

    def prefill(toks, mask):
        nonlocal rs, ts
        rl, rs = reng.prefill_slot(rparams, rcfg, rs, jnp.asarray(toks), jnp.asarray(mask))
        tl, ts = teng.prefill_slot(model, tcfg, ts, torch.from_numpy(toks).long(), torch.from_numpy(mask))
        pairs.append((rl, tl))
        return rl, tl

    def decode(rl, tl, steps):
        nonlocal rs, ts
        for _ in range(steps):
            rtok, ttok = jnp.argmax(rl, -1), torch.argmax(tl, -1)
            tokens.append((np.asarray(rtok), ttok.numpy()))
            rl, rs = rstep(rparams, rcfg, rs, rtok)
            tl, ts = teng.slot_decode_step(model, tcfg, ts, ttok)
            pairs.append((rl, tl))
        return rl, tl

    rl, tl = decode(*prefill(prompt, everyone), 3)
    handed = np.array([False, True, False])
    rs = reng.reset_slots(rs, jnp.asarray(handed))
    ts = teng.reset_slots(ts, torch.from_numpy(handed))
    np.testing.assert_array_equal(ts["lens"].numpy(), np.asarray(rs["lens"]))
    decode(*prefill(refill, handed), 2)
    return pairs, tokens, rs, ts


def test_slot_engine_logits_match(engines):
    pairs, _, _, _ = engines
    assert len(pairs) == 7
    for rl, tl in pairs:
        assert tuple(tl.shape) == rl.shape
        assert _rel(tl, rl) <= TOL


def test_slot_engine_tokens_lens_and_caches_match(engines):
    _, tokens, rs, ts = engines
    for rtok, ttok in tokens:
        np.testing.assert_array_equal(ttok, rtok)
    np.testing.assert_array_equal(ts["lens"].numpy(), np.asarray(rs["lens"]))
    for k in ("k", "v"):
        assert _rel(ts[k], rs[k]) <= TOL, k


def test_slot_engine_refuses_other_families():
    with pytest.raises(ValueError, match="dense GQA"):
        teng.init_slot_state(get_config("zamba2-1.2b", smoke=True), 2, 8, device="cpu")
    assert set(tserve.__all__) == {
        "init_slot_state", "prefill_slot", "reset_slots", "slot_decode_step", "BatchingStats",
        "WorkloadConfig", "sample_lengths", "simulate_continuous", "simulate_static",
    }


@pytest.mark.parametrize("dist", ["lognormal", "uniform"])
@pytest.mark.parametrize("n_slots", [1, 8, 32])
def test_scheduler_matches_reference(dist, n_slots):
    wl = dict(n_requests=300, mean_len=64.0, dist=dist, sigma=0.9, seed=n_slots)
    lengths = tsch.sample_lengths(tsch.WorkloadConfig(**wl))
    np.testing.assert_array_equal(lengths, rsch.sample_lengths(rsch.WorkloadConfig(**wl)))
    for fn in ("simulate_static", "simulate_continuous"):
        got, want = getattr(tsch, fn)(lengths, n_slots), getattr(rsch, fn)(lengths, n_slots)
        assert (got.total_steps, got.slot_steps_used, got.slot_steps_alloc, got.mean_latency) == (
            want.total_steps, want.slot_steps_used, want.slot_steps_alloc, want.mean_latency)
        assert got.utilization == want.utilization and got.throughput == want.throughput


def test_slot_and_brownout_plans_match_reference():
    rng = np.random.default_rng(0)
    p99 = np.concatenate([[0.0], rng.random(20) * 2e4])
    for slo in (5e3, 1.5e4):
        np.testing.assert_array_equal(tsch.fabric_slot_plan(p99, slo, 32, 2),
                                      rsch.fabric_slot_plan(p99, slo, 32, 2))
        offered = np.concatenate([[0.0], rng.random(20) * 100])
        cap = rng.random(21) * 80
        np.testing.assert_array_equal(tsch.brownout_plan(offered, cap, p99, slo),
                                      rsch.brownout_plan(offered, cap, p99, slo))
    with pytest.raises(ValueError, match="slo_cycles"):
        tsch.fabric_slot_plan(p99, 0.0, 8)
    with pytest.raises(ValueError, match="min_admit_frac"):
        tsch.brownout_plan([1.0], [1.0], [1.0], 1.0, min_admit_frac=0.0)

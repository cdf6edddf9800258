"""Parity of the port's allocators, simulator and batch engine with the
reference, from one shared profile.

The contract is the reference's golden one: replica counts and
``arrays_used`` exactly equal, floats (img/s, layer cycles, layer
utilization) at rtol 1e-9; ``leftover`` of the batched greedy at 1e-12.
Profiles are shared by deriving both sides from the reference's capture,
which the derive parity tests hold bit-identical.
"""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core.cim as R
import repro_torch.core.cim as T
from repro.core.alloc import greedy as RG
from repro.dse import engine as RE
from repro_torch.convert import capture_from_numpy
from repro_torch.core.alloc import greedy as TG
from repro_torch.dse import engine as TE

CASES = {
    "vgg11": ("vgg11_cifar10", dict(n_images=2)),
    "resnet18": ("resnet18_imagenet", dict(n_images=1, sample_patches=128)),
}
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _x64_shim():
    """The reference imports ``jax.experimental.enable_x64``, which jax 0.9
    removed; provide it for this module only."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(
                jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False
            )
        yield


@pytest.fixture(scope="module", params=list(CASES))
def shared(request):
    fn, kw = CASES[request.param]
    rspec, tspec = getattr(R, fn)(), getattr(T, fn)()
    rcap = R.capture_activations(rspec, **kw)
    rprof = R.derive_profile(rcap, rspec)
    tprof = T.derive_profile(capture_from_numpy(rcap, device="cpu"), tspec)
    return rspec, rprof, tspec, tprof


def _units(seed, n, ties=False):
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 40, n).astype(np.float64) * 64.0 if ties else rng.random(n) * 1e4
    cost = rng.integers(1, 9, n).astype(np.float64)
    return base, cost


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_allocate_equal(seed, ties):
    base, cost = _units(seed, 60, ties)
    for budget in (0.0, 7.0, 250.0, 3000.0):
        r = RG.greedy_allocate(base, cost, budget)
        t = TG.greedy_allocate(base, cost, budget)
        np.testing.assert_array_equal(t.replicas, r.replicas)
        np.testing.assert_array_equal(t.latency, r.latency)
        assert (t.spent, t.leftover) == (r.spent, r.leftover)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_greedy_allocate_batch_equal(ties, warm):
    base, cost = _units(7, 80, ties)
    budgets = np.array([0.0, 1.0, 13.0, 200.0, 999.0, 5000.0])
    r0 = np.random.default_rng(3).integers(1, 4, 80) if warm else None
    r = RG.greedy_allocate_batch(base, cost, budgets, initial_replicas=r0)
    t = TG.greedy_allocate_batch(base, cost, budgets, initial_replicas=r0, device="cpu")
    np.testing.assert_array_equal(t.replicas.numpy(), r.replicas)
    np.testing.assert_allclose(t.leftover.numpy(), r.leftover, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.spent.numpy(), r.spent, rtol=1e-12)
    np.testing.assert_allclose(t.makespan.numpy(), r.makespan, rtol=1e-12)
    for i, b in enumerate(budgets):  # and the scalar heap loop
        s = TG.greedy_allocate(base, cost, b, initial_replicas=r0)
        np.testing.assert_array_equal(t.replicas[i].numpy(), s.replicas)


def test_proportional_allocate_equal():
    base, cost = _units(11, 20)
    budgets = np.array([-1.0, 0.0, 5.0, 77.0, 400.0])
    r = RG.proportional_allocate_batch(base, cost, budgets)
    t = TG.proportional_allocate_batch(base, cost, budgets)
    np.testing.assert_array_equal(t.replicas.numpy(), r.replicas)
    np.testing.assert_array_equal(t.leftover.numpy(), r.leftover)
    for i, b in enumerate(budgets):
        rs, ts = RG.proportional_allocate(base, cost, b), TG.proportional_allocate(base, cost, b)
        np.testing.assert_array_equal(ts.replicas, rs.replicas)
        np.testing.assert_array_equal(t.replicas[i].numpy(), rs.replicas)


def _assert_alloc_equal(ta, ra):
    assert ta.policy == ra.policy
    assert (ta.arrays_used, ta.arrays_total) == (ra.arrays_used, ra.arrays_total)
    if ra.layer_dups is None:
        assert ta.layer_dups is None
        for a, b in zip(ta.block_dups, ra.block_dups, strict=True):
            np.testing.assert_array_equal(a, b)
    else:
        assert ta.block_dups is None
        np.testing.assert_array_equal(ta.layer_dups, ra.layer_dups)


def _assert_sim_close(ts, rs):
    assert ts.arrays_used == rs.arrays_used
    np.testing.assert_allclose(ts.images_per_sec, rs.images_per_sec, rtol=RTOL)
    np.testing.assert_allclose(ts.total_cycles, rs.total_cycles, rtol=RTOL)
    np.testing.assert_allclose(ts.layer_cycles.numpy(), rs.layer_cycles, rtol=RTOL)
    np.testing.assert_allclose(ts.layer_utilization.numpy(), rs.layer_utilization, rtol=RTOL)


@pytest.mark.parametrize("policy", list(R.POLICIES))
def test_allocate_and_simulate_equal(shared, policy):
    rspec, rprof, tspec, tprof = shared
    assert tuple(T.POLICIES) == tuple(R.POLICIES)
    for mult in (1, 2, 4):
        pes = rspec.min_pes() * mult
        ra, ta = R.allocate(rspec, rprof, policy, pes), T.allocate(tspec, tprof, policy, pes)
        _assert_alloc_equal(ta, ra)
        _assert_sim_close(T.simulate(tspec, tprof, ta), R.simulate(rspec, rprof, ra))
        _assert_sim_close(
            T.run_policy(tspec, tprof, policy, pes, n_images=8),
            R.run_policy(rspec, rprof, policy, pes, n_images=8),
        )
    budget = 37.0
    _assert_alloc_equal(
        T.allocate(tspec, tprof, policy, pes, free_budget=budget),
        R.allocate(rspec, rprof, policy, pes, free_budget=budget),
    )


def test_batch_simulator_equals_scalar(shared):
    _, _, tspec, tprof = shared
    allocs = [T.allocate(tspec, tprof, p, tspec.min_pes() * 3) for p in T.POLICIES]
    scalar = [T.simulate(tspec, tprof, a, n_images=16) for a in allocs]
    batch = TE.allocate_batch(tspec, tprof, list(T.POLICIES), tspec.min_pes() * 3)
    res = T.BatchSimulator(tspec, tprof)(batch.dups_lb, batch.layerwise, batch.zskip, n_images=16)
    for i, (a, s) in enumerate(zip(allocs, scalar)):
        _assert_alloc_equal(TE.to_allocation(batch, i, tspec), a)
        np.testing.assert_allclose(float(res.images_per_sec[i]), s.images_per_sec, rtol=RTOL)
        np.testing.assert_allclose(res.layer_cycles[i].numpy(), s.layer_cycles.numpy(), rtol=RTOL)
        np.testing.assert_allclose(res.layer_utilization[i].numpy(), s.layer_utilization.numpy(), rtol=RTOL)


def test_run_batch_equals_reference(shared):
    rspec, rprof, tspec, tprof = shared
    pes = rspec.min_pes() + np.arange(0, 6 * rspec.min_pes(), max(1, rspec.min_pes() // 3))
    policies = np.repeat(np.array(R.POLICIES, dtype=object), pes.size)
    n_pes = np.tile(pes, len(R.POLICIES))
    ra, rr = RE.run_batch(rspec, rprof, policies, n_pes, n_images=32)
    ta, tr = TE.run_batch(tspec, tprof, policies, n_pes, n_images=32)
    np.testing.assert_array_equal(ta.dups_lb.numpy(), ra.dups_lb)
    np.testing.assert_array_equal(ta.arrays_used, ra.arrays_used)
    np.testing.assert_array_equal(ta.layerwise, ra.layerwise)
    np.testing.assert_array_equal(ta.zskip, ra.zskip)
    np.testing.assert_allclose(tr.images_per_sec.numpy(), rr.images_per_sec, rtol=RTOL)
    np.testing.assert_allclose(tr.total_cycles.numpy(), rr.total_cycles, rtol=RTOL)
    np.testing.assert_allclose(tr.layer_cycles.numpy(), rr.layer_cycles, rtol=RTOL)
    np.testing.assert_allclose(tr.layer_utilization.numpy(), rr.layer_utilization, rtol=RTOL)


def test_flat_unit_map_equal():
    spec = T.resnet18_imagenet()
    table = spec.block_table()
    L, B = len(spec.layers), max(l.n_blocks for l in spec.layers)
    np.testing.assert_array_equal(TE.flat_unit_map(L, B), RE.flat_unit_map(L, B))
    np.testing.assert_array_equal(
        TE.flat_unit_map(L, B, table[:, 0], table[:, 1]),
        RE.flat_unit_map(L, B, table[:, 0], table[:, 1]),
    )


def test_unported_and_invalid_policies_raise(shared):
    _, _, tspec, tprof = shared
    with pytest.raises(ValueError, match="unknown policies"):
        TE.run_batch(tspec, tprof, ["nope"], tspec.min_pes() * 2)
    with pytest.raises(ValueError, match="minimum"):
        T.allocate(tspec, tprof, "blockwise", tspec.min_pes() - 1)
    with pytest.raises(ValueError, match="dups_lb"):
        T.BatchSimulator(tspec, tprof)(torch.ones(2, 3, 4), [True, True], [True, True])


def test_reference_keywords_take_their_defaults(shared):
    """``greedy_allocate``'s ``spare_fraction`` / ``audit`` and ``allocate``'s
    ``audit``: the reference's defaults give the reference's result, and so
    do other values (a hot-spare reserve, a decision log; refused by name
    before the multi-chip slice ported them)."""
    import repro.obs as RO
    from repro_torch.obs import AllocationAudit

    rspec, rprof, tspec, tprof = shared
    base, cost = _units(3, 40)
    want = RG.greedy_allocate(base, cost, 100.0)
    got = TG.greedy_allocate(base, cost, 100.0, spare_fraction=0.0, audit=None)
    np.testing.assert_array_equal(got.replicas, want.replicas)
    assert got.leftover == want.leftover
    ra, ta = RO.AllocationAudit(), AllocationAudit()
    want = RG.greedy_allocate(base, cost, 100.0, spare_fraction=0.25, audit=ra)
    got = TG.greedy_allocate(base, cost, 100.0, spare_fraction=0.25, audit=ta)
    np.testing.assert_array_equal(got.replicas, want.replicas)
    assert (got.spent, got.leftover) == (want.spent, want.leftover)
    assert ta.to_json() == ra.to_json()
    pes = tspec.min_pes() * 2
    a = T.allocate(tspec, tprof, "blockwise", pes, offered_ips=None, load_frac=0.7, audit=None)
    r = R.allocate(rspec, rprof, "blockwise", pes)
    assert a.arrays_used == r.arrays_used
    ra, ta = RO.AllocationAudit(), AllocationAudit()
    R.allocate(rspec, rprof, "blockwise", pes, audit=ra)
    T.allocate(tspec, tprof, "blockwise", pes, audit=ta)
    assert [(e.kind, e.unit, e.cost) for e in ta.entries] == [(e.kind, e.unit, e.cost) for e in ra.entries]

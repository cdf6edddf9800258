"""The port's multi-chip topology, placed allocators, spares, audit, stage
partitioning and placed tenancy against the reference, on the host.

Inputs: VGG11 from the reference's capture (1 image, 64 samples, through
``convert.capture_from_numpy`` and the port's derive); random unit
problems from seeded numpy generators.  Tolerances:

  * discrete outputs exactly equal: replica counts, replica -> chip
    placements, mandatory homes, stage sources, ``n_crossings``, per-chip
    arrays, audit entries, stage partitions;
  * float64 outputs (stage transfers, latencies, leftovers) at rtol 1e-12;
  * completions of the placed fabric engines bit-identical.
"""

import importlib

import numpy as np
import pytest

import repro_torch as T
import repro_torch.fabric as TF
from repro_torch.core.alloc import greedy as TG
from repro_torch.core.alloc.pipeline_stages import bottleneck, partition_stages, stage_costs
from repro_torch.core.cim import topology as TT
from repro_torch.obs import AllocationAudit

CLOCK_HZ = 1e8
RTOL = 1e-12
POLICIES = ("baseline", "weight_based", "weight_blockflow", "perf_layerwise", "blockwise", "latency_aware")


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.experimental

    with pytest.MonkeyPatch.context() as mp:
        # the reference imports jax.experimental.enable_x64, which jax 0.9
        # removed; provide it for this module only
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(
                jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False
            )
        yield (importlib.import_module("repro.core.cim"), importlib.import_module("repro.fabric"),
               importlib.import_module("repro.core.cim.topology"),
               importlib.import_module("repro.core.alloc.greedy"))


@pytest.fixture(scope="module")
def vgg(ref):
    from repro_torch.convert import capture_from_numpy

    R = ref[0]
    rspec, tspec = R.vgg11_cifar10(), T.vgg11_cifar10()
    rcap = R.capture_activations(rspec, n_images=1, sample_patches=64)
    rprof = R.derive_profile(rcap, rspec)
    tprof = T.derive_profile(capture_from_numpy(rcap, device="cpu"), tspec)
    return rspec, rprof, tspec, tprof


def _total(spec, n_chips):
    pes = spec.min_pes() * 2
    return pes + (-pes) % n_chips


def _assert_placement(a, b):
    np.testing.assert_array_equal(a.layer_src, b.layer_src)
    for x, y in zip(a.mandatory_chips, b.mandatory_chips):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.replica_chips, b.replica_chips):
        if isinstance(x, tuple):
            assert isinstance(y, tuple) and len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(b.stage_transfer, a.stage_transfer, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(b.chip_arrays, a.chip_arrays)
    assert a.n_crossings == b.n_crossings
    assert a.max_stage_transfer == pytest.approx(b.max_stage_transfer, rel=RTOL)


def _assert_alloc(a, b):
    assert (a.policy, a.arrays_used, a.arrays_total) == (b.policy, b.arrays_used, b.arrays_total)
    if a.layer_dups is not None:
        np.testing.assert_array_equal(a.layer_dups, b.layer_dups)
    else:
        for x, y in zip(a.block_dups, b.block_dups):
            np.testing.assert_array_equal(x, y)


def _assert_audit(a, b):
    assert a.to_json() == b.to_json()
    assert a.summary() == b.summary()


# ----------------------------------------------------------- cost model
@pytest.mark.parametrize("n_chips,link", [(1, 64.0), (2, 16.0), (4, 256.0), (8, 8.0)])
def test_topology_cost_model_matches(ref, n_chips, link):
    R, _, RT, _ = ref
    a = RT.FabricTopology.split(n_chips, 8 * 16, link_gbps=link)
    b = TT.FabricTopology.split(n_chips, 8 * 16, link_gbps=link)
    assert (a.arrays_per_chip, a.total_pes, a.total_arrays) == (b.arrays_per_chip, b.total_pes, b.total_arrays)
    assert (a.link_bytes_per_cycle, a.hop_latency_cycles) == (b.link_bytes_per_cycle, b.hop_latency_cycles)
    assert a.spares_per_chip(0.3) == b.spares_per_chip(0.3)
    for src in range(n_chips):
        np.testing.assert_array_equal(a.transfer_matrix(src, 12345.0), b.transfer_matrix(src, 12345.0))
    rspec, tspec = R.vgg11_cifar10(), T.vgg11_cifar10()
    for la, lb in zip(rspec.layers, tspec.layers):
        assert RT.request_bytes(la) == TT.request_bytes(lb)
    with pytest.raises(ValueError):
        TT.FabricTopology.split(3, 8)
    with pytest.raises(ValueError):
        TT.FabricTopology(pes_per_chip=4, link_gbps=0.0)


# ------------------------------------------------------- placed allocation
@pytest.mark.parametrize("n_chips", [1, 2, 4])
@pytest.mark.parametrize("policy", POLICIES)
def test_allocate_placed_matches_reference(ref, vgg, policy, n_chips):
    """Counts, placements, transfers, per-chip loads and the placed
    greedy's audit (with the chip of every grant) equal the reference's."""
    _, _, RT, _ = ref
    obs = importlib.import_module("repro.obs")
    rspec, rprof, tspec, tprof = vgg
    total = _total(tspec, n_chips)
    kw = {"offered_ips": 4000.0} if policy == "latency_aware" else {}
    ra, ta = obs.AllocationAudit(), AllocationAudit()
    a = RT.allocate_placed(rspec, rprof, policy, RT.FabricTopology.split(n_chips, total, link_gbps=16.0),
                           audit=ra, **kw)
    b = TT.allocate_placed(tspec, tprof, policy, TT.FabricTopology.split(n_chips, total, link_gbps=16.0),
                           audit=ta, **kw)
    _assert_alloc(a.allocation, b.allocation)
    _assert_placement(a.placement, b.placement)
    _assert_audit(ra, ta)
    assert (len(ta) > 0) == (policy in ("perf_layerwise", "blockwise"))
    assert b.placement.chip_arrays.sum() == b.allocation.arrays_used
    if n_chips == 1:  # the flat allocator is the one-chip special case
        _assert_alloc(T.allocate(tspec, tprof, policy, total, **kw), b.allocation)
        assert b.placement.n_crossings == 0 and b.placement.max_stage_transfer == 0.0


@pytest.mark.parametrize("strategy", ["locality", "stripe"])
def test_place_allocation_matches_reference(ref, vgg, strategy):
    R, _, RT, _ = ref
    rspec, rprof, tspec, tprof = vgg
    total = _total(tspec, 4)
    free = 4 * (total // 4) * 64 - tspec.n_arrays
    for pol in ("blockwise", "perf_layerwise"):
        fa = R.allocate(rspec, rprof, pol, total, free_budget=int(free * 0.7))
        fb = T.allocate(tspec, tprof, pol, total, free_budget=int(free * 0.7))
        _assert_alloc(fa, fb)
        a = RT.place_allocation(rspec, fa, RT.FabricTopology.split(4, total, link_gbps=32.0), strategy=strategy)
        b = TT.place_allocation(tspec, fb, TT.FabricTopology.split(4, total, link_gbps=32.0), strategy=strategy)
        _assert_placement(a, b)
    with pytest.raises(ValueError):
        TT.place_allocation(tspec, fb, TT.FabricTopology.split(4, total), strategy="nope")
    with pytest.raises(ValueError):
        TT.allocate_placed(tspec, tprof, "blockwise", TT.FabricTopology.split(2, 2))


def test_stage_transfer_matrix_matches(ref, vgg):
    _, _, RT, _ = ref
    rspec, rprof, tspec, tprof = vgg
    total = _total(tspec, 4)
    pr = [RT.allocate_placed(rspec, rprof, "blockwise", RT.FabricTopology.split(c, total, link_gbps=16.0)).placement
          for c in (1, 2, 4)]
    pt = [TT.allocate_placed(tspec, tprof, "blockwise", TT.FabricTopology.split(c, total, link_gbps=16.0)).placement
          for c in (1, 2, 4)]
    np.testing.assert_array_equal(TT.stage_transfer_matrix(pt), RT.stage_transfer_matrix(pr))


def test_placed_fabric_engines_bit_identical(ref, vgg):
    """At 4 chips with transfer delays: the port's ``FabricSim(placement=)``
    and VT (its plain version here) equal the reference's event engine."""
    _, RF, RT, _ = ref
    rspec, rprof, tspec, tprof = vgg
    total = _total(tspec, 4)
    ra = [RT.allocate_placed(rspec, rprof, p, RT.FabricTopology.split(4, total, link_gbps=16.0), **kw)
          for p, kw in (("blockwise", {}), ("latency_aware", {"offered_ips": 4000.0}))]
    ta = [TT.allocate_placed(tspec, tprof, p, TT.FabricTopology.split(4, total, link_gbps=16.0), **kw)
          for p, kw in (("blockwise", {}), ("latency_aware", {"offered_ips": 4000.0}))]
    assert all(p.placement.stage_transfer.max() > 0 for p in ta)
    rp, tp = RF.PoissonOpen(20, 4000.0 / CLOCK_HZ, seed=11), TF.PoissonOpen(20, 4000.0 / CLOCK_HZ, seed=11)
    vt = TF.VirtualTimeFabric(tspec, tprof, device="cpu")
    res = vt.run_batch([p.allocation for p in ta], tp, seed=3, placements=[p.placement for p in ta])
    for k, (a, b) in enumerate(zip(ra, ta)):
        want = RF.FabricSim(rspec, rprof, a.allocation, seed=3, placement=a.placement).run(rp)
        got = TF.FabricSim(tspec, tprof, b.allocation, seed=3, placement=b.placement).run(tp)
        np.testing.assert_array_equal(got.completions, want.completions)
        np.testing.assert_array_equal(res.completions[k], want.completions)


# ------------------------------------------------------ greedy: unit level
def _unit_problem(seed, n=12, k=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(100, 5000, n).astype(np.float64)
    cost = rng.integers(1, 9, n).astype(np.float64)
    home = rng.integers(0, k, n)
    pen = rng.random((n, k)) * 500.0
    pen[np.arange(n), home] = 0.0
    free = rng.integers(20, 80, k).astype(np.float64)
    return base, cost, home, pen, free


@pytest.mark.parametrize("seed", range(4))
def test_greedy_placed_release_extras_match(ref, seed):
    """``greedy_allocate_placed`` (with warm start and audit),
    ``place_extras`` and ``greedy_release`` on random unit problems."""
    _, _, _, RG = ref
    obs = importlib.import_module("repro.obs")
    base, cost, home, pen, free = _unit_problem(seed)
    init = np.where(np.arange(base.size) % 3 == 0, 2, 1)
    ra, ta = obs.AllocationAudit(), AllocationAudit()
    kw = dict(home_chip=home, unit_penalty=pen, chip_free=free)
    a = RG.greedy_allocate_placed(base, cost, 150.0, initial_replicas=init, audit=ra, **kw)
    b = TG.greedy_allocate_placed(base, cost, 150.0, initial_replicas=init, audit=ta, **kw)
    np.testing.assert_array_equal(a.replicas, b.replicas)
    for x, y in zip(a.replica_chips, b.replica_chips):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.penalty, b.penalty)
    np.testing.assert_allclose(b.latency, a.latency, rtol=RTOL)
    assert (a.spent, a.leftover) == (b.spent, b.leftover)
    _assert_audit(ra, ta)
    reps = np.minimum(a.replicas, 3)
    for x, y in zip(RG.place_extras(reps, cost, **kw), TG.place_extras(reps, cost, **kw)):
        np.testing.assert_array_equal(x, y)
    for release in (0.0, 7.0, 40.0, 1e9):
        a2 = RG.greedy_release(base, cost, release, replicas=a.replicas)
        b2 = TG.greedy_release(base, cost, release, replicas=a.replicas)
        np.testing.assert_array_equal(a2.replicas, b2.replicas)
        assert (a2.spent, a2.leftover) == (b2.spent, b2.leftover)


@pytest.mark.parametrize("spare", [0.0, 0.1, 0.37])
def test_greedy_spares_and_audit_match(ref, spare):
    _, _, _, RG = ref
    obs = importlib.import_module("repro.obs")
    base, cost, *_ = _unit_problem(7, n=20)
    ra, ta = obs.AllocationAudit(), AllocationAudit()
    a = RG.greedy_allocate(base, cost, 200.0, spare_fraction=spare, audit=ra)
    b = TG.greedy_allocate(base, cost, 200.0, spare_fraction=spare, audit=ta)
    np.testing.assert_array_equal(a.replicas, b.replicas)
    assert (a.spent, a.leftover) == (b.spent, b.leftover)
    _assert_audit(ra, ta)
    assert ta.stop_reason == "budget"
    with pytest.raises(ValueError, match="spare_fraction"):
        TG.greedy_allocate(base, cost, 200.0, spare_fraction=1.5)


@pytest.mark.parametrize("policy", ["perf_layerwise", "blockwise", "baseline"])
def test_allocate_audit_matches(ref, vgg, policy):
    """``allocate(audit=)`` logs the greedy policies' grants as the
    reference's does; the proportional ones leave it empty."""
    R = ref[0]
    obs = importlib.import_module("repro.obs")
    rspec, rprof, tspec, tprof = vgg
    ra, ta = obs.AllocationAudit(), AllocationAudit()
    a = R.allocate(rspec, rprof, policy, rspec.min_pes() * 2, audit=ra)
    b = T.allocate(tspec, tprof, policy, tspec.min_pes() * 2, audit=ta)
    _assert_alloc(a, b)
    assert [(e.step, e.kind, e.unit, e.cost, e.remaining) for e in ra.entries] == \
        [(e.step, e.kind, e.unit, e.cost, e.remaining) for e in ta.entries]
    for x, y in zip(ra.entries, ta.entries):
        np.testing.assert_allclose([y.latency_before, y.latency_after], [x.latency_before, x.latency_after],
                                   rtol=RTOL)
    assert (len(ta) == 0) == (policy == "baseline")


def test_repack_falls_back_to_greedy_chips():
    """The reference's near-full case: the dataflow-order re-pack cannot
    place what the greedy certified, so the greedy's chips are kept."""
    base, cost = np.array([9.0, 10.0]), np.array([4.0, 8.0])
    home, free, pen = np.array([0, 1]), np.array([8.0, 4.0]), np.zeros((2, 2))
    res = TG.greedy_allocate_placed(base, cost, 12.0, home_chip=home, unit_penalty=pen, chip_free=free)
    np.testing.assert_array_equal(res.replicas, [2, 2])
    with pytest.raises(ValueError):
        TG.place_extras(res.replicas, cost, home_chip=home, unit_penalty=pen, chip_free=free)
    out = TT._repack_or_keep(res, cost, home=home, pen=pen, chip_free=free)
    assert [c.tolist() for c in out] == [c.tolist() for c in res.replica_chips]


# ------------------------------------------------------- stage partitions
@pytest.mark.parametrize("seed", range(3))
def test_partition_stages_matches(seed):
    ps = importlib.import_module("repro.core.alloc.pipeline_stages")
    rng = np.random.default_rng(seed)
    costs = np.exp(rng.normal(0, 0.8, size=16))
    edge = rng.random(16) * 2.0
    for n_stages in (1, 3, 4, 7):
        for e in (None, edge):
            want = ps.partition_stages(costs, n_stages, edge_cost=e)
            got = partition_stages(costs, n_stages, edge_cost=e)
            assert got == want
            np.testing.assert_array_equal(stage_costs(costs, got), ps.stage_costs(costs, want))
            assert bottleneck(costs, got) == ps.bottleneck(costs, want)
    out = partition_stages(np.array([10.0, 10.0]), 2, edge_cost=np.array([0.0, 100.0]))
    assert out == [(0, 2), (2, 2)]


# ------------------------------------------------------- placed tenancy
def test_tenancy_topology_placement_matches(ref, vgg):
    """``allocate_shared(topology=)``: per-tenant counts and placements, the
    tenants' event-engine runs and the fairness report equal the
    reference's; a budget that disagrees with the topology raises."""
    _, RF, RT, _ = ref
    rspec, rprof, tspec, tprof = vgg
    n_pes = -(-2 * tspec.n_arrays // 64) * 2
    n_pes += (-n_pes) % 2
    rts = [RF.Tenant("prio", rspec, rprof, weight=2.0), RF.Tenant("batch", rspec, rprof, weight=1.0)]
    tts = [TF.Tenant("prio", tspec, tprof, weight=2.0), TF.Tenant("batch", tspec, tprof, weight=1.0)]
    a = RF.allocate_shared(rts, n_pes=n_pes, topology=RT.FabricTopology.split(2, n_pes, link_gbps=32.0))
    b = TF.allocate_shared(tts, n_pes=n_pes, topology=TT.FabricTopology.split(2, n_pes, link_gbps=32.0))
    assert (a.arrays_total, a.arrays_used) == (b.arrays_total, b.arrays_used)
    for x, y in zip(a.allocations, b.allocations):
        _assert_alloc(x, y)
    for x, y in zip(a.placements, b.placements):
        _assert_placement(x, y)
    ra = RF.run_tenants(a, [RF.ClosedLoop(12, 6), RF.ClosedLoop(12, 6)], seed=0)
    rb = TF.run_tenants(b, [TF.ClosedLoop(12, 6), TF.ClosedLoop(12, 6)], seed=0)
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x.completions, y.completions)
    assert RF.fairness_report(a, ra) == TF.fairness_report(b, rb)
    with pytest.raises(ValueError):
        TF.allocate_shared(tts, n_pes=n_pes, topology=TT.FabricTopology.split(2, n_pes + 2))

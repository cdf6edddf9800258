"""Parity of the port's latency-aware allocation with the reference: the
queueing model (``erlang_c``, ``queueing_delay``), the tail-weighted greedy
(``queueing_allocate``), ``allocate(..., "latency_aware")`` and the
fabric-oracle flow (``provision_latency_aware``, ``refine_latency_aware``,
the port's ``engine="torch"`` on the CPU against the reference's numpy
engine).

All of it is float64 numpy on the host in both packages, so the contract is
equality: replica counts, arrays used, the delay scores and the waits.  The
profiles come from the reference's VGG11 capture (1 image, 64 samples)
through ``convert.capture_from_numpy`` and the port's derive.
"""

import jax
import jax.experimental
import numpy as np
import pytest

import repro.core.cim as R
import repro.fabric as RF
import repro_torch.core.cim as T
import repro_torch.fabric as TF
from repro.core.alloc import greedy as RG
from repro_torch.convert import capture_from_numpy
from repro_torch.core.alloc import greedy as TG

CLOCK_HZ = 1e8


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


@pytest.fixture(scope="module")
def vgg():
    rspec, tspec = R.vgg11_cifar10(), T.vgg11_cifar10()
    rcap = R.capture_activations(rspec, n_images=1, sample_patches=64)
    rprof = R.derive_profile(rcap, rspec)
    tprof = T.derive_profile(capture_from_numpy(rcap, device="cpu"), tspec)
    return rspec, rprof, tspec, tprof


def _same_alloc(r, t):
    assert (t.policy, t.arrays_used, t.arrays_total) == (r.policy, r.arrays_used, r.arrays_total)
    for a, b in zip(r.block_dups, t.block_dups, strict=True):
        np.testing.assert_array_equal(b, a)


def _units(seed, n):
    """Random queueing units: job rates, mean services, service scv, costs,
    request batches and groups, with loads from light to saturated."""
    rng = np.random.default_rng(seed)
    s = rng.integers(5, 400, n).astype(np.float64)
    lam = rng.uniform(0.05, 1.4, n) / s
    scv = rng.uniform(0.0, 1.5, n)
    cost = rng.integers(1, 9, n).astype(np.float64)
    batch = rng.integers(1, 200, n).astype(np.float64)
    group = np.sort(rng.integers(0, max(1, n // 3), n))
    return lam, s, scv, cost, batch, group


@pytest.mark.parametrize("seed", range(4))
def test_erlang_c_and_queueing_delay_equal(seed):
    lam, s, scv, _, batch, _ = _units(seed, 64)
    reps = np.random.default_rng(seed + 10).integers(1, 40, 64)
    np.testing.assert_array_equal(TG.erlang_c(reps, lam * s), RG.erlang_c(reps, lam * s))
    for ca2 in (1.0, batch):
        np.testing.assert_array_equal(
            TG.queueing_delay(reps, lam, s, scv, arrival_scv=ca2),
            RG.queueing_delay(reps, lam, s, scv, arrival_scv=ca2),
        )
    with pytest.raises(ValueError, match="replica"):
        TG.erlang_c(np.zeros(2, np.int64), np.ones(2))


@pytest.mark.parametrize(
    "seed,kw",
    [
        (0, {}),
        (1, {"grouped": True}),
        (2, {"grouped": True, "tail_weight": 2.0}),
        (3, {"grouped": True, "warm": True}),
        (4, {"grouped": True, "extra": True}),
        (5, {"budget": 0.0}),
    ],
)
def test_queueing_allocate_equal(seed, kw):
    lam, s, scv, cost, batch, group = _units(seed, 40)
    args = dict(batch_size=batch)
    if kw.get("grouped"):
        args["group"] = group
    if "tail_weight" in kw:
        args["tail_weight"] = kw["tail_weight"]
    if kw.get("warm"):
        args["initial_replicas"] = np.random.default_rng(seed).integers(1, 4, 40)
    if kw.get("extra"):
        args["extra_delay"] = np.random.default_rng(seed).random(40) * 500.0
    budget = kw.get("budget", 400.0)
    want = RG.queueing_allocate(lam, s, scv, cost, budget, **args)
    got = TG.queueing_allocate(lam, s, scv, cost, budget, **args)
    np.testing.assert_array_equal(got.replicas, want.replicas)
    np.testing.assert_array_equal(got.latency, want.latency)
    assert (got.spent, got.leftover) == (want.spent, want.leftover)


def test_queueing_allocate_validation():
    lam, s, scv, cost, _, _ = _units(0, 4)
    with pytest.raises(ValueError, match="shape"):
        TG.queueing_allocate(lam, s[:3], scv, cost, 10.0)
    with pytest.raises(ValueError, match="positive"):
        TG.queueing_allocate(lam, s, scv, cost * 0.0, 10.0)


@pytest.mark.parametrize("mult", [1.2, 2.0, 4.0])
@pytest.mark.parametrize("load", ["offered", "load_frac"])
def test_allocate_latency_aware_equal(vgg, mult, load):
    """``allocate(..., "latency_aware")`` at an explicit offered load or at
    ``load_frac`` of the blockwise img/s (the default 0.7 and 0.4)."""
    rspec, rprof, tspec, tprof = vgg
    pes = int(np.ceil(tspec.min_pes() * mult))
    if load == "offered":
        cap = R.simulate(rspec, rprof, R.allocate(rspec, rprof, "blockwise", pes)).images_per_sec
        kws = [dict(offered_ips=f * cap) for f in (0.3, 0.85)]
    else:
        kws = [{}, dict(load_frac=0.4)]
    for kw in kws:
        _same_alloc(R.allocate(rspec, rprof, "latency_aware", pes, **kw),
                    T.allocate(tspec, tprof, "latency_aware", pes, **kw))
    with pytest.raises(ValueError, match="positive"):
        T.allocate(tspec, tprof, "latency_aware", pes, offered_ips=0.0)


def test_queueing_inputs_equal(vgg):
    from repro.core.cim.simulate import _layer_patch_cycles as r_cycles
    from repro.core.cim.simulate import _queueing_inputs as r_inputs
    from repro_torch.core.cim.simulate import _layer_patch_cycles as t_cycles
    from repro_torch.core.cim.simulate import _queueing_inputs as t_inputs

    rspec, rprof, tspec, tprof = vgg
    for z in (False, True):
        for a, b in zip(r_cycles(rprof, z), t_cycles(tprof, z), strict=True):
            np.testing.assert_array_equal(b, a)
    for a, b in zip(r_inputs(rspec, r_cycles(rprof, True), 1e-4),
                    t_inputs(tspec, t_cycles(tprof, True), 1e-4), strict=True):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("load_frac", [0.3, 0.7])
def test_provision_latency_aware_equal(vgg, load_frac):
    """The calibrated pick between blockwise and the queueing allocation,
    then two fabric-oracle grants: the port's VT plain version on the CPU
    against the reference's numpy engine."""
    rspec, rprof, tspec, tprof = vgg
    pes = tspec.min_pes() * 2
    kw = dict(load_frac=load_frac, calib_requests=24, grants=2)
    want = RF.provision_latency_aware(rspec, rprof, pes, engine="numpy", **kw)
    got = TF.provision_latency_aware(tspec, tprof, pes, engine="torch", device="cpu", **kw)
    _same_alloc(want, got)


def test_refine_latency_aware_equal(vgg):
    rspec, rprof, tspec, tprof = vgg
    pes = tspec.min_pes() * 2
    ra = R.allocate(rspec, rprof, "blockwise", pes, free_budget=2000.0)
    ta = T.allocate(tspec, tprof, "blockwise", pes, free_budget=2000.0)
    cap = R.simulate(rspec, rprof, ra).images_per_sec
    procs = [m.PoissonOpen(20, 0.5 * cap / CLOCK_HZ, seed=11) for m in (RF, TF)]
    kw = dict(grants=3, candidates=6, seed=2)
    want = RF.refine_latency_aware(rspec, rprof, ra, procs[0], engine="numpy", **kw)
    got = TF.refine_latency_aware(tspec, tprof, ta, procs[1], engine="torch", device="cpu", **kw)
    _same_alloc(want, got)
    assert got.arrays_used > ta.arrays_used
    with pytest.raises(ValueError, match="block-wise"):
        TF.refine_latency_aware(tspec, tprof, T.allocate(tspec, tprof, "weight_based", pes), procs[1], device="cpu")

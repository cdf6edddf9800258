"""The port's fault sweep (``dse.faults``) and failure replay on the
segmented stream (``fabric.fleet.run_trace_failures``) against the
reference, on the host.

Both packages start from the reference's VGG11 capture (1 image, 64
samples, seed 0; the port's ``get_captured`` returns it through
``convert.capture_from_numpy``).  The reference replays each fault point on
its numpy engine with segments padded to ``pad_to`` requests; padded
requests change nothing, so the reference's sweep here runs with
``pad_to=1`` to stay inside the test's time.  Tolerances: availability,
kill / repair counts, spares, arrays, stall charges and the sketch
percentiles exactly equal (the percentiles come from bit-identical bucket
counts and min / max); completions of a failure replay bit-identical to the
event engine's.  VT's streaming entry runs its plain version here.
"""

import functools

import jax
import jax.experimental
import numpy as np
import pytest

import repro_torch as T
import repro_torch.fabric as TF
from repro_torch.convert import capture_from_numpy
from repro_torch.dse import faults as TDF
from repro_torch.dse import fused as TFU
from repro_torch.dse import pareto as TP
from repro_torch.dse import sweep as TS

CLOCK_HZ = 1e8


@pytest.fixture(scope="module", autouse=True)
def _x64_shim():
    """The reference imports ``jax.experimental.enable_x64`` (``fleet.py:249``,
    ``:736``), which jax 0.9 removed; provide it for this module only."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(
                jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False
            )
        yield


@pytest.fixture(scope="module")
def shared(_x64_shim):
    from repro.dse import sweep as RS

    rcap = RS.get_captured("vgg11", sample_patches=64)
    tcap = capture_from_numpy(rcap, device="cpu")

    def get_captured(network, *, profile_images=1, sample_patches=128, seed=0, device="cuda"):
        assert (network, profile_images, sample_patches, seed) == ("vgg11", 1, 64, 0)
        assert str(device) == "cpu"
        return tcap

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFU, "get_captured", get_captured)
        mp.setattr(TS, "get_captured", get_captured)
        TS.clear_caches()
        yield rcap, tcap
        TS.clear_caches()


@pytest.fixture(scope="module")
def setup(shared):
    import repro.core.cim as R
    import repro.fabric as RF

    rcap, tcap = shared
    rspec, tspec = R.vgg11_cifar10(), T.vgg11_cifar10()
    rprof = R.derive_profile(rcap, rspec)
    tprof = T.derive_profile(tcap, tspec)
    ra = R.allocate(rspec, rprof, "blockwise", rspec.min_pes() * 2)
    ta = T.allocate(tspec, tprof, "blockwise", tspec.min_pes() * 2)
    cap = R.simulate(rspec, rprof, ra, n_images=64).images_per_sec
    times = np.cumsum(np.random.default_rng(0).exponential(1.0, 40)) / (0.6 * cap / CLOCK_HZ)
    return R, RF, rspec, rprof, ra, tspec, tprof, ta, times


def test_fault_grid_matches_reference():
    import repro.dse as RD

    kw = dict(networks=("vgg11",), spare_fractions=(0.0, 0.1, 0.25), rates=(1e-9, 1e-8), repair_cycles=5e5)
    def key(p):
        return (p.network, p.spare_fraction, p.rate_per_array, p.n_pes, p.policy, p.repair_cycles, p.array.rows)

    assert [key(p) for p in RD.fault_grid(**kw)] == [key(p) for p in TDF.fault_grid(**kw)]


def test_fault_sweep_matches_reference(shared):
    """Spare fraction x failure rate on the streaming engine: every column
    of the reference's sweep, and the FAULT_OBJECTIVES frontier."""
    import repro.dse as RD
    import repro.dse.faults as RDF
    import repro.fabric.fleet as RFL

    pts = dict(networks=("vgg11",), spare_fractions=(0.0, 0.2), rates=(5e-9, 5e-8))
    kw = dict(n_requests=40, profile_images=1, sample_patches=64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RDF, "run_trace_segments", functools.partial(RFL.run_trace_segments, pad_to=1))
        a = RD.run_fault_sweep(RD.fault_grid(**pts), engine="numpy", **kw)
    b = TDF.run_fault_sweep(TDF.fault_grid(**pts), device="cpu", **kw)
    for col in ("availability", "p50_cycles", "p99_cycles", "arrays_used", "arrays_total", "spare_arrays",
                "n_killed", "n_repaired", "total_stall_cycles"):
        np.testing.assert_array_equal(getattr(b, col), getattr(a, col), err_msg=col)
    assert b.n_killed.sum() > 0
    for x, y in zip(a.rows(), b.rows()):
        assert x == y
    np.testing.assert_array_equal(TP.pareto_frontier(b, TP.FAULT_OBJECTIVES),
                                  RD.pareto_frontier(a, RD.FAULT_OBJECTIVES))


@pytest.mark.parametrize("spares", [0.0, 32.0])
def test_failure_replay_bit_identical_to_event_engine(setup, spares):
    """The reference's acceptance pin: one seeded failure trace (kills,
    repairs, spare re-placement from a pool of ``spares`` arrays, reprogram
    stalls) replayed on the port's segmented stream equals the reference's
    and the port's ``FabricSim(failures=plan)``."""
    R, RF, rspec, rprof, ra, tspec, tprof, ta, times = setup
    horizon = float(times[-1])
    kw = dict(horizon=horizon, seed=5, rate_per_array=2e-9, repair_cycles=horizon / 4)
    rtr = RF.generate_failure_trace(rspec, ra, **kw)
    ttr = TF.generate_failure_trace(tspec, ta, **kw)
    assert ttr.n_failures > 0 and ttr.n_failures == rtr.n_failures
    rplan = RF.degrade_plan(rspec, rprof, ra, rtr, spare_arrays=spares)
    tplan = TF.degrade_plan(tspec, tprof, ta, ttr, spare_arrays=spares)
    assert tplan.n_segments > 1
    ev = RF.FabricSim(rspec, rprof, ra, seed=3, failures=rplan).run(RF.TraceReplay(times))
    tev = TF.FabricSim(tspec, tprof, ta, seed=3, failures=tplan).run(TF.TraceReplay(times))
    vt = TF.VirtualTimeFabric(tspec, tprof, device="cpu")
    res = TF.run_trace_segments(vt, list(tplan.allocs), times, tplan.boundaries, drift=tplan.drift,
                                stream=False, seed=3)
    np.testing.assert_array_equal(tev.completions, ev.completions)
    np.testing.assert_array_equal(res.completions[0], ev.completions)
    # the wrapper compiles the trace itself
    wrap = TF.run_trace_failures(vt, tprof, ta, TF.TraceReplay(times), ttr, spare_arrays=spares, stream=False,
                                 seed=3)
    np.testing.assert_array_equal(wrap.completions, res.completions)
    # streamed: the same replay as sketches, equal to the reference's stream
    import repro.fabric.fleet as RFL

    rs = RFL.run_trace_segments(RF.VirtualTimeFabric(rspec, rprof), list(rplan.allocs), times, rplan.boundaries,
                                drift=rplan.drift, seed=3, engine="numpy", pad_to=1)
    ts = TF.run_trace_segments(vt, list(tplan.allocs), times, tplan.boundaries, drift=tplan.drift, seed=3)
    np.testing.assert_array_equal(ts.makespan, rs.makespan)
    np.testing.assert_array_equal(ts.sketches[0].counts, rs.sketches[0].counts)
    np.testing.assert_array_equal(ts.total_stall_cycles, rs.total_stall_cycles)

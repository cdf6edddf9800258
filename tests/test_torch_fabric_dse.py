"""The sweeps' latency columns: the port's ``run_sweep(fabric=)`` (both
engines), ``run_fused_sweep(fabric=)`` and ``FusedPipeline.fabric_percentiles``
against the reference's, and ``latency_aware`` points in the batched
``dse.engine.run_batch``.

Both packages start from the reference's VGG11 capture (1 image, 128
samples, seed 0), handed to the port's sweep and fused modules in place of
their own ``get_captured`` (as ``tests/test_torch_fused.py`` does).  The
latency columns are percentiles of exact latencies, so the contract is
equality with the reference's staged sweep on its event engine (its batch
engine and fused stage reproduce that engine), and for the fused stage with
the reference's ``FabricSim`` config by config.
"""

import jax
import jax.experimental
import numpy as np
import pytest

import repro.dse as RD
from repro.core.cim.cost import DEFAULT_ARRAY as R_ARRAY
from repro.dse import engine as RE
from repro.dse import sweep as RS
from repro_torch.convert import capture_from_numpy
from repro_torch.core.cim.cost import DEFAULT_ARRAY
from repro_torch.dse import engine as TE
from repro_torch.dse import fused as TFU
from repro_torch.dse import pareto as TP
from repro_torch.dse import sweep as TS

COLS = ("p50_cycles", "p95_cycles", "p99_cycles")
FAB = dict(load_frac=0.7, n_requests=16, seed=0)


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
def shared(_x64_shim):
    rcap = RS.get_captured("vgg11")
    tcap = capture_from_numpy(rcap, device="cpu")

    def get_captured(network, *, profile_images=1, sample_patches=128, seed=0, device="cuda"):
        assert (network, profile_images, sample_patches, seed) == ("vgg11", 1, 128, 0)
        assert str(device) == "cpu"
        return tcap

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFU, "get_captured", get_captured)
        mp.setattr(TS, "get_captured", get_captured)
        TS.clear_caches()
        TFU.clear_fused_caches()
        yield rcap, tcap
        TS.clear_caches()
        TFU.clear_fused_caches()


def _grid(m, array, policies=("baseline", "weight_based", "perf_layerwise", "blockwise")):
    """VGG11 at 1.0 and 2.0 times the minimum PEs, ADC 3 and 6 bits."""
    return m.design_grid(
        networks=("vgg11",), policies=policies, pe_multipliers=(1.0, 2.0),
        arrays=(array, array.variant(adc_bits=6)),
    )


@pytest.fixture(scope="module")
def reference(shared):
    """The reference's staged sweep on the grid, scalar engine (FabricSim)."""
    return RS.run_sweep(_grid(RS, R_ARRAY), engine="scalar", fabric=RS.FabricEval(**FAB))


def _same_columns(got, want):
    for c in ("arrays_used", "arrays_total", "images_per_sec") + COLS:
        np.testing.assert_array_equal(getattr(got, c), getattr(want, c), err_msg=c)


@pytest.mark.parametrize("engine", ["batch", "scalar"])
def test_run_sweep_fabric_columns_equal(shared, reference, engine):
    got = TS.run_sweep(_grid(TS, DEFAULT_ARRAY), engine=engine, fabric=TS.FabricEval(**FAB), device="cpu")
    _same_columns(got, reference)
    assert got.fabric == TS.FabricEval(**FAB)
    assert np.all(got.p99_cycles >= got.p95_cycles) and np.all(got.p95_cycles >= got.p50_cycles)
    assert [r["p99_ms"] for r in got.rows()] == [r["p99_ms"] for r in reference.rows()]


def test_run_sweep_latency_aware_fabric(shared):
    """``latency_aware`` points in a staged sweep with a fabric stage: they
    are provisioned for the load they are evaluated at, in both packages."""
    fab = dict(load_frac=0.6, n_requests=12, seed=1)
    pols = ("weight_based", "blockwise", "latency_aware")
    pts = TS.design_grid(networks=("vgg11",), policies=pols, pe_multipliers=(1.7,))
    want = RS.run_sweep(RS.design_grid(networks=("vgg11",), policies=pols, pe_multipliers=(1.7,)),
                        engine="scalar", fabric=RS.FabricEval(**fab))
    for engine in ("batch", "scalar"):
        _same_columns(TS.run_sweep(pts, engine=engine, fabric=TS.FabricEval(**fab), device="cpu"), want)


def test_run_fused_sweep_fabric_columns_equal(shared, reference):
    """The fused fabric stage's columns equal the reference's staged sweep
    (whose batch engine and fused stage equal its FabricSim columns), and
    so do the latency frontiers."""
    got = TFU.run_fused_sweep(_grid(TS, DEFAULT_ARRAY), fabric=TS.FabricEval(**FAB), device="cpu")
    _same_columns(got, reference)
    np.testing.assert_array_equal(
        TP.pareto_frontier(got, TP.LATENCY_OBJECTIVES),
        RD.pareto_frontier(reference, RD.LATENCY_OBJECTIVES),
    )


class _Placement:
    def __init__(self, xfer):
        self.stage_transfer = xfer


def test_fabric_percentiles_equal(shared):
    """The fused pipeline's fabric stage on a packed grid of every variant
    (ADC 3 and 6, zero-skip on and off, both dataflows), with per-config
    traces, with and without stage transfers: each config's percentiles
    equal the reference's FabricSim on that config's own profile."""
    from repro.fabric import FabricSim, TraceReplay

    rng = np.random.default_rng(3)
    pols = ["baseline", "weight_based", "perf_layerwise", "blockwise", "weight_blockflow"]
    rows = [(a, p) for p in pols for a in (0, 1)]
    a_idx = np.array([a for a, _ in rows], dtype=np.int32)
    policies = [p for _, p in rows]
    tpipe = TFU.get_fused_pipeline("vgg11", DEFAULT_ARRAY, (3, 6), device="cpu")
    n_pes = [int(tpipe.spec.min_pes() * 1.6)] * len(rows)
    res = tpipe(a_idx, policies, n_pes)
    times = np.cumsum(rng.exponential(3e3, (len(rows), 8)), axis=1)
    xfer = rng.random((len(rows), len(tpipe.spec.layers))) * 200.0
    batch = RE.run_batch  # the reference's allocations of the same configs
    for x in (None, xfer):
        got = tpipe.fabric_percentiles(a_idx, res["dups_lb"], res["layerwise"], res["zskip"],
                                       times, seed=4, xfer=x)
        for k, (a, pol) in enumerate(rows):
            spec, prof = RS.get_profiled("vgg11", R_ARRAY.variant(adc_bits=(3, 6)[a]))
            alloc = RE.to_allocation(batch(spec, prof, [pol], [n_pes[k]])[0], 0, spec)
            pl = None if x is None else _Placement(x[k])
            r = FabricSim(spec, prof, alloc, seed=4, placement=pl).run(TraceReplay(times[k]))
            np.testing.assert_array_equal(got[k], np.percentile(r.latencies, [50.0, 95.0, 99.0]))


def test_latency_aware_points_in_run_batch(shared):
    """``latency_aware`` points in the batched engine: replicas and arrays
    used equal to the reference's, analytic floats at rtol 1e-9, at the
    default load and at another."""
    spec, prof = TS.get_profiled("vgg11", device="cpu")
    rspec, rprof = RS.get_profiled("vgg11")
    pols = ["blockwise", "latency_aware", "weight_based", "latency_aware"]
    pes = [spec.min_pes() * 2, spec.min_pes() * 2, spec.min_pes() * 3, spec.min_pes() * 3]
    for lf in (0.7, 0.45):
        ta, tr = TE.run_batch(spec, prof, pols, pes, latency_load_frac=lf)
        ra, rr = RE.run_batch(rspec, rprof, pols, pes, latency_load_frac=lf)
        np.testing.assert_array_equal(ta.dups_lb.numpy(), ra.dups_lb)
        np.testing.assert_array_equal(ta.arrays_used, ra.arrays_used)
        np.testing.assert_allclose(tr.images_per_sec.numpy(), rr.images_per_sec, rtol=1e-9)
        la = TE.to_allocation(ta, 1, spec)
        assert la.policy == "latency_aware" and la.layer_dups is None


def test_sweep_columns_absent_without_fabric(shared):
    res = TS.run_sweep(_grid(TS, DEFAULT_ARRAY)[:4], device="cpu")
    assert res.p99_cycles is None and res.fabric is None and "p99_ms" not in res.rows()[0]
    with pytest.raises(ValueError, match="FabricEval"):
        res.objectives(("images_per_sec", "p99_cycles"))

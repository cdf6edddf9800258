"""The port's multi-chip sweeps (``dse.sweep.run_multichip_sweep``, the fused
(placement x load) surface ``dse.fused.run_fused_multichip_sweep``), their
Pareto objectives, and ``distrib.sharding.shard_map_batch`` against the
reference, on the host.

Both packages start from the reference's VGG11 capture (1 image, 64
samples, seed 0): the port's ``get_captured`` (in ``dse.sweep`` and
``dse.fused``) is replaced by one that returns
``convert.capture_from_numpy(<reference capture>)``.  Tolerances: discrete
columns (arrays used / total, ``n_crossings``, frontier indices) exactly
equal; throughput, percentiles and transfers equal as well (they come from
bit-identical completions through ``np.percentile``); the fused surface at
load 0.7 equal to the staged sweep within rtol 1e-12, as the reference's
bench asserts; sharded evaluations identical to the plain ones.  VT runs
its plain version here.
"""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro_torch.convert import capture_from_numpy
from repro_torch.distrib import sharding as TSH
from repro_torch.dse import fused as TFU
from repro_torch.dse import pareto as TP
from repro_torch.dse import sweep as TS

RTOL = 1e-12
GRID = dict(networks=("vgg11",), chips=(1, 2, 4), link_gbps=(16.0, 256.0), pe_multiplier=2.0)
RUN = dict(n_requests=30, closed_requests=20, concurrency=10, sample_patches=64)


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
    """The reference's VGG11 capture at 64 samples, handed to the port's
    sweep and fused modules in place of their own capture."""
    from repro.dse import sweep as RS

    caps = {}

    def get_captured(network, *, profile_images=1, sample_patches=128, seed=0, device="cuda"):
        assert (network, profile_images, seed) == ("vgg11", 1, 0)
        assert str(device) == "cpu"
        if sample_patches not in caps:
            caps[sample_patches] = capture_from_numpy(
                RS.get_captured("vgg11", sample_patches=sample_patches), device="cpu")
        return caps[sample_patches]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFU, "get_captured", get_captured)
        mp.setattr(TS, "get_captured", get_captured)
        TS.clear_caches()
        TFU.clear_fused_caches()
        yield
        TS.clear_caches()
        TFU.clear_fused_caches()


@pytest.fixture(scope="module")
def sweeps(shared):
    """(reference numpy sweep, port torch-engine sweep, port numpy sweep)."""
    import repro.dse as RD

    a = RD.run_multichip_sweep(RD.chip_grid(**GRID), engine="numpy", **RUN)
    b = TS.run_multichip_sweep(TS.chip_grid(**GRID), device="cpu", **RUN)
    c = TS.run_multichip_sweep(TS.chip_grid(**GRID), engine="numpy", device="cpu", **RUN)
    return a, b, c


def test_chip_grid_matches_reference():
    import repro.dse as RD

    for kw in (GRID, dict(networks=("vgg11", "resnet18"), chips=(1, 2, 4, 8), link_gbps=(16.0, 64.0, 256.0))):
        a, b = RD.chip_grid(**kw), TS.chip_grid(**kw)
        assert [(p.network, p.n_chips, p.link_gbps, p.n_pes_total, p.policy) for p in a] == \
            [(p.network, p.n_chips, p.link_gbps, p.n_pes_total, p.policy) for p in b]
        assert len({p.n_pes_total for p in b if p.network == "vgg11"}) == 1


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_multichip_sweep_matches_reference(sweeps, engine):
    a, b, c = sweeps
    got = b if engine == "torch" else c
    for col in ("images_per_sec", "p50_cycles", "p95_cycles", "p99_cycles", "max_stage_transfer"):
        np.testing.assert_array_equal(getattr(got, col), getattr(a, col), err_msg=col)
    for col in ("n_crossings", "arrays_used", "arrays_total"):
        np.testing.assert_array_equal(getattr(got, col), getattr(a, col), err_msg=col)
    assert got.rows() == a.rows()
    rows = {(p.n_chips, p.link_gbps): i for i, p in enumerate(got.points)}
    assert got.max_stage_transfer[rows[(1, 16.0)]] == 0.0 and got.n_crossings[rows[(1, 256.0)]] == 0
    assert got.max_stage_transfer[rows[(4, 256.0)]] < got.max_stage_transfer[rows[(4, 16.0)]]


def test_multichip_pareto_frontier_matches(sweeps):
    import repro.dse as RD

    a, b, _ = sweeps
    np.testing.assert_array_equal(
        TP.pareto_frontier(b, TP.MULTICHIP_OBJECTIVES), RD.pareto_frontier(a, RD.MULTICHIP_OBJECTIVES))
    assert TP.MULTICHIP_OBJECTIVES == RD.MULTICHIP_OBJECTIVES
    assert TP.FAULT_OBJECTIVES == RD.FAULT_OBJECTIVES


def test_fused_multichip_surface(sweeps):
    """The (placement x load) surface: at load 0.7 equal to the staged
    sweep (rtol 1e-12, as the bench asserts), and its rows serialize every
    (point, load) pair; tails grow with the load."""
    _, b, _ = sweeps
    loads = (0.3, 0.7)
    f = TFU.run_fused_multichip_sweep(TS.chip_grid(**GRID), load_fracs=loads, device="cpu", **RUN)
    np.testing.assert_allclose(f.pcts[:, 1, 0], b.p50_cycles, rtol=RTOL, atol=0)
    np.testing.assert_allclose(f.pcts[:, 1, 2], b.p99_cycles, rtol=RTOL, atol=0)
    np.testing.assert_allclose(f.images_per_sec, b.images_per_sec, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(f.n_crossings, b.n_crossings)
    assert f.n_evaluations == len(f.points) * 2 and len(f.rows()) == f.n_evaluations
    assert np.all(f.pcts[:, 1, 2] >= f.pcts[:, 0, 2])


# ------------------------------------------------------------- sharding
def test_shard_map_batch_pads_odd_batches():
    """Five rows over three devices: padded to six, split, gathered, the
    padding dropped; one device calls the function as it is."""
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return x * 2.0, x.sum(dim=1)

    x = torch.arange(15.0, dtype=torch.float64).reshape(5, 3)
    y, d = TSH.shard_map_batch(fn, devices=[torch.device("cpu")] * 3)(x)
    assert calls == [2, 2, 2]
    torch.testing.assert_close(y, x * 2.0, rtol=0, atol=0)
    torch.testing.assert_close(d, x.sum(dim=1), rtol=0, atol=0)
    y1, _ = TSH.shard_map_batch(fn)(x)
    assert calls[-1] == 5 and torch.equal(y1, x * 2.0)
    assert TSH.local_eval_devices("cpu") == [torch.device("cpu")]


def test_sharded_sweeps_identical_to_plain(shared, monkeypatch):
    """``shard_devices=True`` on ``run_sweep`` (the batched evaluator) and on
    ``run_fused_sweep`` (both engines' chunks), split over three host
    devices, gives the plain sweeps' columns exactly."""
    monkeypatch.setattr(TSH, "local_eval_devices", lambda device="cuda": [torch.device("cpu")] * 3)
    pts = TS.design_grid(networks=("vgg11",), pe_multipliers=(1.0, 1.7, 2.0))
    kw = dict(sample_patches=64, device="cpu")
    a = TS.run_sweep(pts, **kw)
    b = TS.run_sweep(pts, shard_devices=True, **kw)
    for col in ("images_per_sec", "total_cycles", "mean_utilization", "arrays_used"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
    for engine in ("torch", "kernel"):
        c = TFU.run_fused_sweep(pts, engine=engine, **kw)
        d = TFU.run_fused_sweep(pts, engine=engine, shard_devices=True, chunk=5, **kw)
        for col in ("images_per_sec", "total_cycles", "mean_utilization", "arrays_used"):
            np.testing.assert_array_equal(getattr(c, col), getattr(d, col))

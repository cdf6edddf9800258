"""The port's fused DSE sweep against the reference, from one shared VGG11
capture, on the host.

The reference builds its capture with ``jax.random``, which torch cannot
reproduce, so both packages start from the reference's capture: the port's
``get_captured`` (in ``dse.fused`` and ``dse.sweep``) is replaced by one
that returns ``convert.capture_from_numpy(<reference capture>)``.

The contract is the reference's fused one (``tests/test_fused_dse.py``):
discrete columns (replica tensors, arrays used / total, the dataflow and
zero-skip flags) exactly equal, float columns (total cycles, img/s, layer
cycles, utilization) within rtol 1e-12.  The cycle banks are integers and
exactly equal.  ``engine="torch"`` stands for the reference's ``"xla"``,
``engine="kernel"`` (K2's plain version on the host) for ``"pallas"``.
"""

import jax
import jax.experimental
import numpy as np
import pytest

import repro.dse as RD
from repro.core.cim.cost import DEFAULT_ARRAY as R_ARRAY
from repro.dse import sweep as RS
from repro.kernels.bitplane_profile import bitplane_cycle_bank as r_cycle_bank
from repro_torch.convert import capture_from_numpy
from repro_torch.core.cim.cost import DEFAULT_ARRAY
from repro_torch.dse import fused as TF
from repro_torch.dse import pareto as TP
from repro_torch.dse import sweep as TS
from repro_torch.kernels import bitplane_profile as TK1

RTOL = 1e-12
POLS = ("baseline", "weight_based", "perf_layerwise", "blockwise")
ADCS = (6, 8)
EXACT = ("arrays_used", "arrays_total", "layerwise", "zskip", "dups_lb")
FLOATS = ("total_cycles", "images_per_sec", "layer_cycles", "layer_utilization")
SWEEP_EXACT = ("arrays_used", "arrays_total")
SWEEP_FLOATS = ("total_cycles", "images_per_sec", "mean_utilization")


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
    """The reference's VGG11 capture (1 image, 128 samples, seed 0), handed
    to the port's sweep and fused modules in place of their own capture."""
    rcap = RS.get_captured("vgg11")
    tcap = capture_from_numpy(rcap, device="cpu")

    def get_captured(network, *, profile_images=1, sample_patches=128, seed=0, device="cuda"):
        assert (network, profile_images, sample_patches, seed) == ("vgg11", 1, 128, 0)
        assert str(device) == "cpu"
        return tcap

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TF, "get_captured", get_captured)
        mp.setattr(TS, "get_captured", get_captured)
        TS.clear_caches()
        TF.clear_fused_caches()
        yield rcap, tcap
        TS.clear_caches()
        TF.clear_fused_caches()


def _packed_grid(pols=POLS + ("weight_blockflow",), pes=(300, 557, 800)):
    """(a_idx, policies, n_pes) columns spanning both ADC variants (the
    reference's ``tests/test_fused_dse.py`` grid)."""
    rows = [(a, p, n) for p in pols for a in (0, 1) for n in pes]
    a_idx, policies, n_pes = zip(*rows)
    return (
        np.array(a_idx, dtype=np.int32),
        np.array(policies, dtype=object),
        np.array(n_pes, dtype=np.int64),
    )


@pytest.fixture(scope="module")
def pipes(shared):
    return (
        RD.get_fused_pipeline("vgg11", R_ARRAY, ADCS),
        TF.get_fused_pipeline("vgg11", DEFAULT_ARRAY, ADCS, device="cpu"),
    )


@pytest.fixture(scope="module")
def reference_outputs(pipes):
    rpipe, _ = pipes
    grid = _packed_grid()
    return {
        eng: rpipe(*grid, need_dups=True, return_bank=True, engine=eng) for eng in ("xla", "pallas")
    }


def _assert_cols(got, want, exact, floats):
    for k in exact:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for k in floats:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, err_msg=k)


def _sweep_cols(res):
    return {k: getattr(res, k) for k in SWEEP_EXACT + SWEEP_FLOATS}


def test_static_tensors_equal_reference(pipes):
    rpipe, tpipe = pipes
    np.testing.assert_array_equal(tpipe.Q.numpy(), rpipe.Q)
    for k in ("s_mask", "b_mask", "l_idx", "blk_idx", "cost_blk", "mean0", "max0", "pm_mean0", "pm_max0", "busy0"):
        np.testing.assert_array_equal(getattr(tpipe, k), getattr(rpipe, k), err_msg=k)
    assert (tpipe.L, tpipe.B, tpipe.S, tpipe.N) == (rpipe.L, rpipe.B, rpipe.S, rpipe.N)


@pytest.mark.parametrize("adcs", [ADCS, (1, 2, 3, 4, 5, 6, 7, 8)])
def test_cycle_bank_equals_reference(pipes, adcs):
    """One popcount, A re-costings: the same integers as the reference's
    shift-and-mask path, for every ADC precision at once."""
    import jax.numpy as jnp

    _, tpipe = pipes
    rpr = tuple(2**a for a in adcs)
    got = TK1.bitplane_cycle_bank(tpipe.Q, rpr, cycles_per_read=8)
    want = r_cycle_bank(jnp.asarray(tpipe.Q.numpy()), rpr, cycles_per_read=8)
    assert got.shape == (len(adcs),) + tuple(tpipe.Q.shape[:-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cycle_bank_is_one_popcount(pipes, monkeypatch):
    """``_stats`` reaches K1's wrapper once per pipeline, whatever the number
    of ADC variants, and the derived bank equals the reference's."""
    rpipe, _ = pipes
    calls = []
    real = TK1.bitplane_block_profile

    def counting(q, **kw):
        calls.append(tuple(q.shape))
        return real(q, **kw)

    monkeypatch.setattr(TK1, "bitplane_block_profile", counting)
    fresh = TF.FusedPipeline("vgg11", DEFAULT_ARRAY, ADCS, device="cpu")
    bank = fresh(*_packed_grid(), return_bank=True)["bank"]
    fresh(*_packed_grid(), engine="kernel")
    assert calls == [(fresh.L * fresh.B, fresh.S, DEFAULT_ARRAY.rows)]
    np.testing.assert_array_equal(bank, rpipe(*_packed_grid(), return_bank=True)["bank"])


@pytest.mark.parametrize("engine,ref_engine", [("torch", "xla"), ("kernel", "pallas"), ("kernel", "xla")])
def test_pipeline_equals_reference(pipes, reference_outputs, engine, ref_engine):
    _, tpipe = pipes
    got = tpipe(*_packed_grid(), need_dups=True, return_bank=True, engine=engine)
    want = reference_outputs[ref_engine]
    assert set(got) == set(want)
    _assert_cols(got, want, EXACT + ("bank",), FLOATS)


@pytest.mark.parametrize("engine", ["torch", "kernel"])
@pytest.mark.parametrize("chunk", [1, 5, 10**6])
def test_chunk_tilings_identical(pipes, engine, chunk):
    """Chunking changes pass boundaries, never values."""
    _, tpipe = pipes
    grid = _packed_grid(pols=POLS)
    ref = tpipe(*grid, need_dups=True, engine=engine)
    got = tpipe(*grid, need_dups=True, chunk=chunk, engine=engine)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=f"chunk={chunk} {k}")


def test_kernel_engine_routes_every_chunk_through_k2(pipes, monkeypatch):
    """One K2 call per (family, chunk) on the kernel engine, none on the
    torch engine."""
    _, tpipe = pipes
    calls = []
    real = TF.fused_alloc_eval

    def counting(*args, **kw):
        calls.append(args[0].shape[1])  # units: L (layer family) or N (blocks)
        return real(*args, **kw)

    monkeypatch.setattr(TF, "fused_alloc_eval", counting)
    a_idx, pols, pes = _packed_grid()
    tpipe(a_idx, pols, pes)
    assert calls == []
    tpipe(a_idx, pols, pes, engine="kernel", chunk=7)
    n_b = int((pols == "blockwise").sum())
    n_l = len(pols) - n_b
    assert calls == [tpipe.L] * -(-n_l // 7) + [tpipe.N] * -(-n_b // 7)


def test_chunking_gauges(pipes):
    from repro_torch.fabric.telemetry import telemetry_session

    _, tpipe = pipes
    a_idx, pols, pes = _packed_grid(pols=POLS)
    n_l = int(np.sum(pols != "blockwise"))
    n_b = len(pols) - n_l
    per_config = (2 * tpipe.L * tpipe.B + tpipe.N + 2 * tpipe.L + 3) * 8
    with telemetry_session() as tel:
        tpipe(a_idx, pols, pes, chunk=4, need_dups=False)
        snap = tel.snapshot()
    assert snap["gauges"]["dse.fused.chunk_configs"] == 4
    assert snap["gauges"]["dse.fused.chunk_device_bytes"] == 4 * per_config
    assert snap["counters"]["dse.fused.chunks"] == -(-n_l // 4) - (-n_b // 4)
    assert snap["gauges"]["dse.fused.host_out_bytes"] > 0


def _sweep_grid(pols=POLS):
    arrays = (DEFAULT_ARRAY, DEFAULT_ARRAY.variant(adc_bits=5))
    return TS.design_grid(networks=("vgg11",), policies=pols, pe_multipliers=(1.0, 2.0, 3.5), arrays=arrays)


def test_design_grid_and_rows_equal_reference(shared):
    pts = _sweep_grid()
    rpts = RS.design_grid(
        networks=("vgg11",), policies=POLS, pe_multipliers=(1.0, 2.0, 3.5),
        arrays=(R_ARRAY, R_ARRAY.variant(adc_bits=5)),
    )
    assert [(p.network, p.policy, p.n_pes, p.array.adc_bits, p.array.rows) for p in pts] == [
        (p.network, p.policy, p.n_pes, p.array.adc_bits, p.array.rows) for p in rpts
    ]
    got = TF.run_fused_sweep(pts, device="cpu").rows()
    want = RD.run_fused_sweep(rpts).rows()
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=RTOL, abs=0), k
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("engine", ["torch", "kernel"])
def test_run_fused_sweep_equals_staged_and_reference(shared, engine):
    pts = _sweep_grid()
    fused = TF.run_fused_sweep(pts, engine=engine, device="cpu")
    staged = TS.run_sweep(pts, engine="batch", device="cpu")
    want = RD.run_fused_sweep(_reference_points(pts))
    assert fused.engine == "fused" and len(fused) == len(pts)
    _assert_cols(_sweep_cols(fused), _sweep_cols(staged), SWEEP_EXACT, SWEEP_FLOATS)
    _assert_cols(_sweep_cols(fused), _sweep_cols(want), SWEEP_EXACT, SWEEP_FLOATS)


def _reference_points(pts):
    return [
        RS.SweepPoint(p.network, p.policy, p.n_pes, R_ARRAY.variant(adc_bits=p.array.adc_bits))
        for p in pts
    ]


def test_staged_sweep_engines_agree(shared):
    pts = _sweep_grid()
    batch = TS.run_sweep(pts, engine="batch", device="cpu")
    scalar = TS.run_sweep(pts, engine="scalar", device="cpu")
    _assert_cols(_sweep_cols(batch), _sweep_cols(scalar), SWEEP_EXACT, SWEEP_FLOATS)


def test_pareto_frontier_equals_reference(shared):
    pts = _sweep_grid()
    got = TF.run_fused_sweep(pts, device="cpu")
    want = RD.run_fused_sweep(_reference_points(pts))
    np.testing.assert_array_equal(TP.pareto_frontier(got), RD.pareto_frontier(want))
    vals = got.objectives(("arrays_total", "images_per_sec"))
    np.testing.assert_array_equal(
        TP.pareto_mask(vals, [False, True]), RD.pareto_mask(vals, [False, True])
    )
    with pytest.raises(ValueError, match="p99_cycles"):
        got.objectives(("p99_cycles",))


def _pipe():
    return TF.get_fused_pipeline("vgg11", DEFAULT_ARRAY, (3,), device="cpu")


@pytest.mark.parametrize(
    "case,err,match",
    [
        ("latency_aware", ValueError, "latency_aware"),
        ("infeasible", ValueError, "arrays"),
        ("bad_a_idx", ValueError, "a_idx"),
        ("unknown_engine", ValueError, "engine"),
        ("duplicate_adc", ValueError, "duplicate"),
    ],
)
def test_refusals(shared, case, err, match):
    pes = _pipe().spec.min_pes()
    la = TS.design_grid(networks=("vgg11",), policies=("latency_aware",), pe_multipliers=(2.0,))
    calls = {
        "latency_aware": lambda: TF.run_fused_sweep(la, device="cpu"),
        "infeasible": lambda: _pipe()(np.zeros(1, np.int32), ["blockwise"], [1]),
        "bad_a_idx": lambda: _pipe()(np.array([1], np.int32), ["blockwise"], [pes * 2]),
        "unknown_engine": lambda: _pipe()(np.zeros(1, np.int32), ["blockwise"], [pes * 2], engine="pallas"),
        "duplicate_adc": lambda: TF.FusedPipeline("vgg11", DEFAULT_ARRAY, (3, 3), device="cpu"),
    }
    with pytest.raises(err, match=match):
        calls[case]()


@pytest.mark.parametrize("case", ["shard_devices", "shard_pipeline", "staged_shard"])
def test_shard_paths_run(shared, case):
    """``shard=`` / ``shard_devices=`` (refused before the multi-chip slice)
    split the config axis over the local devices: on this host one, so the
    columns are the plain path's exactly (``tests/test_torch_multichip.py``
    splits over three host devices)."""
    pts = _sweep_grid()
    if case == "shard_pipeline":
        pipe = TF.FusedPipeline("vgg11", DEFAULT_ARRAY, (3,), shard=True, device="cpu")
        plain = _pipe()
        pes = plain.spec.min_pes() * 2
        a, b = pipe(np.zeros(1, np.int32), ["blockwise"], [pes]), plain(np.zeros(1, np.int32), ["blockwise"], [pes])
        for col in ("total_cycles", "arrays_used", "dups_lb"):
            np.testing.assert_array_equal(a[col], b[col])
        return
    run = TF.run_fused_sweep if case == "shard_devices" else TS.run_sweep
    a, b = run(pts, shard_devices=True, device="cpu"), run(pts, device="cpu")
    for col in ("total_cycles", "images_per_sec", "arrays_used"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))

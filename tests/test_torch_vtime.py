"""The port's virtual-time fabric (``repro_torch.fabric.vtime``) is the event
engine, bit for bit, on the host and on the card.

Engines: the reference's ``FabricSim`` and numpy engine; the port's
``FabricSim``, numpy engine (the reference's kernel functions, copied) and
``engine="torch"`` (VT, ``kernels.vtime_scan``: its plain PyTorch version on
the CPU, the CUDA kernel on the card).  Arrivals and completions are equal
(``assert_array_equal``) on VGG11 from the reference's capture (1 image, 64
samples, through ``convert.capture_from_numpy`` and the port's derive):
mixed batches, per-config traces, the closed loop, fractional cycles (a
drift-shifted profile), duck-typed placements and the numpy engine's
windows.  The busy and wait sums of ``collect_stats`` are held to the
reference's numpy engine at rtol 1e-12 (their summation order differs).

The card-only cases (marker ``cuda``) hold VT against its plain version and
``FabricSim`` on every path that launches it, on synthetic profiles, so they
need neither jax nor the reference.
"""

import importlib

import numpy as np
import pytest
import torch

import repro_torch as T
import repro_torch.fabric as TF
from repro_torch.core.cim.profile import LayerProfile, NetworkProfile
from repro_torch.fabric.vtime import dispatch_step
from repro_torch.kernels.vtime_scan import kernel_plan, vtime_scan, vtime_scan_ref

CLOCK_HZ = 1e8


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
        yield importlib.import_module("repro.core.cim"), importlib.import_module("repro.fabric")


@pytest.fixture(scope="module")
def vgg(ref):
    from repro_torch.convert import capture_from_numpy

    R, _ = ref
    rspec, tspec = R.vgg11_cifar10(), T.vgg11_cifar10()
    rcap = R.capture_activations(rspec, n_images=1, sample_patches=64)
    rprof = R.derive_profile(rcap, rspec)
    tprof = T.derive_profile(capture_from_numpy(rcap, device="cpu"), tspec)
    return rspec, rprof, tspec, tprof


@pytest.fixture(scope="module")
def allocs(ref, vgg):
    """(reference, port) allocations at twice the minimum PEs: weight_based
    (layer-wise), blockwise, baseline (no zero-skip) and latency_aware at
    half the blockwise img/s; and that img/s."""
    R, _ = ref
    rspec, rprof, tspec, tprof = vgg
    pes = tspec.min_pes() * 2
    cap = R.simulate(rspec, rprof, R.allocate(rspec, rprof, "blockwise", pes)).images_per_sec
    pols = ("weight_based", "blockwise", "baseline", "latency_aware")
    kw = {"latency_aware": {"offered_ips": 0.5 * cap}}
    ra = [R.allocate(rspec, rprof, p, pes, **kw.get(p, {})) for p in pols]
    ta = [T.allocate(tspec, tprof, p, pes, **kw.get(p, {})) for p in pols]
    for a, b in zip(ra, ta):
        assert a.arrays_used == b.arrays_used
    return ra, ta, cap


class _Placement:
    """Duck-typed placement: all the engines read is ``stage_transfer``."""

    def __init__(self, xfer):
        self.stage_transfer = xfer


# ------------------------------------------------------------- kernel unit
@pytest.mark.parametrize("xp", [np, torch], ids=["numpy", "torch"])
@pytest.mark.parametrize("d", [1, 2, 5])
def test_dispatch_step_is_fifo_earliest_free(xp, d):
    """Sorted-insert lanes == a brute-force earliest-free multiset."""
    rng = np.random.default_rng(d)
    lanes = np.sort(rng.uniform(0, 10, d))
    ref = list(lanes)
    free = lanes.copy() if xp is np else torch.from_numpy(lanes.copy())
    for s in rng.exponential(2.0, size=40):
        free, end = dispatch_step(xp, free, s)
        i = min(range(d), key=ref.__getitem__)
        assert float(end) == ref[i] + s
        ref[i] += s
        np.testing.assert_array_equal(np.asarray(free), np.sort(ref))


def test_dispatch_step_inf_lanes_never_selected():
    free, end = dispatch_step(np, np.array([3.0, np.inf, np.inf]), 2.0)
    assert end == 5.0
    np.testing.assert_array_equal(free, [5.0, np.inf, np.inf])


# -------------------------------------------------------- exact equivalence
CASES = ("mixed_poisson", "per_config_traces", "closed", "fractional", "placements")


def _case(case, ref, vgg, allocs):
    """(reference procs, port procs, per-config placements, live profiles)
    of one case; ``procs`` is one process or a per-config list."""
    _, RF = ref
    rspec, rprof, tspec, tprof = vgg
    ra, ta, cap = allocs
    rate = 0.6 * cap / CLOCK_HZ
    live = (None, None)
    places = None
    if case == "per_config_traces":
        procs = [[m.PoissonOpen(16, f * cap / CLOCK_HZ, seed=5) for f in (0.3, 0.5, 0.6, 0.7)] for m in (RF, TF)]
    elif case == "closed":
        procs = [m.ClosedLoop(20, 6) for m in (RF, TF)]
    else:
        procs = [m.PoissonOpen(16, rate, seed=5) for m in (RF, TF)]
    if case == "fractional":
        scale = {2: 1.3, 3: 1.7}
        live = (RF.shift_profile(rprof, scale), TF.shift_profile(tprof, scale))
        assert any(np.any(c.cycles_sample != np.rint(c.cycles_sample)) for c in live[0].layers)
    if case == "placements":
        rng = np.random.default_rng(8)
        places = [_Placement(rng.random(len(tspec.layers)) * 400.0) for _ in ta]
    return procs, places, live


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_engines_bit_identical_to_reference(ref, vgg, allocs, engine, case):
    """One port call over the four allocations == the reference's
    FabricSim per config, and the port's FabricSim == the reference's."""
    _, RF = ref
    rspec, rprof, tspec, tprof = vgg
    ra, ta, _ = allocs
    (rproc, tproc), places, (rlive, tlive) = _case(case, ref, vgg, allocs)
    vt = TF.VirtualTimeFabric(tspec, tprof, live_prof=tlive, device="cpu")
    res = vt.run_batch(ta, tproc, seed=3, engine=engine, placements=places)
    for k, (a, b) in enumerate(zip(ra, ta)):
        pr = rproc[k] if isinstance(rproc, list) else rproc
        tp = tproc[k] if isinstance(tproc, list) else tproc
        pl = None if places is None else places[k]
        want = RF.FabricSim(rspec, rprof, a, seed=3, live_prof=rlive, placement=pl).run(pr)
        np.testing.assert_array_equal(res.completions[k], want.completions)
        np.testing.assert_array_equal(res.arrivals[k], want.arrivals)
        if engine == "numpy":
            got = TF.FabricSim(tspec, tprof, b, seed=3, live_prof=tlive, placement=pl).run(tp)
            np.testing.assert_array_equal(got.completions, want.completions)
    np.testing.assert_array_equal(
        res.percentiles, np.stack([np.percentile(x, [50.0, 95.0, 99.0]) for x in res.latencies])
    )


@pytest.mark.parametrize("window", [1, 8])
def test_numpy_engine_windows(ref, vgg, allocs, window):
    """The numpy engine's blocked request scan gives the reference's numpy
    engine's completions at windows 1 and 8, open and closed loop."""
    _, RF = ref
    rspec, rprof, tspec, tprof = vgg
    ra, ta, cap = allocs
    for rp, tp in ((RF.PoissonOpen(12, 0.6 * cap / CLOCK_HZ, seed=2), TF.PoissonOpen(12, 0.6 * cap / CLOCK_HZ, seed=2)),
                   (RF.ClosedLoop(12, 5), TF.ClosedLoop(12, 5))):
        want = RF.VirtualTimeFabric(rspec, rprof).run_batch(ra[:2], rp, seed=1, engine="numpy", window=window)
        got = TF.VirtualTimeFabric(tspec, tprof, device="cpu").run_batch(ta[:2], tp, seed=1, engine="numpy", window=window)
        np.testing.assert_array_equal(got.completions, want.completions)
        np.testing.assert_array_equal(got.percentiles, want.percentiles)


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_collect_stats(ref, vgg, allocs, engine):
    """Per-layer busy and wait sums at rtol 1e-12 of the reference's numpy
    engine (another summation order); completions unchanged by the flag."""
    _, RF = ref
    rspec, rprof, tspec, tprof = vgg
    ra, ta, cap = allocs
    want = RF.VirtualTimeFabric(rspec, rprof).run_batch(
        ra, RF.PoissonOpen(12, 0.6 * cap / CLOCK_HZ, seed=4), seed=2, engine="numpy", collect_stats=True)
    vt = TF.VirtualTimeFabric(tspec, tprof, device="cpu")
    got = vt.run_batch(ta, TF.PoissonOpen(12, 0.6 * cap / CLOCK_HZ, seed=4), seed=2, engine=engine, collect_stats=True)
    np.testing.assert_array_equal(got.completions, want.completions)
    np.testing.assert_allclose(got.layer_busy, want.layer_busy, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.layer_wait, want.layer_wait, rtol=1e-12, atol=0)
    assert got.layer_busy.shape == (len(ta), len(tspec.layers))


def test_wide_pools_match_reference(ref, vgg):
    """F8: VT takes pools wider than 512 servers.  VGG11 blockwise at 10x,
    12x, 16x and 20x its minimum PEs (330 to 680 servers in the widest pool
    with this capture) through ``engine="torch"`` (VT's plain version here)
    equals the reference's numpy engine bit for bit."""
    R, RF = ref
    rspec, rprof, tspec, tprof = vgg
    mults = (10, 12, 16, 20)
    ra = [R.allocate(rspec, rprof, "blockwise", rspec.min_pes() * m) for m in mults]
    ta = [T.allocate(tspec, tprof, "blockwise", tspec.min_pes() * m) for m in mults]
    widest = [int(TF.vtime.pool_lanes(tspec, a).max()) for a in ta]
    assert max(widest) > 512, widest
    cap = R.simulate(rspec, rprof, ra[0]).images_per_sec
    rp = RF.PoissonOpen(40, 0.6 * cap / CLOCK_HZ, seed=1)
    tp = TF.PoissonOpen(40, 0.6 * cap / CLOCK_HZ, seed=1)
    want = RF.VirtualTimeFabric(rspec, rprof).run_batch(ra, rp, seed=0, engine="numpy")
    got = TF.VirtualTimeFabric(tspec, tprof, device="cpu").run_batch(ta, tp, seed=0)
    np.testing.assert_array_equal(got.completions, want.completions)
    np.testing.assert_array_equal(got.percentiles, want.percentiles)


def test_run_batch_validation(vgg, allocs):
    _, _, tspec, tprof = vgg
    vt = TF.VirtualTimeFabric(tspec, tprof, device="cpu")
    bw = allocs[1][1]
    with pytest.raises(ValueError, match="at least one"):
        vt.run_batch([], TF.ClosedLoop(4, 2))
    with pytest.raises(ValueError, match="engine"):
        vt.run_batch([bw], TF.ClosedLoop(4, 2), engine="jax")
    with pytest.raises(ValueError, match="arrival processes"):
        vt.run_batch([bw, bw], [TF.ClosedLoop(4, 2)])
    with pytest.raises(ValueError, match="mix closed"):
        vt.run_batch([bw, bw], [TF.ClosedLoop(4, 2), TF.TraceReplay(np.arange(4.0))])
    res = vt.run_batch([bw], TF.TraceReplay(np.array([], dtype=np.float64)), seed=0)
    assert res.completions.shape == (1, 0)


def test_kernel_plan():
    """Consumer warps with a thread for each pool of the widest layer and a
    warp for each pool of more than 8 servers in the layer with most (at
    most 12, or 4 in the widest build), and 4 staging warps; state lanes a
    power of two a pool (at
    least 32 for a warp's), in shared memory while they fit beside two
    staging buffers of at most 2048 service times."""
    from repro_torch.kernels.vtime_scan import pool_caps

    np.testing.assert_array_equal(pool_caps([0, 1, 2, 3, 4, 5, 8, 9, 32, 33, 222, 512]),
                                  [0, 1, 2, 4, 4, 8, 8, 32, 32, 64, 256, 512])
    lanes = np.array([[1, 3, 3, 1, 50], [1, 1, 1, 1, 1]])
    plan = kernel_plan(lanes, [1, 4], [1024, 16])
    assert plan == (96, 1, 4, 1024, 1 + 4 + 4 + 1 + 64, True, 8 * (2 * 1024 + 74))
    lanes = np.full((2, 40), 9)
    assert kernel_plan(lanes, [4, 36], [64, 64])[:2] == (512, 14)  # 36 wide pools: 14 warps and 2 stage
    assert kernel_plan(lanes, [4, 36], [64, 64])[2:4] == (1, 2048)
    assert kernel_plan(np.full((2, 40), 222), [4, 36], [64, 64])[:3] == (256, 6, 16)
    assert kernel_plan(np.full((1, 247), 300), [247], [4]).smem_state is False
    # a pool wider than 512 servers runs from the pool state (F8): a build
    # of its own, its lanes counted in the state's stride
    assert kernel_plan(np.array([[700]]), [1], [64])[:5] == (96, 1, 32, 64, 1024)
    with pytest.raises(ValueError, match="at most"):
        kernel_plan(np.array([[65_537]]), [1], [1])


def test_vtime_scan_checks_inputs():
    tables = [torch.ones((1, 4, 2), dtype=torch.float64)]
    idx = [torch.zeros((3, 5), dtype=torch.int32)]
    var, lanes = torch.zeros(2, dtype=torch.int32), torch.ones((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="not both"):
        vtime_scan(tables, idx, var, lanes, n_requests=3)
    with pytest.raises(ValueError, match="lanes"):
        vtime_scan(tables, idx, var, lanes[:, :1], n_requests=3, concurrency=2)
    with pytest.raises(ValueError, match="out of range"):
        vtime_scan(tables, [idx[0] + 4], var, lanes, n_requests=3, concurrency=2)
    with pytest.raises(ValueError, match="variant"):
        vtime_scan(tables, idx, var + 1, lanes, n_requests=3, concurrency=2)
    with pytest.raises(ValueError, match=">= 0"):
        vtime_scan([-tables[0]], idx, var, lanes, n_requests=3, concurrency=2)
    with pytest.raises(ValueError, match="lanes"):
        vtime_scan(tables, idx, var, lanes * 70_000, n_requests=3, concurrency=2)
    t_arr, comp, busy, wait = vtime_scan(tables, idx, var, lanes, n_requests=3, concurrency=1)
    # one server a pool, 5 jobs of 1 cycle each, one request at a time
    np.testing.assert_array_equal(comp.numpy(), [[5.0, 10.0, 15.0]] * 2)
    np.testing.assert_array_equal(t_arr.numpy(), [[0.0, 5.0, 10.0]] * 2)
    assert busy is None and wait is None


# ------------------------------------------------------------ on the card
def _synthetic(spec, seed, device):
    """A profile of random integer cycles in [20, 400) per (sample, block)."""
    rng = np.random.default_rng(seed)
    layers = []
    for l in spec.layers:
        c = rng.integers(20, 400, (128, l.n_blocks))
        layers.append(LayerProfile(
            l.name, torch.full((l.n_blocks,), 0.3, dtype=torch.float64, device=device),
            torch.as_tensor(c.mean(axis=0), device=device), torch.as_tensor(c, device=device),
            torch.as_tensor(c.max(axis=0) + 16, device=device), l.patches_per_image))
    return NetworkProfile(spec.name, tuple(layers))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["open", "closed", "closed1", "stats", "placements", "fractional"])
def test_vt_run_batch_on_card(case):
    """``run_batch(engine="torch")`` on the card: one VT launch for the six
    policies; completions equal to FabricSim's on the host, and with stats
    the sums at rtol 1e-12 of the numpy engine."""
    dev = _card()
    spec = T.vgg11_cifar10()
    prof = _synthetic(spec, 1, dev)
    pes = spec.min_pes() * 2
    allocs = [T.allocate(spec, prof, p, pes) for p in T.POLICIES + ("latency_aware",)]
    cap = T.simulate(spec, prof, allocs[3]).images_per_sec
    proc = {"closed": TF.ClosedLoop(30, 8), "closed1": TF.ClosedLoop(12, 1)}.get(
        case, TF.PoissonOpen(30, 0.7 * cap / CLOCK_HZ, seed=5))
    live = TF.shift_profile(prof, {0: 1.37, 2: 0.71}) if case == "fractional" else None
    places = None
    if case == "placements":
        rng = np.random.default_rng(3)
        places = [_Placement(rng.random(len(spec.layers)) * 300.0) for _ in allocs]
    vt = TF.VirtualTimeFabric(spec, prof, live_prof=live, device=dev)
    before = vtime_scan.launches
    res = vt.run_batch(allocs, proc, seed=3, placements=places, collect_stats=case == "stats")
    torch.cuda.synchronize()
    assert vtime_scan.launches == before + 1
    for k, a in enumerate(allocs):
        want = TF.FabricSim(spec, prof, a, seed=3, live_prof=live,
                            placement=None if places is None else places[k]).run(proc)
        np.testing.assert_array_equal(res.completions[k], want.completions)
        np.testing.assert_array_equal(res.arrivals[k], want.arrivals)
    if case == "stats":
        host = TF.VirtualTimeFabric(spec, prof, device=dev).run_batch(
            allocs, proc, seed=3, engine="numpy", collect_stats=True)
        np.testing.assert_allclose(res.layer_busy, host.layer_busy, rtol=1e-12, atol=0)
        np.testing.assert_allclose(res.layer_wait, host.layer_wait, rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("max_lanes", [1, 6, 40, 300, 1500, 4096, 65_536])
def test_vt_equals_plain_on_card(max_lanes):
    """VT against its plain version on the card on random problems (every
    (K, G) class up to 16 lanes a thread over 32 threads, and pools wider
    than 512 whose lanes stay in the pool state, up to ``MAX_LANES``, where
    the state no longer fits in shared memory; pools without servers;
    fractional cycles; transfers; stats).  The first pool of the first
    config holds ``max_lanes`` servers."""
    dev = _card()
    rng = np.random.default_rng(max_lanes)
    L, V, C, N = 5, 3, 7, 9
    shapes = [(int(rng.integers(1, 40)), int(rng.integers(1, 20)), int(rng.integers(0, 30))) for _ in range(L)]
    tables = [torch.as_tensor(rng.random((V, s, b)) * 100.0, device=dev) for s, b, _ in shapes]
    idx = [torch.as_tensor(rng.integers(0, s, (N, p)), dtype=torch.int32, device=dev) for s, _, p in shapes]
    n_pools = sum(b for _, b, _ in shapes)
    lanes_np = rng.integers(0, max_lanes + 1, (C, n_pools))
    lanes_np[0, 0] = max_lanes
    lanes = torch.as_tensor(lanes_np, dtype=torch.int32, device=dev)
    var = torch.as_tensor(rng.integers(0, V, C), dtype=torch.int32, device=dev)
    xfer = torch.as_tensor(rng.random((C, L)) * 50.0, device=dev)
    arr = torch.as_tensor(np.cumsum(rng.exponential(300.0, (C, N)), axis=1), device=dev)
    if max_lanes > 512:
        plan = kernel_plan(lanes_np, [b for _, b, _ in shapes], [p for _, _, p in shapes])
        assert plan.kmax == 32 and not plan.smem_state
    for kw in (dict(arrivals=arr), dict(concurrency=3, xfer=xfer)):
        got = vtime_scan(tables, idx, var, lanes, n_requests=N, collect_stats=True, **kw)
        want = vtime_scan_ref(tables, idx, var, lanes, n_requests=N, collect_stats=True, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g, w)
        for g, w in zip(got[2:], want[2:]):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
def test_latency_aware_provisioning_on_card():
    """``provision_latency_aware`` and ``refine_latency_aware`` through VT
    on the card give the allocation their plain run on the host gives."""
    dev = _card()
    spec = T.vgg11_cifar10()
    pc, ph = _synthetic(spec, 2, dev), _synthetic(spec, 2, "cpu")
    kw = dict(load_frac=0.4, calib_requests=30, grants=2, margin=-1.0)
    got = TF.provision_latency_aware(spec, pc, spec.min_pes() * 2, device=dev, **kw)
    want = TF.provision_latency_aware(spec, ph, spec.min_pes() * 2, device="cpu", **kw)
    assert got.arrays_used == want.arrays_used
    for a, b in zip(got.block_dups, want.block_dups):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_sweep_latency_columns_on_card():
    """``run_sweep(fabric=)`` on the batch engine (one VT launch per group)
    and ``run_fused_sweep(fabric=)`` (``fabric_percentiles``, one VT launch
    per geometry) on the card give the host scalar sweep's columns."""
    dev = _card()
    from repro_torch.dse import FabricEval, clear_caches, clear_fused_caches, design_grid, run_fused_sweep, run_sweep

    clear_caches()
    clear_fused_caches()
    pts = design_grid(networks=("vgg11",), policies=("baseline", "weight_based", "perf_layerwise", "blockwise"),
                      pe_multipliers=(1.0, 2.5), arrays=(T.DEFAULT_ARRAY, T.DEFAULT_ARRAY.variant(adc_bits=6)))
    fe = FabricEval(n_requests=24)
    before = vtime_scan.launches
    batch = run_sweep(pts, fabric=fe, device=dev)
    fused = run_fused_sweep(pts, fabric=fe, device=dev)
    assert vtime_scan.launches == before + 3  # two array groups staged, one geometry fused
    scalar = run_sweep(pts, fabric=fe, engine="scalar", device=dev)
    for col in ("images_per_sec", "p50_cycles", "p95_cycles", "p99_cycles"):
        np.testing.assert_array_equal(batch.__dict__[col], scalar.__dict__[col])
        np.testing.assert_array_equal(fused.__dict__[col], scalar.__dict__[col])
    clear_caches()
    clear_fused_caches()


@pytest.mark.cuda
@pytest.mark.parametrize("mult", [10, 12, 20])
def test_wide_pools_on_card(mult):
    """F8 on the card: VGG11 blockwise at 10x, 12x and 20x its minimum PEs
    (569, 702 and 1,178 servers in the widest pool of this synthetic
    profile) through VT equals ``FabricSim`` on the host."""
    dev = _card()
    spec = T.vgg11_cifar10()
    prof = _synthetic(spec, 1, dev)
    alloc = T.allocate(spec, prof, "blockwise", spec.min_pes() * mult)
    assert TF.vtime.pool_lanes(spec, alloc).max() > 512
    cap = T.simulate(spec, prof, alloc).images_per_sec
    proc = TF.PoissonOpen(40, 0.6 * cap / CLOCK_HZ, seed=1)
    before = vtime_scan.launches
    res = TF.VirtualTimeFabric(spec, prof, device=dev).run_batch([alloc], proc, seed=0)
    assert vtime_scan.launches == before + 1
    want = TF.FabricSim(spec, prof, alloc, seed=0).run(proc)
    np.testing.assert_array_equal(res.completions[0], want.completions)

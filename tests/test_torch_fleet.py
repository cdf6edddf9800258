"""The port's fleet replay (``repro_torch.fabric.fleet``) and the streaming VT
entry (``kernels.vtime_scan.vtime_stream``) against the reference.

Inputs: VGG11 from the reference's capture (1 image, 64 samples, through
``convert.capture_from_numpy`` and the port's derive), blockwise at twice
the minimum PEs, plus a layer-wise allocation in the mixed batches.
Tolerances, as the reference's own fleet contract (``tests/test_fleet_replay.py``):

  * completions, arrivals, bucket counts, sketch n / min / max, makespans,
    growth plans, stall charges and lane states: exactly equal;
  * the Welford mean and m2: rtol 1e-12;
  * the hash: equal to numpy's uint32 arithmetic.

The port's fleet runs ``vtime_stream``'s plain version here (CPU tensors);
the card-only cases (marker ``cuda``) hold the kernel to that plain version
and to ``FabricSim(service_sampling="hash")`` on synthetic profiles, and
need neither jax nor the reference.  The reference's ``window`` blocks its
request scan; the port ignores it, so the cases against the reference run
it at W = 1 and W = 8.
"""

import importlib

import numpy as np
import pytest
import torch

import repro_torch as T
import repro_torch.fabric as TF
import repro_torch.fabric.fleet as TFL
from repro_torch.core.cim.profile import LayerProfile, NetworkProfile
from repro_torch.fabric.vtime import _hash_salt, chunk_plan, pool_lanes
from repro_torch.kernels.vtime_scan import (
    stream_dense,
    stream_hash,
    stream_state,
    vt_tables,
    vtime_stream,
    vtime_stream_ref,
)

CLOCK_HZ = 1e8
RTOL = 1e-12


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.experimental

    with pytest.MonkeyPatch.context() as mp:
        # the reference imports jax.experimental.enable_x64 (fleet.py:249,
        # :736), which jax 0.9 removed; provide it for this module only
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(
                jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False
            )
        yield (importlib.import_module("repro.core.cim"), importlib.import_module("repro.fabric"),
               importlib.import_module("repro.fabric.fleet"))


@pytest.fixture(scope="module")
def setup(ref):
    from repro_torch.convert import capture_from_numpy

    R, RF, _ = ref
    rspec, tspec = R.vgg11_cifar10(), T.vgg11_cifar10()
    rcap = R.capture_activations(rspec, n_images=1, sample_patches=64)
    rprof = R.derive_profile(rcap, rspec)
    tprof = T.derive_profile(capture_from_numpy(rcap, device="cpu"), tspec)
    pes = tspec.min_pes() * 2
    ra = [R.allocate(rspec, rprof, p, pes) for p in ("blockwise", "weight_based")]
    ta = [T.allocate(tspec, tprof, p, pes) for p in ("blockwise", "weight_based")]
    cap = R.simulate(rspec, rprof, ra[0], n_images=64).images_per_sec
    rvt = RF.VirtualTimeFabric(rspec, rprof)
    tvt = TF.VirtualTimeFabric(tspec, tprof, device="cpu")
    return rspec, rprof, tspec, tprof, ra, ta, cap, rvt, tvt


def _assert_sketches(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.counts, y.counts)
        assert (x.n, x.min, x.max) == (y.n, y.min, y.max)
        np.testing.assert_allclose([x.mean, x.m2], [y.mean, y.m2], rtol=RTOL, atol=0)


# ------------------------------------------------------------------- hash
def test_stream_hash_matches_numpy_uint32(ref):
    """The plain version's int64-masked hash == numpy's uint32 one (the
    reference's ``hash_service_indices``) on random (salt, r, patch)."""
    _, RF, _ = ref
    from repro.fabric.vtime import hash_service_indices as r_hash

    rng = np.random.default_rng(0)
    for _ in range(20):
        salt = int(rng.integers(0, 2**32))
        r = rng.integers(0, 2**33, size=7)  # ids past 2^32 wrap as uint32 does
        n_p, n_s = int(rng.integers(1, 300)), int(rng.choice([64, 100, 128, 4096]))
        want = r_hash(np, salt, r, n_p, n_s)
        got = stream_hash(salt, torch.as_tensor(r), n_p, n_s, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(TF.hash_service_indices(np, salt, r, n_p, n_s), want)


# --------------------------------------------------- the plain stream entry
@pytest.mark.parametrize("coarsen", [None, 2], ids=["exact", "coarsen"])
@pytest.mark.parametrize("loop", ["open", "closed"])
def test_vtime_stream_ref_matches_reference_kernel(ref, setup, coarsen, loop):
    """``vtime_stream_ref`` == the reference's ``_run_stream_kernel`` with
    numpy, over two consecutive segments (carried lanes, ring and sketch,
    ``r0``), the second padded to 8 requests with 5 valid in the reference;
    with ``emit`` the arrivals and completions too."""
    _, RF, RFL = ref
    from repro.fabric.metrics import SketchConfig, sketch_init
    from repro.fabric.vtime import _np_scan, chunk_plan as r_chunk_plan

    rspec, _, tspec, _, ra, ta, cap, rvt, tvt = setup
    cfg = SketchConfig()
    rc = None if coarsen is None else RF.CoarsenConfig(tail_lanes=coarsen)
    conc = 3 if loop == "closed" else None
    times = np.cumsum(np.random.default_rng(4).exponential(CLOCK_HZ / (0.6 * cap), 11))
    dims, salts = RFL._stream_dims_salts(rvt, 9)
    # the reference, per group and config
    want = {}
    for g in rvt._groups(ra):
        plans = tuple(r_chunk_plan(dims[li][1], g.frees[li].shape[-1], rc) for li in range(len(dims)))
        for k, row in enumerate(g.rows):
            carry = (tuple(f[k] for f in g.frees), np.zeros(conc or 1),
                     tuple(np.asarray(a, dtype=np.float64) for a in sketch_init(np, cfg)), np.zeros(()))
            ys_all = []
            for r0, seg, n_valid in ((0, times[:6], 6), (6, np.r_[times[6:], [times[-1]] * 3], 5)):
                frees, ring, sk, hor = carry
                carry, ys = RFL._run_stream_kernel(
                    np, _np_scan, g.stages, frees, seg, conc, cfg, salts, dims, plans, sk, hor, ring,
                    window=1, r0=r0, n_valid=n_valid, emit=True)
                ys_all.append((np.asarray(ys[0])[:n_valid], np.asarray(ys[1])[:n_valid]))
            want[int(row)] = (carry, ys_all)
    # the port: every config in one call per segment
    tables, variant, lanes, tsalts, patches = TFL._stream_inputs(tvt, ta, 9)
    assert tsalts == list(salts) or tuple(tsalts) == tuple(salts)
    tc = None if coarsen is None else TF.CoarsenConfig(tail_lanes=coarsen)
    plans = TFL._group_plans(tvt, tvt._groups(ta), len(ta), tc)
    carry = stream_state(lanes, lanes, n_bins=cfg.n_bins, ring_len=conc or 1, device="cpu")
    ys_all = []
    for r0, n in ((0, 6), (6, 5)):
        arr = None if conc else torch.as_tensor(np.broadcast_to(times[r0 : r0 + n], (2, n)).copy())
        carry, ys = vtime_stream_ref(tables, variant, lanes, carry, n_requests=n, patches=patches,
                                     salts=tsalts, plans=plans, r0=r0, arrivals=arr, concurrency=conc,
                                     emit=True)
        ys_all.append(ys)
    dense = stream_dense(carry.state, lanes, [l.n_blocks for l in tspec.layers])
    for row, ((frees, ring, sk, hor), w_ys) in want.items():
        for (wa, wc), (ga, gc) in zip(w_ys, ys_all):
            np.testing.assert_array_equal(ga[row].numpy(), wa)
            np.testing.assert_array_equal(gc[row].numpy(), wc)
        np.testing.assert_array_equal(carry.counts[row].numpy(), sk[0])
        np.testing.assert_array_equal(carry.moments[row, :3].numpy(), [sk[1], sk[2], sk[3]])
        np.testing.assert_allclose(carry.moments[row, 3:].numpy(), [sk[4], sk[5]], rtol=RTOL)
        assert float(carry.horizon[row]) == float(hor)
        if conc:
            np.testing.assert_array_equal(carry.ring[row].numpy(), ring)
        for li, f in enumerate(frees):  # lanes: equal up to +inf padding
            got = dense[li][row].numpy()
            w = f.reshape(-1, f.shape[-1]) if f.ndim == 2 else f[None]
            D = max(got.shape[-1], w.shape[-1])
            pad = lambda a: np.concatenate([a, np.full(a.shape[:-1] + (D - a.shape[-1],), np.inf)], -1)
            if ta[row].layer_dups is not None:
                got = got[:1]
            np.testing.assert_array_equal(pad(got), pad(w))


def test_vtime_stream_checks_inputs():
    one = torch.ones((1, 4, 2), dtype=torch.float64)
    tables = vt_tables([one])
    var, lanes = np.zeros(2, dtype=np.int32), np.ones((2, 2), dtype=np.int32)
    carry = stream_state(lanes, lanes, n_bins=8, ring_len=2, device="cpu")
    kw = dict(n_requests=3, patches=[5])
    with pytest.raises(ValueError, match="salts"):
        vtime_stream(tables, var, lanes, carry, concurrency=2, **kw)
    with pytest.raises(ValueError, match="plans"):
        vtime_stream(tables, var, lanes, carry, salts=[1], concurrency=2, plans=[[[3, 2]]], **kw)
    with pytest.raises(ValueError, match="ring"):
        vtime_stream(tables, var, lanes, carry, salts=[1], concurrency=3, **kw)
    for bad in (-one, one * float("nan")):  # checked once, where the tables are packed
        with pytest.raises(ValueError, match=">= 0"):
            vt_tables([bad])
    idx = torch.zeros(4 * 5, dtype=torch.int32)  # requests 0 to 3
    with pytest.raises(ValueError, match="idx"):
        vtime_stream(tables, var, lanes, carry, idx=idx, r0=2, concurrency=2, **kw)
    with pytest.raises(ValueError, match="out of range"):
        vtime_stream(tables, var, lanes, carry, idx=idx + 4, r0=1, concurrency=2, **kw)
    out, ys = vtime_stream(tables, var, lanes, carry, salts=[1], concurrency=1, emit=True, **kw)
    # one server a pool, 5 jobs of 1 cycle each, one request at a time
    np.testing.assert_array_equal(ys[1].numpy(), [[5.0, 10.0, 15.0]] * 2)
    np.testing.assert_array_equal(out.moments[:, :3].numpy(), [[3.0, 5.0, 5.0]] * 2)
    assert out.counts.sum().item() == 6.0 and carry.counts.sum().item() == 0.0


# ------------------------------------------------------------ run_stream
@pytest.mark.parametrize("case", ["open", "open_coarsen", "closed"])
@pytest.mark.parametrize("window", [1, 8])
def test_run_stream_matches_reference(ref, setup, case, window):
    """``run_stream`` on a blockwise + layer-wise batch, materialized:
    completions, sketches and makespans equal to the reference's numpy
    engine at scan window ``window`` (coarsened with the reference's padded
    group widths)."""
    _, RF, RFL = ref
    rspec, _, tspec, _, ra, ta, cap, rvt, tvt = setup
    if case == "closed":
        rp, tp = RF.ClosedLoop(14, 3), TF.ClosedLoop(14, 3)
    else:
        rp = RF.PoissonOpen(14, 0.6 * cap / CLOCK_HZ, seed=5)
        tp = TF.PoissonOpen(14, 0.6 * cap / CLOCK_HZ, seed=5)
    co = case == "open_coarsen"
    a = RFL.run_stream(rvt, ra, rp, seed=7, engine="numpy", window=window, materialize=True,
                       coarsen=RF.CoarsenConfig(tail_lanes=2) if co else None)
    b = TFL.run_stream(tvt, ta, tp, seed=7, window=window, materialize=True,
                       coarsen=TF.CoarsenConfig(tail_lanes=2) if co else None)
    assert b.window == a.window == window
    np.testing.assert_array_equal(b.completions, a.completions)
    np.testing.assert_array_equal(b.arrivals, a.arrivals)
    np.testing.assert_array_equal(b.makespan, a.makespan)
    _assert_sketches(a.sketches, b.sketches)
    np.testing.assert_array_equal(b.percentiles, a.percentiles)


def test_run_stream_equals_fabricsim_hash(ref, setup):
    """The stream's completions == ``FabricSim(service_sampling="hash")``,
    the port's and the reference's, with placements' transfers; the sketch
    percentiles stay within ``rel_error`` of the exact ones."""
    _, RF, _ = ref
    rspec, rprof, tspec, tprof, ra, ta, cap, rvt, tvt = setup
    topo = T.core.cim.FabricTopology.split(2, tspec.min_pes() * 2, link_gbps=16.0)
    pl = T.core.cim.place_allocation(tspec, ta[0], topo)
    proc = TF.PoissonOpen(16, 0.6 * cap / CLOCK_HZ, seed=2)
    res = TFL.run_stream(tvt, [ta[0]], proc, seed=11, placements=[pl], materialize=True)
    sim = TF.FabricSim(tspec, tprof, ta[0], seed=11, service_sampling="hash", placement=pl).run(proc)
    rsim = RF.FabricSim(rspec, rprof, ra[0], seed=11, service_sampling="hash", placement=pl).run(
        RF.PoissonOpen(16, 0.6 * cap / CLOCK_HZ, seed=2))
    np.testing.assert_array_equal(res.completions[0], sim.completions)
    np.testing.assert_array_equal(res.completions[0], rsim.completions)
    err = np.abs(res.percentiles - res.exact_percentiles) / res.exact_percentiles
    assert err.max() <= res.sketches[0].config.rel_error


# ------------------------------------------------------- segmented replay
def test_segment_growth_plan_matches_reference(ref, setup):
    _, _, RFL = ref
    rspec, rprof, tspec, tprof, ra, ta, *_ = setup
    a = RFL.segment_growth_plan(rspec, rprof, ra[0], budgets=[64, -40, 128])
    b = TFL.segment_growth_plan(tspec, tprof, ta[0], budgets=[64, -40, 128])
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert (x.arrays_used, x.arrays_total) == (y.arrays_used, y.arrays_total)
        for u, v in zip(x.block_dups, y.block_dups):
            np.testing.assert_array_equal(u, v)


def test_apply_boundary_matches_reference(ref):
    """Growth (clamp to the seam, new lanes online) and shrink (latest lanes
    absent) on random packed lanes."""
    _, _, RFL = ref
    rng = np.random.default_rng(1)
    C, B, D = 3, 4, 6
    old = rng.integers(1, D + 1, (C, B))
    new = np.clip(old + rng.integers(-2, 3, (C, B)), 1, D)
    lanes = np.where(np.arange(D) < old[..., None], np.sort(rng.random((C, B, D)) * 100, -1), np.inf)
    added = np.array([5, 0, 3])
    tf = np.array([50.0, 60.0, 70.0])
    want = RFL._apply_boundary((lanes,), [old], [new], added, tf)[0]
    got = TFL._apply_boundary((torch.as_tensor(lanes),), [old], [new], added, tf)[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "materialize"])
@pytest.mark.parametrize("window", [1, 8])
def test_run_trace_segments_matches_reference(ref, setup, stream, window):
    """Hold vs a grow-then-shrink trajectory over three segments: sketches,
    makespans, stall charges (and materialized completions) equal to the
    reference's numpy engine at scan window ``window``."""
    _, RF, RFL = ref
    rspec, rprof, tspec, tprof, ra, ta, cap, rvt, tvt = setup
    pr = RFL.segment_growth_plan(rspec, rprof, ra[0], budgets=[64, -40])
    pt = TFL.segment_growth_plan(tspec, tprof, ta[0], budgets=[64, -40])
    times = RF.arrival_times(RF.PoissonOpen(15, 0.6 * cap / CLOCK_HZ, seed=1))
    bounds = [float(times[5]), float(times[10])]
    a = RFL.run_trace_segments(rvt, [[ra[0], p] for p in pr], times, bounds, seed=7, engine="numpy",
                               window=window, stream=stream, pad_to=1)
    b = TFL.run_trace_segments(tvt, [[ta[0], p] for p in pt], times, bounds, seed=7, window=window,
                               stream=stream)
    np.testing.assert_array_equal(b.makespan, a.makespan)
    _assert_sketches(a.sketches, b.sketches)
    for x, y in zip(a.segments, b.segments):
        assert (x.start, x.n_requests) == (y.start, y.n_requests)
        np.testing.assert_array_equal(x.arrays_added, y.arrays_added)
        np.testing.assert_array_equal(x.stall_cycles, y.stall_cycles)
    if not stream:
        np.testing.assert_array_equal(b.completions, a.completions)


def test_segmented_noop_equals_unsegmented(setup):
    """A no-op plan (same allocation, no stall) is bit-identical to one
    unsegmented stream, on the plain entry's carried state."""
    *_, ta, cap, _, tvt = setup
    times = TF.arrival_times(TF.PoissonOpen(13, 0.6 * cap / CLOCK_HZ, seed=3))
    one = TFL.run_stream(tvt, [ta[0]], TF.TraceReplay(times), seed=4)
    seg = TFL.run_trace_segments(tvt, [[ta[0]]] * 3, times, [float(times[4]), float(times[9])], seed=4)
    np.testing.assert_array_equal(seg.makespan, one.makespan)
    for x, y in zip(one.sketches, seg.sketches):
        np.testing.assert_array_equal(x.counts, y.counts)
        assert (x.n, x.min, x.max, x.mean, x.m2) == (y.n, y.min, y.max, y.mean, y.m2)


def test_run_trace_failures_matches_event_engine(setup):
    """A seeded failure trace replayed on the segmented stream equals
    ``FabricSim(failures=plan, service_sampling="hash")`` on the host."""
    rspec, rprof, tspec, tprof, ra, ta, cap, rvt, tvt = setup
    times = TF.arrival_times(TF.PoissonOpen(20, 0.5 * cap / CLOCK_HZ, seed=6))
    trace = TF.generate_failure_trace(tspec, ta[0], horizon=float(times[-1]), seed=3, rate_per_array=2e-8)
    plan = TF.degrade_plan(tspec, tprof, ta[0], trace, spare_arrays=32)
    assert len(plan.boundaries) >= 1
    res = TFL.run_trace_failures(tvt, tprof, ta[0], times, plan, stream=False, seed=5)
    sim = TF.FabricSim(tspec, tprof, ta[0], seed=5, failures=plan).run(TF.TraceReplay(times))
    np.testing.assert_array_equal(res.completions[0], sim.completions)


@pytest.mark.parametrize("conc", [None, 1, 2, 4], ids=["open", "c1", "c2", "c4"])
@pytest.mark.parametrize("seed", range(3))
def test_stream_critical_path_with_plans(conc, seed):
    """The streaming launches' bound: each layer's jobs under its macro-job
    plan (macro-jobs, then the exact tail), and ``critical_path`` over them
    equal to a brute-force longest path through the (request, layer) DAG."""
    import functools

    from repro_torch.kernels.vtime_scan import critical_path

    rng = np.random.default_rng(seed)
    L, N = int(rng.integers(1, 6)), int(rng.integers(1, 10))
    patches = rng.integers(4, 60, L)
    plans = np.array([chunk_plan(int(p), int(rng.integers(1, 4)), TF.CoarsenConfig(tail_lanes=1)) for p in patches])
    jobs = plans[:, 1] + patches - plans[:, 1] * plans[:, 0]
    assert np.all(jobs <= patches) and np.all(jobs >= 1)

    @functools.cache
    def longest(r, l):
        preds = ([longest(r - 1, l)] if r else []) + ([longest(r, l - 1)] if l else [])
        if l == 0 and conc is not None and r >= conc:
            preds.append(longest(r - conc, L - 1))
        return max(preds, default=0) + int(jobs[l])

    assert critical_path(jobs, N, conc) == max(longest(r, l) for r in range(N) for l in range(L))
    if conc == 1 or L == 1:
        assert critical_path(jobs, N, conc) == N * jobs.sum()


def test_stream_plan_weighs_macro_jobs(setup):
    """A streaming launch's plan weighs each layer by its jobs under the
    plans: coarsening VGG11's first layer to 8 macro-jobs takes its stage's
    weight from 1,024 jobs' to 8 jobs' (its one wide pool on a warp), and
    that stage then no longer bounds the plan."""
    from repro_torch.kernels import vtime_scan as vtk

    rspec, rprof, tspec, tprof, ra, ta, cap, rvt, tvt = setup
    lanes = np.stack([pool_lanes(tspec, a) for a in ta[:2]])
    blocks = [l.n_blocks for l in tspec.layers]
    patches = [l.patches_per_image for l in tspec.layers]
    exact = vtk.kernel_plan(lanes, blocks, patches, stream=True)
    assert exact.stages >= 2 and exact.split[1] == 1  # layer 0's 1,024 patches take a stage
    jobs = np.broadcast_to(np.array(patches), lanes.shape[:1] + (len(patches),)).copy()
    jobs[:, 0] = 8
    coarse = vtk.kernel_plan(lanes, blocks, patches, jobs=jobs, stream=True)
    w0 = vtk.job_cycles(vtk.pool_caps(lanes[:, : blocks[0]]).max())
    assert exact.stage_weights[0] == 1024 * w0 + vtk.LAYER_CYCLES == max(exact.stage_weights)
    assert coarse.split[1] == 1 and coarse.stage_weights[0] == 8 * w0 + vtk.LAYER_CYCLES
    assert max(coarse.stage_weights) < max(exact.stage_weights) and coarse.loader_warps == 4


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
@pytest.mark.parametrize("mode", ["hash_open", "hash_closed", "coarsen", "presampled"])
@pytest.mark.parametrize("max_lanes", [1, 6, 40, 300, 1500, 4096, 65_536])
def test_vtime_stream_equals_plain_on_card(mode, max_lanes):
    """``vtime_stream`` against its plain version on random problems, two
    segments with the carry handed across: lanes, ring, bucket counts,
    moments and horizon equal (mean and m2 bit for bit too, the same
    operations in the same order), emitted completions equal.  The first
    pool of the first config holds ``max_lanes`` servers (up to
    ``MAX_LANES``, where the pool state lies in global memory)."""
    dev = _card()
    rng = np.random.default_rng(max_lanes)
    L, V, C, N = 4, 2, 5, 7
    shapes = [(int(rng.integers(2, 40)), int(rng.integers(1, 12)), int(rng.integers(1, 40))) for _ in range(L)]
    tables = vt_tables([torch.as_tensor(np.floor(rng.random((V, s, b)) * 300.0), device=dev) for s, b, _ in shapes])
    patches = [p for _, _, p in shapes]
    n_pools = sum(b for _, b, _ in shapes)
    lanes = rng.integers(0, max_lanes + 1, (C, n_pools))
    servers = np.minimum(lanes, rng.integers(1, max_lanes + 1, (C, n_pools)))  # a pool keeps a server
    lanes[0, 0] = servers[0, 0] = max_lanes
    var = rng.integers(0, V, C)
    conc = 3 if mode == "hash_closed" else None
    plans = None
    if mode == "coarsen":
        plans = np.array([[chunk_plan(p, int(rng.integers(1, 6)), TF.CoarsenConfig(tail_lanes=1))
                           for p in patches] for _ in range(C)])
    xfer = torch.as_tensor(rng.random((C, L)) * 50.0, device=dev)
    carry = stream_state(lanes, servers, n_bins=64, ring_len=conc or 1, device=dev)
    carry_h = carry
    idx = torch.as_tensor(np.concatenate([rng.integers(0, s, 2 * N * p) for s, _, p in shapes]).astype(np.int32),
                          device=dev)
    arr = torch.as_tensor(np.cumsum(rng.exponential(300.0, (C, 2 * N)), axis=1), device=dev)
    for r0 in (0, N):
        kw = dict(n_requests=N, patches=patches, plans=plans, r0=r0, xfer=xfer, emit=True, sketch=(8, 2),
                  concurrency=conc, arrivals=None if conc else arr[:, r0:])
        if mode == "presampled":
            kw.update(idx=idx)
        else:
            kw.update(salts=[int(x) for x in rng.integers(0, 2**32, L)])
        before = vtime_stream.launches
        carry, ys = vtime_stream(tables, var, lanes, carry, **kw)
        carry_h, ys_h = vtime_stream_ref(tables, var, lanes, carry_h, **kw)
        torch.cuda.synchronize()
        assert vtime_stream.launches == before + 1
        for g, w in zip((*carry, *ys), (*carry_h, *ys_h)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_fleet_on_card_equals_host():
    """``run_stream`` (materialized and coarsened) and ``run_trace_segments``
    on the card: completions equal to ``FabricSim(service_sampling="hash")``
    on the host, sketches and makespans equal to the same calls on a CPU
    fabric (the plain version)."""
    dev = _card()
    spec = T.vgg11_cifar10()
    prof = _synthetic(spec, 4, dev)
    pes = spec.min_pes() * 2
    bw, lw = (T.allocate(spec, prof, p, pes) for p in ("blockwise", "weight_based"))
    cap = T.simulate(spec, prof, bw).images_per_sec
    proc = TF.PoissonOpen(24, 0.6 * cap / CLOCK_HZ, seed=2)
    vt = TF.VirtualTimeFabric(spec, prof, device=dev)
    host = TF.VirtualTimeFabric(spec, _synthetic(spec, 4, "cpu"), device="cpu")
    res = TFL.run_stream(vt, [bw, lw], proc, seed=3, materialize=True)
    for k, a in enumerate((bw, lw)):
        sim = TF.FabricSim(spec, prof, a, seed=3, service_sampling="hash").run(proc)
        np.testing.assert_array_equal(res.completions[k], sim.completions)
    co = TF.CoarsenConfig(tail_lanes=2)
    got = TFL.run_stream(vt, [bw, lw], proc, seed=3, coarsen=co)
    want = TFL.run_stream(host, [bw, lw], proc, seed=3, coarsen=co)
    np.testing.assert_array_equal(got.makespan, want.makespan)
    _assert_sketches(want.sketches, got.sketches)
    plan = TFL.segment_growth_plan(spec, prof, bw, budgets=[64, -40])
    times = TF.arrival_times(proc)
    bounds = [float(times[8]), float(times[16])]
    segs = [[bw, p] for p in plan]
    got = TFL.run_trace_segments(vt, segs, times, bounds, seed=3, coarsen=co)
    want = TFL.run_trace_segments(host, segs, times, bounds, seed=3, coarsen=co)
    np.testing.assert_array_equal(got.makespan, want.makespan)
    _assert_sketches(want.sketches, got.sketches)


@pytest.fixture
def force_stages(monkeypatch):
    """Make the streaming launches of a test run at S stages (``kernel_plan``'s
    explicit count, which no entry point exposes)."""
    import functools

    from repro_torch.kernels import vtime_scan as vtk

    real = vtk.kernel_plan

    def force(S):
        monkeypatch.setattr(vtk, "kernel_plan", functools.partial(real, stages=S))
    return force


@pytest.mark.cuda
@pytest.mark.parametrize("order", [(1, 4), (4, 1)], ids=["1-then-4", "4-then-1"])
@pytest.mark.parametrize("mode", ["hash", "hash_closed", "coarsen", "presampled"])
def test_stream_segments_across_stage_counts_on_card(mode, order, force_stages):
    """Two segments launched at S = 1 then S = 4 stages (and the reverse)
    continue each other: their carry and emitted completions equal one
    segment over all the requests (hashed and presampled indices, exact and
    macro-job plans, open and closed loop), because the carry's layout does
    not depend on S."""
    dev = _card()
    rng = np.random.default_rng(11)
    L, V, C, N = 4, 2, 5, 9
    shapes = [(int(rng.integers(2, 40)), int(rng.integers(1, 12)), int(rng.integers(4, 40))) for _ in range(L)]
    tables = vt_tables([torch.as_tensor(np.floor(rng.random((V, s, b)) * 300.0), device=dev) for s, b, _ in shapes])
    patches = [p for _, _, p in shapes]
    n_pools = sum(b for _, b, _ in shapes)
    lanes = rng.integers(0, 60, (C, n_pools))
    lanes[:, 0] = 40
    var = rng.integers(0, V, C)
    conc = 3 if mode == "hash_closed" else None
    plans = None
    if mode == "coarsen":
        plans = np.array([[chunk_plan(p, 2, TF.CoarsenConfig(tail_lanes=1)) for p in patches] for _ in range(C)])
    idx = torch.as_tensor(np.concatenate([rng.integers(0, s, 2 * N * p) for s, _, p in shapes]).astype(np.int32),
                          device=dev)
    arr = torch.as_tensor(np.cumsum(rng.exponential(300.0, (C, 2 * N)), axis=1), device=dev)
    salts = [int(x) for x in rng.integers(0, 2**32, L)]

    def segment(carry, r0, n):
        kw = dict(n_requests=n, patches=patches, plans=plans, r0=r0, emit=True, concurrency=conc,
                  arrivals=None if conc else arr[:, r0:])
        kw.update(idx=idx) if mode == "presampled" else kw.update(salts=salts)
        return vtime_stream(tables, var, lanes, carry, **kw)

    fresh = stream_state(lanes, lanes, n_bins=64, ring_len=conc or 1, device=dev)
    force_stages(2)
    whole, ys = segment(fresh, 0, 2 * N)
    force_stages(order[0])
    carry, y0 = segment(fresh, 0, N)
    force_stages(order[1])
    carry, y1 = segment(carry, N, N)
    torch.cuda.synchronize()
    for name, g, w in zip(carry._fields, carry, whole):
        assert torch.equal(g, w), name
    assert torch.equal(torch.cat([y0[1], y1[1]], dim=1), ys[1])
    assert torch.equal(torch.cat([y0[0], y1[0]], dim=1), ys[0])


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [1, 2])
def test_stream_wide_macro_jobs_on_card(stages, force_stages):
    """Macro-jobs of more patches than a loader warp hashes at once (K =
    1,100, 1,500 and 2,500 against 1,024 sample rows): the fold goes on
    across the pieces of rows, and the carry and completions equal the
    plain version's, open and closed loop, at S = 1 and 2 stages."""
    dev = _card()
    rng = np.random.default_rng(17)
    V, C, N = 2, 3, 3
    shapes = [(50, 3, 3100), (20, 4, 12)]
    tables = vt_tables([torch.as_tensor(np.floor(rng.random((V, s, b)) * 300.0), device=dev) for s, b, _ in shapes])
    patches = [p for _, _, p in shapes]
    lanes = rng.integers(1, 40, (C, sum(b for _, b, _ in shapes)))
    plans = np.array([[(1500, 2), (1, 0)], [(2500, 1), (3, 4)], [(1100, 2), (1, 0)]])
    var = rng.integers(0, V, C)
    salts = [int(x) for x in rng.integers(0, 2**32, len(shapes))]
    arr = torch.as_tensor(np.cumsum(rng.exponential(3e5, (C, N)), axis=1), device=dev)
    force_stages(stages)
    for conc in (None, 2):
        carry = stream_state(lanes, lanes, n_bins=64, ring_len=conc or 1, device=dev)
        kw = dict(n_requests=N, patches=patches, salts=salts, plans=plans, emit=True, concurrency=conc,
                  arrivals=None if conc else arr)
        before = vtime_stream.launches
        got, ys = vtime_stream(tables, var, lanes, carry, **kw)
        want, ys_h = vtime_stream_ref(tables, var, lanes, carry, **kw)
        torch.cuda.synchronize()
        assert vtime_stream.launches == before + 1
        for name, g, w in zip(got._fields, got, want):
            assert torch.equal(g, w), name
        assert torch.equal(ys[0], ys_h[0]) and torch.equal(ys[1], ys_h[1])

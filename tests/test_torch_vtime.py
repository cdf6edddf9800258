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

import functools
import importlib

import numpy as np
import pytest
import torch

import repro_torch as T
import repro_torch.fabric as TF
from repro_torch.core.cim.profile import LayerProfile, NetworkProfile
from repro_torch.fabric.vtime import dispatch_step
from repro_torch.kernels.vtime_scan import kernel_plan, vt_tables, vtime_scan, vtime_scan_ref

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


# ---------------------------------------------- VT's merged epochs, on the host
_LANE = np.arange(32)


def _cx_lane(x, dd, low):
    """``cx_lane``: lane w's value after a compare-exchange with lane w ^ dd."""
    y = x[_LANE ^ dd]
    return np.where((y < x) == low, y, x)


def _sort_desc(e):
    """``bitonic_sort_desc`` on (NB, 32) values, value 32 k + w at e[k, w]."""
    nb, size = e.shape[0], 2
    while size <= 32 * nb:
        dd = size // 2
        while dd:
            for k in range(nb):
                up = ((32 * k) & size) != 0 if size >= 32 else (_LANE & size) != 0
                if dd >= 32:
                    r = dd // 32
                    if not k & r:
                        lo, hi = np.minimum(e[k], e[k | r]), np.maximum(e[k], e[k | r])
                        e[k], e[k | r] = (lo, hi) if up else (hi, lo)
                else:
                    e[k] = _cx_lane(e[k], dd, ((_LANE & dd) == 0) == up)
            dd //= 2
        size *= 2
    return e


def _merge_asc(g):
    """``bitonic_merge_asc`` on (T, 32) values."""
    dd = 16 * g.shape[0]
    while dd:
        for k in range(g.shape[0]):
            if dd >= 32:
                r = dd // 32
                if not k & r:
                    g[k], g[k | r] = np.minimum(g[k], g[k | r]), np.maximum(g[k], g[k | r])
            else:
                g[k] = _cx_lane(g[k], dd, (_LANE & dd) == 0)
        dd //= 2
    return g


def _merge_shape(d):
    """``merge_shape``: registers of ends, the epoch's jobs, registers in all."""
    nb = 4 if d >= 171 else 2 if d >= 86 else 1
    me = min(32 * nb, 3 * d // 4)
    return nb, me, 1 << (nb + (d - me + 31) // 32 - 1).bit_length()


def _merge_epoch(st, d, me, nb, T, svc):
    """``merge_epoch`` on the jobs ``svc`` left in the chunk: the jobs it
    takes (up to ``me``, before the first whose pop an earlier end
    undercuts) and their ends.  The lanes are written back as the warp
    writes them: the epoch's values (its ends, the pops it does not take,
    +inf) sorted descending by the bitonic network below the (T - nb, 32)
    lanes it leaves (+inf above them), the T registers then merged
    ascending by the bitonic merge."""
    v = 32 * np.arange(nb)[:, None] + _LANE
    n = min(me, len(svc))
    q = np.where(v < me, st[np.minimum(v, d - 1)], 0.0)
    e = np.where(v < n, q + svc[np.minimum(v, len(svc) - 1)], np.inf)
    if (e < st[me - 1]).any():
        flat = e.ravel()
        before = np.concatenate([[np.inf], np.minimum.accumulate(flat)[:-1]])
        cut = np.flatnonzero((np.arange(32 * nb) < n) & (before < q.ravel()))
        n = int(cut[0]) if cut.size else n
    ends = list(e.ravel()[:n])
    e = np.where(v < n, e, np.where(v < me, q, np.inf))  # the pops not taken go back in
    u = 32 * np.arange(T - nb)[:, None] + _LANE
    g = np.where(u < d - me, st[np.minimum(me + u, d - 1)], np.inf)
    st[:] = _merge_asc(np.concatenate([g, _sort_desc(e)])).ravel()[:d]
    return n, ends


def _merged_chunk(st, d, t, svc):
    """A host transcription of a merging pool's chunk in ``run_pools``
    (``csrc/vtime_scan.cu``): its d sorted lanes ``st`` clamped to ``t``,
    then epochs (``_merge_epoch``: the ends sorted by the bitonic network
    and merged by the bitonic merge, as the warp does) while half an
    epoch's jobs are left; after an epoch of less than half the jobs it
    could take, the next me jobs (twice as many after each further one, up
    to 16 me) and the chunk's last jobs short of half an epoch one by one
    (``dispatch_step``).  Returns (the ends in job order,
    their largest, the jobs short epochs sent one by one)."""
    nb, me, T = _merge_shape(d)
    st[:] = np.maximum(st, t)
    ends, deep, j, nj, back, cuts = [], 0, 0, len(svc), 0, 0
    while j < nj:
        while back == 0 and 2 * (nj - j) >= me:
            n, e = _merge_epoch(st, d, me, nb, T, svc[j:])
            ends += e
            if 2 * n < min(me, nj - j):
                j += n
                back = me << min(cuts, 4)
                cuts += 1
                deep += min(back, nj - j)
            else:
                j += n
                cuts = 0
        n = min(nj - j, back or me)
        back = 0
        for s in svc[j : j + n]:
            free, end = dispatch_step(np, st, s)
            st[:] = free
            ends.append(end)
        j += n
    return ends, max(ends, default=-np.inf), deep


def _spread_services(kind, rng, n):
    """Service times: narrow (the cells' spread: ends near the top), wide,
    or ties and zeros (ends below the last pop)."""
    if kind == "narrow":
        return np.maximum(1.0, np.rint(rng.normal(200.0, 20.0, n)))
    if kind == "wide":
        return rng.integers(20, 400, n).astype(np.float64)
    return rng.choice([0.0, 0.0, 5.0, 200.0, 200.0, 200.0], n)


def test_bitonic_networks_sort():
    """The transcribed networks sort: 32 NB values descending (ties, +inf
    among them), and a bitonic sequence of 32 T (ascending, then
    descending) ascending."""
    rng = np.random.default_rng(5)
    for nb in (1, 2, 4):
        for _ in range(20):
            e = rng.choice([0.0, 1.0, 2.5, 7.0, np.inf], (nb, 32)) if nb == 2 else rng.normal(0, 1, (nb, 32))
            want = np.sort(e.ravel())[::-1]
            np.testing.assert_array_equal(_sort_desc(e.copy()).ravel(), want)
    for T in (2, 4, 8, 16):
        for _ in range(20):
            a = int(rng.integers(0, 32 * T + 1))
            x = np.concatenate([np.sort(rng.integers(0, 50, a)), np.sort(rng.integers(0, 50, 32 * T - a))[::-1]])
            np.testing.assert_array_equal(_merge_asc(x.astype(np.float64).reshape(T, 32)).ravel(), np.sort(x))


@pytest.mark.parametrize("kind", ["narrow", "wide", "ties-zeros"])
@pytest.mark.parametrize("d", [33, 44, 47, 64, 65, 127, 128, 163, 217, 256, 300, 512])
def test_merged_epochs_transcription_matches_dispatch_step(d, kind):
    """VT's merged epochs, transcribed to the host (``_merged_chunk``):
    every job's end and, after each chunk, the pool's sorted lanes are
    ``dispatch_step``'s one job at a time, over requests of chunks of one
    to several epochs whose free-times are first clamped to the request's
    ready time; the ties and zeros cut epochs short and send jobs one by
    one."""
    rng = np.random.default_rng(d)
    st, ref = np.zeros(d), np.zeros(d)
    t, deep = 0.0, 0
    for r in range(4):
        t = max(t, float(ref.min())) + float(rng.integers(0, 3)) * 150.0 * (r % 2)
        ref = np.maximum(ref, t)
        for nj in (int(rng.integers(1, 40)), 3 * d + 5, 7):
            svc = _spread_services(kind, rng, nj)
            ends, mx, n = _merged_chunk(st, d, t, svc)
            want = []
            for s in svc:
                ref, e = dispatch_step(np, ref, s)
                want.append(e)
            np.testing.assert_array_equal(ends, want)
            assert mx == max(want)
            deep += n
            np.testing.assert_array_equal(st, ref)
        t = float(ref.max())
    assert deep > 0 or kind != "ties-zeros"


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


_TWO = np.array([[1, 3, 3, 1, 50], [1, 1, 1, 1, 1]])


@pytest.mark.parametrize("lanes, blocks, patches, kw, want", [
    # a thread for each small pool, a warp for the 50-server one; layer 0's
    # 1,024 one-server jobs outweigh layer 1: a stage each
    (_TWO, [1, 4], [1024, 16], {}, dict(threads=96, consumer_warps=1, loader_warps=2, kmax=4, chunk=1024,
                                        state_stride=4 + 4 + 1 + 64, smem_state=True,
                                        smem_bytes=8 * (4 * 1024 + 73), stages=2, split=(0, 1, 2))),
    (_TWO, [1, 4], [1024, 16], dict(stages=1), dict(state_stride=74, smem_bytes=8 * (4 * 1024 + 74), stages=1,
                                                    split=(0, 2))),
    # 36 wide pools in a layer: a build of 12 warps (the card's answer for
    # KMAX 1), 10 on the pools and 2 staging; with no card, WARPS (8)
    (np.full((2, 40), 9), [4, 36], [64, 64], dict(warps={1: 12}.get),
     dict(threads=384, consumer_warps=10, kmax=1, chunk=2048)),
    (np.full((2, 40), 9), [4, 36], [64, 64], {}, dict(threads=256, consumer_warps=6, kmax=1, chunk=2048)),
    # the streaming entry: 4 loader warps, and each one's rows
    (np.full((2, 40), 9), [4, 36], [64, 64], dict(stream=True, warps={1: 12}.get),
     dict(threads=384, consumer_warps=8, loader_warps=4, smem_bytes=8 * (4 * 2048 + 1152) + 4 * 1024 * 4)),
    # a KMAX 16 build of 6 warps (two blocks an SM) or 8
    (np.full((2, 40), 222), [4, 36], [64, 64], dict(warps={16: 6}.get), dict(threads=192, consumer_warps=4, kmax=16)),
    (np.full((2, 40), 222), [4, 36], [64, 64], dict(warps={16: 8}.get), dict(threads=256, consumer_warps=6, kmax=16)),
    (np.full((1, 247), 300), [247], [4], {}, dict(smem_state=False, stages=1)),
    # a pool wider than 512 servers: the KMAX 32 build (registers up to
    # 1,024 lanes, the pool state above), its lanes counted in the stride
    (np.array([[700]]), [1], [64], {}, dict(threads=96, consumer_warps=1, kmax=32, chunk=64, state_stride=1024)),
], ids=["small+wide", "one-stage", "36-wide", "36-wide-no-card", "stream", "kmax16", "kmax16-stats", "global-state",
        "f8"])
def test_kernel_plan(lanes, blocks, patches, kw, want, monkeypatch):
    """Consumer warps with a thread for each small pool of the layer that has
    most and a warp for each pool of more than 8 servers in the layer with
    most, within the build's warps (``warps(kmax)``, the card's answer for
    the build's launch bound, else ``WARPS``) beside 2 staging warps (4 for
    the streaming entry); state lanes a power of two a pool (at least 32 for
    a warp's), a stage's in shared memory while they fit beside four
    staging buffers of at most 2048 service times; the stages split the
    layers by their weight."""
    plan = kernel_plan(lanes, blocks, patches, **kw)
    assert {k: getattr(plan, k) for k in want} == want
    assert plan == _per_s_plan(monkeypatch, lanes, blocks, patches, **kw)


def test_pool_caps_and_limits():
    from repro_torch.kernels.vtime_scan import pool_caps

    np.testing.assert_array_equal(pool_caps([0, 1, 2, 3, 4, 5, 8, 9, 32, 33, 222, 512]),
                                  [0, 1, 2, 4, 4, 8, 8, 32, 32, 64, 256, 512])
    with pytest.raises(ValueError, match="at most"):
        kernel_plan(np.array([[65_537]]), [1], [1])
    with pytest.raises(ValueError, match="stages"):
        kernel_plan(np.ones((1, 3), dtype=np.int64), [1, 1, 1], [4, 4, 4], stages=4)


def _brute_split(work, S):
    """The least largest stage over every contiguous split into S stages."""
    import itertools

    L = len(work)
    best = np.inf
    for cuts in itertools.combinations(range(1, L), S - 1):
        b = (0, *cuts, L)
        best = min(best, max(sum(work[i:j]) for i, j in zip(b[:-1], b[1:])))
    return best


@pytest.mark.parametrize("seed", range(6))
def test_stage_split_matches_brute_force(seed):
    """``stage_split`` gives contiguous stages that cover every layer once,
    never more stages than layers, and its largest stage is the
    brute-force least over every contiguous split of up to 8 layers."""
    from repro_torch.kernels.vtime_scan import stage_split

    rng = np.random.default_rng(seed)
    L = int(rng.integers(1, 9))
    work = rng.integers(1, 1000, L).astype(float)
    for S in range(1, L + 1):
        split = stage_split(work, S)
        assert len(split) == S + 1 and split[0] == 0 and split[-1] == L
        assert all(a < b for a, b in zip(split[:-1], split[1:]))
        largest = max(work[a:b].sum() for a, b in zip(split[:-1], split[1:]))
        assert largest == _brute_split(list(work), S)
    with pytest.raises(ValueError):
        stage_split(work, L + 1)


def _split_dp_ref(work, stages: int) -> tuple:
    """The linear-partition DP rerun from one stage for the S asked, a
    Python double loop (``stage_split`` before ``stage_splits``): the
    one-pass splits' reference, ties included."""
    w = np.asarray(work, dtype=np.float64)
    L, S = len(w), int(stages)
    if not 1 <= S <= L:
        raise ValueError(f"{S} stages for {L} layers")
    pre = np.concatenate([[0.0], np.cumsum(w)])
    best = pre[1:].copy()  # best[i]: the least largest stage over layers 0..i in k stages
    cut = [np.zeros(L, dtype=np.int64)]
    for _ in range(1, S):
        nb, nc = np.full(L, np.inf), np.zeros(L, dtype=np.int64)
        for i in range(L):
            for j in range(i):  # the last stage is layers j+1 .. i
                v = max(best[j], pre[i + 1] - pre[j + 1])
                if v < nb[i]:
                    nb[i], nc[i] = v, j + 1
        best = nb
        cut.append(nc)
    split, i = [L], L - 1
    for k in range(S - 1, 0, -1):
        split.append(int(cut[k][i]))
        i = split[-1] - 1
    return tuple([0] + split[::-1])


def _per_s_plan(monkeypatch, *args, **kw):
    """``kernel_plan`` with ``_split_dp_ref`` in the one pass's place: the
    DP rerun for each S the plan tries."""
    from repro_torch.kernels import vtime_scan as vtk

    with monkeypatch.context() as m:
        m.setattr(vtk, "stage_splits", lambda work, most: functools.partial(_split_dp_ref, work))
        return kernel_plan(*args, **kw)


def policy_lanes(spec):
    """(5, pools) VT's lanes of the five policies at twice ``spec``'s
    minimum PEs, from a synthetic capture (row minima 0, 16 random uint8
    samples a layer): a deployment's shape without a forward pass."""
    from repro_torch.core.cim import LayerCapture
    from repro_torch.fabric.vtime import pool_lanes

    rng = np.random.default_rng(0)
    caps = [LayerCapture(l.name, torch.zeros(l.rows, dtype=torch.int64),
                         torch.as_tensor(rng.integers(0, 256, (16, l.rows)), dtype=torch.uint8),
                         l.patches_per_image, l.patches_per_image) for l in spec.layers]
    prof = T.derive_profile(T.ActivationCapture(spec.name, 1, 16, 0, tuple(caps)), spec)
    pes = 2 * spec.min_pes()
    return np.stack([pool_lanes(spec, T.allocate(spec, prof, p, pes)) for p in T.POLICIES])


@functools.cache
def _policy_problem(net: str):
    """(lanes, blocks, patches) of ``net``'s five policies."""
    spec = {"resnet18": T.resnet18_imagenet, "vgg11": T.vgg11_cifar10, "vit_b16": T.vit_b16_imagenet}[net]()
    return policy_lanes(spec), [l.n_blocks for l in spec.layers], [l.patches_per_image for l in spec.layers]


def _vit_b16_work():
    """The layer weights ``kernel_plan`` splits for ViT-B/16's five policies
    (49 layers weighing nearly alike: ties abound)."""
    from repro_torch.kernels import vtime_scan as vtk

    seen, one_pass = [], vtk.stage_splits
    with pytest.MonkeyPatch.context() as m:
        m.setattr(vtk, "stage_splits", lambda work, most: seen.append(list(work)) or one_pass(work, most))
        kernel_plan(*_policy_problem("vit_b16"))
    return seen[0]


def test_vit_b16_plan_unchanged():
    """ViT-B/16's plan for its five policies' lanes (pools of at most 3
    servers: only the thread pools' ``JOB_CYCLES`` weigh it) is the one
    ``kernel_plan`` gave before the warp pools' entries were measured again:
    8 stages, the same split and stage weights."""
    lanes, blocks, patches = _policy_problem("vit_b16")
    assert lanes.max() <= 8
    plan = kernel_plan(lanes, blocks, patches)
    assert (plan.stages, plan.split, plan.stage_weights, plan.kmax) == (
        8, (0, 6, 12, 18, 24, 30, 36, 42, 49), (46776.0,) * 6 + (48932.0, 54572.0), 1)


@pytest.mark.parametrize("kind", ["random", "few-values", "equal", "vit_b16"])
def test_stage_splits_match_the_per_s_dp(kind):
    """One ``stage_splits`` pass gives, for every S from 1 to min(8, L), the
    split the DP rerun for that S gives, for L from 1 to 64: random integer
    works, works of three values and equal works (many equal splits: the
    earliest boundaries win), and ViT-B/16's 49-layer work."""
    from repro_torch.kernels.vtime_scan import stage_splits

    rng = np.random.default_rng(11)
    if kind == "vit_b16":
        works = [_vit_b16_work()]
        assert len(works[0]) == 49 and len(set(works[0])) < 49
    else:
        works = [rng.integers(1, 1000, L) if kind == "random" else rng.integers(1, 4, L) if kind == "few-values"
                 else np.full(L, 7) for L in range(1, 65)]
    for work in works:
        L = len(work)
        split = stage_splits(work, min(8, L))
        assert [split(S) for S in range(1, min(8, L) + 1)] == [_split_dp_ref(work, S) for S in range(1, min(8, L) + 1)]
        with pytest.raises(ValueError):
            split(min(8, L) + 1)


@pytest.mark.parametrize("kw", [{}, dict(stream=True), dict(stages=3), dict(cap=2), dict(cap=4), dict(cap=8)],
                         ids=["free", "stream", "stages3", "clusters2", "clusters4", "clusters8"])
@pytest.mark.parametrize("net", ["vit_b16", "resnet18", "vgg11"])
def test_kernel_plan_equals_the_per_s_dp(net, kw, monkeypatch):
    """Every field of ``kernel_plan``'s plan (split, stage weights, S, state
    stride, shared memory) is the plan the DP rerun for each S gives, on
    the five policies' lanes of each network: free, streaming, at a forced
    S, and with the resident clusters capping S at ``cap``."""
    lanes, blocks, patches = _policy_problem(net)
    kw = dict(kw)
    cap = kw.pop("cap", None)
    if cap is not None:
        kw["clusters"] = lambda S, plan: len(lanes) if S <= cap else 0
    plan = kernel_plan(lanes, blocks, patches, **kw)
    assert plan == _per_s_plan(monkeypatch, lanes, blocks, patches, **kw)
    assert cap is None or plan.stages <= cap


@pytest.mark.parametrize("kw, tried", [({}, 8), (dict(clusters=lambda S, plan: 3 if S <= 2 else 0), 3),
                                       (dict(stages=3), 1)], ids=["every-S", "capped", "forced"])
def test_split_counters(kw, tried):
    """One ``kernel_plan`` call makes one DP pass (``vt.split_passes``) and
    reads a split from it for each S it tries (``vt.split_reads``); with
    telemetry off neither is recorded."""
    from repro_torch.fabric import telemetry as TM

    lanes, blocks, patches = np.full((3, 12), 4), [1] * 12, [100] * 12
    with TM.telemetry_session() as tel:
        kernel_plan(lanes, blocks, patches, **kw)
    assert tel.counters == {"vt.split_passes": 1.0, "vt.split_reads": float(tried)}
    before = dict(TM.PROFILER_TELEMETRY.counters)
    assert TM.get_telemetry() is TM.NULL_TELEMETRY
    kernel_plan(lanes, blocks, patches, **kw)
    assert TM.PROFILER_TELEMETRY.counters == before and not TM.NULL_TELEMETRY.counters


def test_stage_count_chosen_and_capped():
    """S is the smallest count that reaches the least largest stage; it is
    capped by the resident clusters (``clusters``: the card's occupancy
    query, else ``SM_COUNT // S``), so S = 1 when the configs fill the
    card's SMs."""
    from repro_torch.kernels.vtime_scan import SM_COUNT

    blocks, patches = [1, 5, 9, 18, 18, 36, 36, 36], [1024, 256, 64, 64, 16, 16, 4, 4]
    lanes = np.full((15, sum(blocks)), 4)
    lanes[:, 0] = 128
    plan = kernel_plan(lanes, blocks, patches)
    assert plan.stages == 2 and plan.split == (0, 1, 8)  # layer 0 outweighs the other seven together
    uniform = np.full((3, 8), 4)
    assert kernel_plan(uniform, [1] * 8, [100] * 8).stages == 8
    assert kernel_plan(uniform, [1] * 8, [100] * 8, clusters=lambda S, p: 3 if S <= 4 else 2).stages == 4
    assert kernel_plan(uniform, [1] * 8, [100] * 8, clusters=lambda S, p: 2).stages == 1
    assert kernel_plan(np.full((200, 8), 4), [1] * 8, [100] * 8, clusters=lambda S, p: 400 // S).stages == 2
    assert kernel_plan(np.full((SM_COUNT, 8), 4), [1] * 8, [100] * 8).stages == 1
    assert kernel_plan(np.full((SM_COUNT - 1, 8), 4), [1] * 8, [100] * 8).stages == 1  # 2 x 131 blocks do not fit
    assert kernel_plan(np.full((30, 8), 4), [1] * 8, [100] * 8).stages == 4  # 30 clusters of 4 fit 132 SMs


def _brute_path(w, N, conc):
    """The longest path through the (r, l) DAG by memoised recursion over
    its edges: (r-1, l), (r, l-1) and, closed loop, (r-conc, L-1) -> (r, 0)."""
    L = len(w)

    @functools.cache
    def T(r, l):
        preds = []
        if r > 0:
            preds.append(T(r - 1, l))
        if l > 0:
            preds.append(T(r, l - 1))
        if l == 0 and conc is not None and r >= conc:
            preds.append(T(r - conc, L - 1))
        return max(preds, default=0.0) + w[l]

    return max(T(r, l) for r in range(N) for l in range(L))


@pytest.mark.parametrize("conc", [None, 1, 2, 3, 4], ids=["open", "c1", "c2", "c3", "c4"])
@pytest.mark.parametrize("seed", range(3))
def test_critical_path_matches_brute_force(conc, seed):
    """``critical_path`` equals a brute-force longest path over the (request,
    layer) DAG, in job steps and with per-layer weights."""
    from repro_torch.kernels.vtime_scan import critical_path

    rng = np.random.default_rng(seed)
    L, N = int(rng.integers(1, 6)), int(rng.integers(1, 12))
    jobs = rng.integers(1, 50, L)
    weights = rng.random(L) * 3
    assert critical_path(jobs, N, conc) == _brute_path(list(jobs.astype(float)), N, conc)
    assert critical_path(jobs, N, conc, weights) == pytest.approx(_brute_path(list(jobs * weights), N, conc),
                                                                  rel=1e-12)


@pytest.mark.parametrize("L, conc", [(1, None), (1, 3), (4, 1), (6, 1)])
def test_critical_path_serial_cases(L, conc):
    """One layer, or one request in flight: the path is every job, N x sum."""
    from repro_torch.kernels.vtime_scan import critical_path

    jobs = np.arange(1, L + 1) * 7
    assert critical_path(jobs, 9, conc) == 9 * jobs.sum()


def test_critical_path_of_the_fabric_cells():
    """fabric_tail (VGG11, 400 open-loop requests): 1,448 + 399 x 1,024 job
    steps against 579,200 serial; ResNet18's ClosedLoop(120, 40): 30,233 +
    119 x 12,544."""
    from repro_torch.kernels.vtime_scan import critical_path

    vgg = [l.patches_per_image for l in T.vgg11_cifar10().layers]
    assert sum(vgg) == 1448
    assert critical_path(vgg, 400) == 1448 + 399 * 1024 == 410_024
    r18 = [l.patches_per_image for l in T.resnet18_imagenet().layers]
    assert sum(r18) == 30_233
    assert critical_path(r18, 120, 40) == 30_233 + 119 * 12_544


def test_chain_weights():
    from repro_torch.kernels.vtime_scan import chain_weights

    lanes = np.array([[1, 0, 2, 1], [1, 1, 0, 0]])
    np.testing.assert_array_equal(chain_weights(lanes, [2, 2], 5.0, 11.0), [[5.0, 11.0], [5.0, 5.0]])


def test_vtime_scan_checks_inputs():
    one = torch.ones((1, 4, 2), dtype=torch.float64)
    tables = vt_tables([one])
    idx = torch.zeros(3 * 5, dtype=torch.int32)
    var, lanes = np.zeros(2, dtype=np.int32), np.ones((2, 2), dtype=np.int32)
    with pytest.raises(ValueError, match="not both"):
        vtime_scan(tables, idx, [5], var, lanes, n_requests=3)
    with pytest.raises(ValueError, match="lanes"):
        vtime_scan(tables, idx, [5], var, lanes[:, :1], n_requests=3, concurrency=2)
    with pytest.raises(ValueError, match="out of range"):
        vtime_scan(tables, idx + 4, [5], var, lanes, n_requests=3, concurrency=2)
    with pytest.raises(ValueError, match="variant"):
        vtime_scan(tables, idx, [5], var + 1, lanes, n_requests=3, concurrency=2)
    for bad in (-one, one * float("nan")):  # checked once, where the tables are packed
        with pytest.raises(ValueError, match=">= 0"):
            vt_tables([bad])
    with pytest.raises(ValueError, match="lanes"):
        vtime_scan(tables, idx, [5], var, lanes * 70_000, n_requests=3, concurrency=2)
    with pytest.raises(ValueError, match="idx"):
        vtime_scan(tables, idx[:10], [5], var, lanes, n_requests=3, concurrency=2)
    with pytest.raises(ValueError, match="patches"):
        vtime_scan(tables, idx, [5, 5], var, lanes, n_requests=3, concurrency=2)
    with pytest.raises(TypeError, match="vt_tables"):
        vtime_scan([one], idx, [5], var, lanes, n_requests=3, concurrency=2)
    t_arr, comp, busy, wait = vtime_scan(tables, idx, [5], var, lanes, n_requests=3, concurrency=1)
    # one server a pool, 5 jobs of 1 cycle each, one request at a time
    np.testing.assert_array_equal(comp.numpy(), [[5.0, 10.0, 15.0]] * 2)
    np.testing.assert_array_equal(t_arr.numpy(), [[0.0, 5.0, 10.0]] * 2)
    assert busy is None and wait is None


# ------------------------------------------- the layout the launches read
def _per_call_layout(tables, idx, n_requests):
    """The buffers the launches read as they were built on every call before
    the tables were packed once: per-layer tables and (n_requests, P_l)
    indices concatenated, the tables' (L, V) offsets and the (L, 5) meta."""
    V = tables[0].shape[0]
    blocks = torch.tensor([t.shape[2] for t in tables], dtype=torch.int64)
    pt = torch.tensor([i.shape[1] for i in idx], dtype=torch.int64)
    sizes = torch.tensor([t.numel() for t in tables], dtype=torch.int64)
    per_v = torch.tensor([t.shape[1] * t.shape[2] for t in tables], dtype=torch.int64)
    tbl_off = (torch.cumsum(sizes, 0) - sizes)[:, None] + torch.arange(V)[None, :] * per_v[:, None]
    idx_sizes = pt * int(n_requests)
    meta = torch.stack([blocks, pt, torch.cumsum(blocks, 0) - blocks, torch.cumsum(idx_sizes, 0) - idx_sizes,
                        torch.tensor([t.shape[1] for t in tables], dtype=torch.int64)], dim=1)
    return torch.cat([t.reshape(-1) for t in tables]), tbl_off, meta, torch.cat([i.reshape(-1) for i in idx])


def _shaped(net: str, n: int):
    """A VT problem of ``net``'s shapes: random integer (4, S_l, B_l) tables
    at S_l = min(128, P_l), (n, P_l) indices and the five policies' lanes."""
    lanes, blocks, patches = _policy_problem(net)
    rng = np.random.default_rng(0)
    samples = [min(128, p) for p in patches]
    tables = [torch.as_tensor(np.floor(rng.random((4, s, b)) * 400.0)) for s, b in zip(samples, blocks)]
    idx = [torch.as_tensor(rng.integers(0, s, (n, p)), dtype=torch.int32) for s, p in zip(samples, patches)]
    return tables, idx, patches, rng.integers(0, 4, len(lanes)), lanes


def _same_bytes(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("net", ["vgg11", "resnet18", "vit_b16"])
def test_launch_reads_the_per_call_buffers(net):
    """What VT's launch reads is byte for byte what the per-call
    concatenation built: the packed tables and their offsets, the draw's
    flat indices as they come, the meta, and the variant and lanes as
    int32."""
    from repro_torch.kernels import vtime_scan as vtk

    n = 3
    tables, idx, patches, var, lanes = _shaped(net, n)
    p = vtk._prepare(vt_tables(tables), _flat(idx, "cpu"), patches, var, lanes, n, None, 2, None)
    for got, want in zip((p.tables.flat, p.tables.tbl_off, p.meta, p.idx), _per_call_layout(tables, idx, n)):
        assert _same_bytes(got, want)
    assert _same_bytes(p.variant, torch.as_tensor(var, dtype=torch.int32))
    assert _same_bytes(p.lanes, torch.as_tensor(lanes, dtype=torch.int32))


@pytest.mark.parametrize("mode", ["presampled", "hashed"])
def test_stream_launch_reads_the_per_call_buffers(mode):
    """A streaming segment of requests 2 to 5 of 7 on VGG11's shapes.  With
    presampled indices the launch takes the whole flat buffer and meta's
    index offsets start at request r0 = 2, so every row the kernel reads
    (``idx + io_l + r * P_l``, r from 0) is the row of the segment's own
    concatenation; the tables, their offsets and meta's other columns are
    the per-call concatenation's byte for byte (with hashed indices all of
    meta)."""
    from repro_torch.kernels import vtime_scan as vtk

    r0, n = 2, 4
    tables, idx, patches, var, lanes = _shaped("vgg11", 7)
    carry = vtk.stream_state(lanes, lanes, n_bins=8, device="cpu")
    presampled = mode == "presampled"
    salts, flat_idx = (None, _flat(idx, "cpu")) if presampled else (list(range(len(patches))), None)
    s = vtk._prepare_stream(vt_tables(tables), var, lanes, carry, n, patches, salts, flat_idx, None, r0,
                            torch.zeros((len(lanes), n), dtype=torch.float64), None, None, (32, 0))
    flat, tbl_off, meta, seg_idx = _per_call_layout(tables, [i[r0 : r0 + n] for i in idx], n)
    p = s.p
    assert _same_bytes(p.tables.flat, flat) and _same_bytes(p.tables.tbl_off, tbl_off)
    if not presampled:
        assert p.idx is None and _same_bytes(p.meta, meta)
        return
    cols = [0, 1, 2, 4]
    assert _same_bytes(p.meta[:, cols].contiguous(), meta[:, cols].contiguous())
    for l, P in enumerate(patches):
        a, b = int(p.meta[l, 3]), int(meta[l, 3])
        assert _same_bytes(p.idx[a : a + n * P], seg_idx[b : b + n * P])


@pytest.mark.parametrize("net", ["vgg11", "resnet18", "vit_b16"])
def test_kernel_plan_reads_the_lanes_host_copy(net, monkeypatch):
    """``kernel_plan`` gets, for both entries, the lanes the launch reads as
    the int32 host array a readback of them gave, with the same blocks and
    patches, and returns the plan it returns for those."""
    from repro_torch.kernels import vtime_scan as vtk

    tables, idx, patches, var, lanes = _shaped(net, 2)
    seen, real = [], vtk.kernel_plan
    monkeypatch.setattr(vtk, "kernel_plan", lambda *a, **kw: seen.append((a, kw)) or real(*a, **kw))
    plans = [vtk._pack(vtk._prepare(vt_tables(tables), _flat(idx, "cpu"), patches, var, lanes, 2, None, 2, None)).plan]
    carry = vtk.stream_state(lanes, lanes, n_bins=8, ring_len=2, device="cpu")
    plans.append(vtk._stream_plan(vtk._prepare_stream(vt_tables(tables), var, lanes, carry, 2, patches,
                                                      [1] * len(patches), None, None, 0, None, 2, None, (32, 0))))
    readback = torch.as_tensor(lanes, dtype=torch.int32).numpy()
    blocks = [t.shape[2] for t in tables]
    assert len(seen) == 2
    for (args, kw), plan in zip(seen, plans):
        assert args[0].dtype == np.int32 and np.array_equal(args[0], readback)
        assert list(args[1]) == blocks and list(args[2]) == patches
        assert plan == real(readback, blocks, patches, **kw)
    np.testing.assert_array_equal(seen[1][1]["jobs"], np.broadcast_to(patches, lanes.shape[:1] + (len(patches),)))


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


def _flat(idx, device):
    """Per-layer (N, P_l) indices as VT's flat int32 buffer on ``device``."""
    return torch.as_tensor(np.concatenate([np.asarray(i).ravel() for i in idx]).astype(np.int32), device=device)


@pytest.fixture
def force_stages(monkeypatch):
    """Make every VT launch of the test run at S stages (``kernel_plan``'s
    explicit count, which no entry point exposes)."""
    from repro_torch.kernels import vtime_scan as vtk

    def force(S):
        monkeypatch.setattr(vtk, "kernel_plan", functools.partial(kernel_plan, stages=S))
    return force


_HOST = {}


def _vt_card_case(case, dev):
    """(spec, profile, allocations, process, live profile, placements, the
    host FabricSim's results) of one card case, the host's run once."""
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
    if case not in _HOST:
        _HOST[case] = [TF.FabricSim(spec, prof, a, seed=3, live_prof=live,
                                    placement=None if places is None else places[k]).run(proc)
                       for k, a in enumerate(allocs)]
        if case == "stats":
            _HOST["stats_numpy"] = TF.VirtualTimeFabric(spec, prof, device=dev).run_batch(
                allocs, proc, seed=3, engine="numpy", collect_stats=True)
    return spec, prof, allocs, proc, live, places, _HOST[case]


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["open", "closed", "closed1", "stats", "placements", "fractional"])
def test_vt_run_batch_on_card(case, stages, force_stages):
    """``run_batch(engine="torch")`` on the card at S = 1, 2, 4 and 8 stages
    of VGG11's 8 layers: one VT launch for the six policies; completions
    equal to FabricSim's on the host, and with stats the sums at rtol 1e-12
    of the numpy engine."""
    dev = _card()
    force_stages(stages)
    spec, prof, allocs, proc, live, places, want = _vt_card_case(case, dev)
    vt = TF.VirtualTimeFabric(spec, prof, live_prof=live, device=dev)
    before = vtime_scan.launches
    res = vt.run_batch(allocs, proc, seed=3, placements=places, collect_stats=case == "stats")
    torch.cuda.synchronize()
    assert vtime_scan.launches == before + 1
    for k, w in enumerate(want):
        np.testing.assert_array_equal(res.completions[k], w.completions)
        np.testing.assert_array_equal(res.arrivals[k], w.arrivals)
    if case == "stats":
        host = _HOST["stats_numpy"]
        np.testing.assert_allclose(res.layer_busy, host.layer_busy, rtol=1e-12, atol=0)
        np.testing.assert_allclose(res.layer_wait, host.layer_wait, rtol=1e-12, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [1, 2, 4, 8])
@pytest.mark.parametrize("max_lanes", [1, 6, 40, 300, 1500, 4096, 65_536])
def test_vt_equals_plain_on_card(max_lanes, stages, force_stages):
    """VT against its plain version on the card on random problems of 8
    layers at S = 1, 2, 4 and 8 stages (every (K, G) class up to 32 lanes a
    thread over 32 threads, and pools wider than 1,024 whose lanes stay in
    the pool state, up to ``MAX_LANES``, where the state no longer fits in
    shared memory; pools without servers; fractional cycles; transfers;
    stats; open and closed loop).  The first pool of the first config
    holds ``max_lanes`` servers."""
    dev = _card()
    from repro_torch.kernels import vtime_scan as vtk

    rng = np.random.default_rng(max_lanes)
    L, V, C, N = 8, 3, 7, 9
    shapes = [(int(rng.integers(1, 40)), int(rng.integers(1, 20)), int(rng.integers(0, 30))) for _ in range(L)]
    tables = vt_tables([torch.as_tensor(rng.random((V, s, b)) * 100.0, device=dev) for s, b, _ in shapes])
    idx = _flat([rng.integers(0, s, (N, p)) for s, _, p in shapes], dev)
    patches = [p for _, _, p in shapes]
    n_pools = sum(b for _, b, _ in shapes)
    lanes = rng.integers(0, max_lanes + 1, (C, n_pools))
    lanes[0, 0] = max_lanes
    var = rng.integers(0, V, C)
    xfer = torch.as_tensor(rng.random((C, L)) * 50.0, device=dev)
    arr = torch.as_tensor(np.cumsum(rng.exponential(300.0, (C, N)), axis=1), device=dev)
    force_stages(stages)
    for kw in (dict(arrivals=arr), dict(concurrency=3, xfer=xfer)):
        p = vtk._prepare(tables, idx, patches, var, lanes, N, kw.get("arrivals"), kw.get("concurrency"),
                         kw.get("xfer"))
        packed = vtk._pack(p, True)
        assert packed.plan.stages == stages
        if max_lanes > 512:
            assert packed.plan.kmax == 32
        if max_lanes > 4096:
            assert not packed.plan.smem_state
        got = vtk._launch(packed, True)
        want = vtime_scan_ref(tables, idx, patches, var, lanes, n_requests=N, collect_stats=True, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g, w)
        for g, w in zip(got[2:], want[2:]):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [1, 3])
@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
def test_vt_multi_chunk_layers_on_card(closed, stages, force_stages):
    """Layers of several staging chunks (6 pools x 700 jobs, 9 x 400), one
    wide pool beside warps that have none: a warp without pools runs chunks
    ahead of the busy one, and no buffer is restaged before every warp is
    done with it.  VT equals its plain version, open and closed loop."""
    dev = _card()
    from repro_torch.kernels import vtime_scan as vtk

    rng = np.random.default_rng(5)
    V, C, N = 2, 3, 6
    shapes = [(30, 6, 700), (12, 3, 20), (20, 9, 400)]
    tables = vt_tables([torch.as_tensor(rng.random((V, s, b)) * 100.0, device=dev) for s, b, _ in shapes])
    idx = _flat([rng.integers(0, s, (N, p)) for s, _, p in shapes], dev)
    patches = [p for _, _, p in shapes]
    lanes = rng.integers(0, 3, (C, 18))
    lanes[:, 0], lanes[:, 9] = 300, 40
    var = rng.integers(0, V, C)
    kw = dict(concurrency=2) if closed else dict(
        arrivals=torch.as_tensor(np.cumsum(rng.exponential(3e4, (C, N)), axis=1), device=dev))
    p = vtk._prepare(tables, idx, patches, var, lanes, N, kw.get("arrivals"), kw.get("concurrency"), None)
    force_stages(stages)
    packed = vtk._pack(p, True)
    assert packed.plan.chunk < 6 * 700 and packed.plan.chunk < 9 * 400
    got = vtk._launch(packed, True)
    want = vtime_scan_ref(tables, idx, patches, var, lanes, n_requests=N, collect_stats=True, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
def test_refused_launch_raises(force_stages):
    """A cluster launch the card refuses raises; it never runs at fewer
    stages: 9 blocks a cluster (more than the portable 8), and a split that
    leaves a stage no layer."""
    dev = _card()
    from repro_torch.kernels import vtime_scan as vtk

    rng = np.random.default_rng(0)
    L, N = 9, 4
    tables = vt_tables([torch.as_tensor(rng.random((1, 8, 2)) * 100.0, device=dev) for _ in range(L)])
    idx = _flat([rng.integers(0, 8, (N, 5)) for _ in range(L)], dev)
    lanes, var = np.full((3, 2 * L), 2), np.zeros(3, dtype=np.int32)
    p = vtk._prepare(tables, idx, [5] * L, var, lanes, N, None, 2, None)
    force_stages(8)
    packed = vtk._pack(p)
    before = vtime_scan.launches
    for plan in (packed.plan._replace(stages=9, split=tuple(range(10))),
                 packed.plan._replace(split=(0, 1, 2, 3, 4, 5, 6, 6, 9))):
        with pytest.raises(RuntimeError, match="launch failed"):
            vtk._launch(packed._replace(plan=plan), False)
    assert vtime_scan.launches == before
    got = vtk._launch(packed, False)  # the card is still usable
    want = vtime_scan_ref(tables, idx, [5] * L, var, lanes, n_requests=N, concurrency=2)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_launch_bounds_on_card():
    """``kernel_plan`` on the card takes each build's launch bound from the
    library (``vtime_max_threads``): 12 warps for KMAX 1 and 4, 8 for the
    wider builds, 6 for VT's KMAX 16 build without stats (two blocks an
    SM); the 36 pools of a layer then get 10, 6 or 4 consumer warps."""
    dev = _card()
    from repro_torch.kernels import vtime_scan as vtk

    want = {(1, False, False): 12, (4, True, False): 12, (16, False, False): 6, (16, True, False): 8,
            (16, False, True): 8, (32, False, False): 8, (32, False, True): 8}
    got = {key: vtk._limits(dev, key[2], key[1])["warps"](key[0]) for key in want}
    assert got == want
    for d, stats, consumers in ((9, False, 10), (222, False, 4), (222, True, 6)):
        plan = kernel_plan(np.full((2, 40), d), [4, 36], [64, 64], **vtk._limits(dev, False, stats))
        assert plan.consumer_warps == consumers


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


def _merge_problem(d, kind, dev):
    """Two layers, a pool of d servers in each beside small ones (the
    second's wider by 7, or narrower by 7 where wider would pass 512 and
    so take the KMAX 32 build; beside a pool of 217 where d is wider than
    512, so that the KMAX 32 build merges one), 2 variants; P_0 a few
    chunks' worth of jobs, enough for the pools to merge epochs."""
    rng = np.random.default_rng(d + 100 * len(kind))
    blocks, patches, N, C = [2, 3], [2100 if d > 32 else 2 * d + 37, 90], 5, 3
    tables = vt_tables([torch.as_tensor(_spread_services(kind, rng, 2 * 64 * b).reshape(2, 64, b), device=dev)
                        for b in blocks])
    idx = [rng.integers(0, 64, (N, p)) for p in patches]
    d2 = d - 7 if d <= 512 < d + 7 else d + 7
    lanes = np.array([[d, 3, 1, d2, 5], [d, 0, 2, 9 if d <= 512 else 217, 2], [5, 2, 1, d, 3]])
    return tables, idx, patches, np.array([0, 1, 1]), lanes, N, C


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["narrow", "wide", "ties-zeros"])
@pytest.mark.parametrize("d", [9, 31, 32, 33, 47, 64, 65, 100, 163, 217, 400, 512, 1024])
def test_merged_pools_equal_plain_on_card(d, kind):
    """VT bit for bit (max abs diff 0) against its plain version on pools of
    9 to 1,024 servers (33 to 512 merge epochs; every shape of merge_epoch
    runs: 33 to 85, 86 to 128, 129 to 170, 171 to 256 and 257 to 512
    servers), service tables of narrow
    spread (ends near the top), wide spread, and ties and zeros (ends below
    an epoch's last pop): open and closed loop, with and without stats; and
    the streaming entry over two launches that carry the lanes against its
    plain version."""
    dev = _card()
    from repro_torch.kernels import vtime_scan as vtk

    tables, idx, patches, var, lanes, N, C = _merge_problem(d, kind, dev)
    host = vt_tables([tables.layer(l).cpu() for l in range(2)])
    flat, hflat = _flat(idx, dev), _flat(idx, "cpu")
    rng = np.random.default_rng(d)
    arr = np.cumsum(rng.exponential(40.0 * patches[0], (C, N)), axis=1)
    for kw in (dict(arrivals=arr), dict(concurrency=2)):
        a = kw.get("arrivals")
        want = vtime_scan_ref(host, hflat, patches, var, lanes, n_requests=N, collect_stats=True,
                              arrivals=None if a is None else torch.as_tensor(a), concurrency=kw.get("concurrency"))
        for stats in (False, True):
            got = vtime_scan(tables, flat, patches, var, lanes, n_requests=N, collect_stats=stats,
                             arrivals=None if a is None else torch.as_tensor(a, device=dev),
                             concurrency=kw.get("concurrency"))
            for g, w in zip(got[:2], want[:2]):
                assert float((g.cpu() - w).abs().max()) == 0.0
            if stats:
                for g, w in zip(got[2:], want[2:]):
                    torch.testing.assert_close(g.cpu(), w, rtol=1e-12, atol=1e-9)
    out = {}
    for where, tb, ix in (("card", tables, flat), ("host", host, hflat)):
        carry = vtk.stream_state(lanes, lanes, n_bins=16, ring_len=2, device=dev if where == "card" else "cpu")
        ys = []
        for r0, n in ((0, 2), (2, 3)):
            fn = vtk.vtime_stream if where == "card" else vtk.vtime_stream_ref
            carry, y = fn(tb, var, lanes, carry, n_requests=n, patches=patches, idx=ix, r0=r0, concurrency=2,
                          emit=True)
            ys.append(y)
        out[where] = (carry, ys)
    for g, w in zip(out["card"][0], out["host"][0]):  # lanes (+inf: absent), ring, sketch, moments, horizon
        assert torch.equal(g.cpu(), w)
    for yg, yw in zip(out["card"][1], out["host"][1]):
        for g, w in zip(yg, yw):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["narrow", "ties-zeros"])
def test_deep_inserts_counted_on_card(kind):
    """``vt.deep_inserts`` counts, while telemetry records, the jobs that
    epochs cut short by a deep insert sent one by one, as ``_merged_chunk``
    replays them on the host (one chunk a request); a pool of 32 servers
    or fewer counts none; not recording, nothing is counted."""
    dev = _card()
    from repro_torch.fabric import telemetry as TM
    from repro_torch.kernels import vtime_scan as vtk

    rng = np.random.default_rng(4)
    d, P, N = 217, 1100, 4
    tables = vt_tables([torch.as_tensor(_spread_services(kind, rng, 64).reshape(1, 64, 1), device=dev)])
    idx = rng.integers(0, 64, (N, P))
    arr = np.cumsum(rng.exponential(150.0 * P / d, (1, N)), axis=1)
    svc = tables.layer(0).cpu().numpy()[0, :, 0][idx]
    st, want = np.zeros(d), 0
    for r in range(N):
        want += _merged_chunk(st, d, float(arr[0, r]), svc[r])[2]
    for lanes, expect in (([[d]], want), ([[32]], 0)):
        with TM.telemetry_session() as tel:
            vtime_scan(tables, _flat([idx], dev), [P], [0], np.array(lanes), n_requests=N,
                       arrivals=torch.as_tensor(arr, device=dev))
            vtk.count_deep_inserts()
        assert tel.counters.get("vt.deep_inserts", 0.0) == expect
    vtime_scan(tables, _flat([idx], dev), [P], [0], np.array([[d]]), n_requests=N,
               arrivals=torch.as_tensor(arr, device=dev))
    assert not vtk._DEEP and (want > 0 or kind == "narrow")

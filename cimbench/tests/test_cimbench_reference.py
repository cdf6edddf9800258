"""The plain reference at tiny sizes: the cycle model by hand, the event
engine against the program's host engines, the allocators against the
program's on the same profile."""

import json

import numpy as np
import pytest

from cimbench.inputs import make_inputs
from cimbench.reference import cim, fabric
from cimbench.reference.capture import capture, tf32
from cimbench.tests.tiny import ROOT

CFG = json.loads((ROOT / "cimbench" / "configs" / "vgg11.json").read_text())


def test_cycles_by_hand():
    geo = cim.Geometry.of({"layers": [{"kernel": 1, "cin": 10, "cout": 16, "out_hw": 1}], "array": CFG["array"]},
                          rows=8, adc_bits=1)  # blocks of 8 rows and 2 rows; 2 rows a read
    q = np.zeros((2, 10), dtype=np.uint8)
    q[0, :5] = 0xFF  # block 0: 5 ones in every plane -> 3 reads a plane
    q[1, 8] = 0x01  # block 1: one '1' in the last plane; empty planes still read once
    prof = cim.derive(geo, [q])
    assert prof.cycles[0].tolist() == [[8 * 8 * 3, 8 * 8], [8 * 8, 8 * 8]]
    assert prof.baseline[0].tolist() == [8 * 8 * 4, 8 * 8 * 1]


def test_geometry_matches_the_paper():
    r18 = json.loads((ROOT / "cimbench" / "configs" / "resnet18.json").read_text())
    g = cim.Geometry.of(r18)
    assert (g.n_arrays, sum(g.n_blocks(i) for i in range(g.L)), g.min_pes()) == (5472, 247, 86)
    assert cim.Geometry.of(CFG).min_pes() == 71


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, 3.0e-3], dtype=np.float32)
    y = tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0  # a tie rounds to even
    assert y[2] == np.float32(1.0 + 2**-10)
    assert abs(y[3] / x[3] - 1) < 2**-11


def test_greedy_by_hand():
    # latencies 8, 6, 1 at cost 1 each, budget 3: the slowest gets a replica each time
    assert cim.greedy_allocate([8.0, 6.0, 1.0], [1.0, 1.0, 1.0], 3).tolist() == [3, 2, 1]
    # the slowest unit costs more than is left: stop, even if a cheaper one fits
    assert cim.greedy_allocate([8.0, 1.0], [5.0, 1.0], 4).tolist() == [1, 1]


def test_event_engine_by_hand():
    # one layer, one pool of two servers, three jobs of 4, 2, 3 cycles at t = 1
    tables = [np.array([[4.0], [2.0], [3.0]])]
    idx = [np.array([[0, 1, 2]])]
    t, c = fabric.simulate(tables, [np.array([2])], idx, arrivals=np.array([1.0]))
    # jobs start 1, 1, 3 (after the 2-cycle job): ends 5, 3, 6
    assert c.tolist() == [6.0]
    # closed loop of one client: the second request enters when the first leaves
    t, c = fabric.simulate(tables, [np.array([1])], [np.array([[0, 1, 2], [0, 0, 0]])], concurrency=1, n=2)
    assert t.tolist() == [0.0, 9.0] and c.tolist() == [9.0, 21.0]


@pytest.fixture(scope="module")
def vgg():
    import repro_torch as T

    im, w = make_inputs(CFG, 1, 7, "cpu")
    spec = T.vgg11_cifar10()
    cap = T.capture_activations(spec, n_images=1, sample_patches=16, batch_images=None, images=im, weights=w,
                                device="cpu")
    return im, w, spec, cap, T.derive_profile(cap, spec)


def test_capture_first_layers_agree(vgg):
    from cimbench.harness import _load_py

    im, w, spec, cap, _ = vgg
    fwd = _load_py(ROOT / "cimbench" / "configs" / "vgg11.py", "ref_vgg11").forward
    rowbits, sampled = capture(CFG["layers"], fwd, im.numpy(), [x.numpy() for x in w], 16)
    assert np.array_equal(rowbits[0], cap.layers[0].rowbits.numpy())  # no product before layer 0
    assert np.array_equal(sampled[0], cap.layers[0].sampled_q.numpy())
    for i in (1, 2):
        assert np.mean(sampled[i] != cap.layers[i].sampled_q.numpy()) < 0.01


def test_profile_allocations_and_fabric_agree(vgg):
    import repro_torch as T
    from repro_torch.fabric import PoissonOpen, VirtualTimeFabric

    _, _, spec, cap, prof = vgg
    ref = cim.derive(cim.Geometry.of(CFG), [c.sampled_q.numpy() for c in cap.layers])
    for lp, c in zip(prof.layers, ref.cycles):
        assert np.array_equal(lp.cycles_sample.numpy(), c)
    pes = 2 * spec.min_pes()
    allocs, refs = [], []
    for p in cim.POLICIES:
        a, r = T.allocate(spec, prof, p, pes), cim.allocate(ref, p, pes)
        assert a.arrays_used == r.arrays_used
        got = a.layer_dups if a.layer_dups is not None else np.concatenate(a.block_dups)
        want = r.layer_dups if r.layerwise else np.concatenate(r.block_dups)
        assert np.array_equal(got, want), p
        T_, ips, util = cim.analytic(ref, r)
        s = T.simulate(spec, prof, a)
        assert ips == pytest.approx(s.images_per_sec, rel=1e-13) and T_ == pytest.approx(s.total_cycles, rel=1e-13)
        assert util == pytest.approx(s.mean_utilization, rel=1e-12)
        allocs.append(a)
        refs.append(r)
    bw = refs[cim.POLICIES.index("blockwise")]
    _, cap_ips, _ = cim.analytic(ref, bw)
    la = cim.allocate(ref, "latency_aware", pes, offered_ips=0.6 * cap_ips)
    a = T.allocate(spec, prof, "latency_aware", pes, offered_ips=0.6 * cap_ips)
    assert np.array_equal(np.concatenate(a.block_dups), np.concatenate(la.block_dups))
    # the program's host run of VT (its plain version) against the event engine
    n = 5
    proc = PoissonOpen(n, 0.6 * cap_ips / 1e8, seed=3)
    res = VirtualTimeFabric(spec, prof, device="cpu").run_batch(allocs[:2] + allocs[3:4], proc, seed=4)
    times = fabric.poisson_times(3, n, 0.6 * cap_ips / 1e8)
    idx = fabric.service_indices(4, [(c.shape[0], l["out_hw"] ** 2) for c, l in zip(ref.cycles, CFG["layers"])], n)
    for k, r in enumerate(refs[:2] + refs[3:4]):
        t, c = fabric.simulate([ref.table(i, r.zskip) for i in range(len(CFG["layers"]))], r.lanes(ref.geo), idx,
                               arrivals=times)
        assert np.array_equal(res.completions[k], c) and np.array_equal(res.arrivals[k], t)
        assert np.array_equal(res.percentiles[k], fabric.percentiles(t, c))
    # the control's float32 engine reads otherwise
    t32, c32 = fabric.simulate([ref.table(i, True) for i in range(len(CFG["layers"]))], refs[3].lanes(ref.geo), idx,
                               arrivals=times, dtype=np.float32)
    assert not np.array_equal(c32.astype(np.float64), res.completions[2])

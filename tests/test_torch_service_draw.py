"""The service-index draw on the card (``kernels.service_draw``,
``csrc/service_draw.cu``) is numpy's draw, bit for bit.

On the host: the plan's walk and a Python-integer model of the kernel's
arithmetic, thread by thread (``service_draw_ref``: the jump-ahead, the
halves, the half a layer hands to the next), equal
``default_rng(seed).integers(0, S_l, (n, ppi_l))`` layer after layer, over
odd counts, layers of one sample, layers of other sample counts between
powers of two, and the benchmark cells' layers.  The plan sends exactly the
layers whose S is not a power of two to numpy: ResNet18's five 7x7 ones.

On the card (marker ``cuda``): the kernel's buffer equals
``upload_indices(sample_service_indices(...))`` at the cells' sizes, one
launch a draw; ``run_batch`` and ``fabric_percentiles`` give the same
results through either draw; the draw's spans and counters.
"""

import numpy as np
import pytest
import torch

import repro_torch as T
import repro_torch.fabric as TF
from repro_torch.core.cim.profile import LayerProfile, NetworkProfile
from repro_torch.fabric import telemetry as TM
from repro_torch.fabric import vtime as TV
from repro_torch.kernels import service_draw as SD

RESNET18_PPI = [l.patches_per_image for l in T.resnet18_imagenet().layers]
VGG11_PPI = [l.patches_per_image for l in T.vgg11_cifar10().layers]


def _dims(cell):
    """(S_l, ppi_l) of a benchmark cell's profile: S_l = min(samples,
    patches of the layer over the cell's images)."""
    if cell == "vgg11":  # 2 images, 128 samples
        return [(min(128, 2 * p), p) for p in VGG11_PPI]
    samples = {"resnet18_s64": 64, "resnet18_s128": 128}[cell]  # 1 image
    return [(min(samples, p), p) for p in RESNET18_PPI]


def _numpy(seed, dims, n):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, s, size=(n, p)).ravel() for s, p in dims]).astype(np.int32)


CASES = {
    "odd_counts": ([(8, 3), (16, 5), (2, 7), (128, 1), (4, 9)], 3),
    "one_sample": ([(1, 5), (4, 3), (1, 2), (1, 1), (32, 7), (1, 4)], 3),
    "other_samples": ([(64, 3), (49, 5), (16, 3), (100, 7), (2, 1), (49, 2), (8, 3)], 3),
    "runs_of_other_samples": ([(49, 3), (49, 4), (100, 2), (100, 1), (16, 3), (49, 2), (49, 5), (3, 1)], 3),
    "long_layer": ([(128, 3 * SD.UNITS + 5), (49, 7), (32, SD.UNITS + 1)], 3),
    "vgg11": (_dims("vgg11"), 2),
    "resnet18_s64": (_dims("resnet18_s64"), 1),
    "resnet18_s128": (_dims("resnet18_s128"), 1),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", range(10))
def test_kernel_model_equals_numpy(seed, case):
    dims, n = CASES[case]
    plan = SD.draw_plan(seed, dims, n)
    assert plan.total == n * sum(p for _, p in dims)
    np.testing.assert_array_equal(SD.service_draw_ref(plan), _numpy(seed, dims, n))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**40 + 3])
def test_jump_and_output_are_numpys(seed):
    """``jump`` is k single steps, and ``pcg_output`` of the stepped state is
    PCG64's raw output."""
    bg = np.random.default_rng(seed).bit_generator
    st = bg.state["state"]
    s, inc = st["state"], st["inc"]
    raw = bg.random_raw(40)
    step = s
    for k in range(1, 41):
        step = (step * SD.MULT + inc) % (1 << 128)
        assert SD.jump(s, inc, k) == step
        assert SD.pcg_output(step) == int(raw[k - 1])
    assert SD.jump(s, inc, 1000) == SD.jump(SD.jump(s, inc, 999), inc, 1)


@pytest.mark.parametrize("cell", ["resnet18_s64", "resnet18_s128", "vgg11"])
def test_plan_routes_only_other_sample_counts_to_numpy(cell):
    """ResNet18's five 7x7 layers (S = 49), 245 of 30,233 indices a
    request, are numpy's; every other layer of the cells is the kernel's."""
    dims = _dims(cell)
    plan = SD.draw_plan(3, dims, 4)
    host = [k for k, layer in enumerate(plan.layers) if layer.mode == SD.COPY]
    assert all(layer.mode == SD.DRAW for k, layer in enumerate(plan.layers) if k not in host)
    if cell == "vgg11":
        assert host == [] and plan.host.size == 0
    else:
        assert host == [15, 16, 17, 18, 19] and [dims[k][0] for k in host] == [49] * 5
        assert plan.host.size == 4 * 245 and plan.total == 4 * 30_233


@pytest.mark.parametrize("samples", [3, 49, 100, 1])
def test_wrapper_refuses_what_the_kernel_cannot_draw(samples):
    """A layer handed to the kernel as drawn must have a power of two of at
    least 2 samples; the wrapper raises before any launch."""
    plan = SD.draw_plan(1, [(8, 4), (64, 3)], 2)
    bad = plan._replace(layers=(plan.layers[0], plan.layers[1]._replace(samples=samples)))
    with pytest.raises(ValueError, match="powers of two"):
        SD.service_draw(bad, None, torch.empty(bad.total, dtype=torch.int32))


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,n", [("resnet18_s64", 120), ("resnet18_s128", 200), ("vgg11", 400)])
def test_kernel_equals_host_draw_on_card(cell, n):
    """The kernel's flat buffer is ``upload_indices(sample_service_indices())``
    bit for bit at the cells' sizes, one launch a draw."""
    dev = _card()
    dims = _dims(cell)
    for seed in (0, 5, 2**31 + 77, 3_141_592_653_589):
        want = TV.upload_indices(TV.sample_service_indices(np.random.default_rng(seed), dims, n), dev)
        before = SD.service_draw.launches
        got = TV.service_indices(seed, dims, n, dev)
        torch.cuda.synchronize()
        assert SD.service_draw.launches == before + 1
        assert tuple(got.shape) == (n * sum(p for _, p in dims),) and got.dtype == torch.int32
        assert torch.equal(got, want)


def _host_draw(seed, dims, n, device):
    return TV.upload_indices(TV.sample_service_indices(np.random.default_rng(seed), dims, n), device)


MIXED = [128, 49, 1, 64, 100, 8, 3, 32]  # VGG11's layers: powers of two, one sample, and others


def _profile(spec, dev, samples):
    """Random integer cycles, ``samples[l]`` rows for layer l."""
    rng = np.random.default_rng(2)
    layers = []
    for l, s in zip(spec.layers, samples):
        c = rng.integers(20, 400, (s, l.n_blocks))
        layers.append(LayerProfile(
            l.name, torch.full((l.n_blocks,), 0.3, dtype=torch.float64, device=dev),
            torch.as_tensor(c.mean(axis=0), device=dev), torch.as_tensor(c, device=dev),
            torch.as_tensor(c.max(axis=0) + 16, device=dev), l.patches_per_image))
    return NetworkProfile(spec.name, tuple(layers))


@pytest.mark.cuda
@pytest.mark.parametrize("closed", [False, True])
def test_run_batch_same_through_either_draw_on_card(closed, monkeypatch):
    dev = _card()
    spec = T.vgg11_cifar10()
    prof = _profile(spec, dev, MIXED)
    pes = spec.min_pes() * 2
    allocs = [T.allocate(spec, prof, p, pes) for p in T.POLICIES]
    cap = T.simulate(spec, prof, allocs[-1]).images_per_sec
    proc = TF.ClosedLoop(40, 8) if closed else TF.PoissonOpen(40, 0.7 * cap / 1e8, seed=5)
    vt = TF.VirtualTimeFabric(spec, prof, device=dev)
    before = SD.service_draw.launches
    card = vt.run_batch(allocs, proc, seed=2**33 + 9)
    assert SD.service_draw.launches == before + 1
    monkeypatch.setattr(TV, "service_indices", _host_draw)
    host = vt.run_batch(allocs, proc, seed=2**33 + 9)
    np.testing.assert_array_equal(card.arrivals, host.arrivals)
    np.testing.assert_array_equal(card.completions, host.completions)
    np.testing.assert_array_equal(card.percentiles, host.percentiles)


@pytest.mark.cuda
def test_fabric_percentiles_same_through_either_draw_on_card(monkeypatch):
    """ResNet18's fused stage (its 7x7 layers drawn by numpy) through the
    kernel's draw and through the host's."""
    from repro_torch.core.cim.cost import DEFAULT_ARRAY
    from repro_torch.dse import fused as TFU

    dev = _card()
    pipe = TFU.get_fused_pipeline("resnet18", DEFAULT_ARRAY, (3, 4), sample_patches=64, device=dev)
    try:
        assert sorted(set(pipe.S_l)) == [49, 64]
        pols = ["baseline", "weight_based", "perf_layerwise", "blockwise"]
        a_idx = np.array([0, 1, 1, 0], dtype=np.int32)
        res = pipe(a_idx, pols, [pipe.spec.min_pes() * 2] * len(pols))
        times = np.cumsum(np.random.default_rng(1).exponential(3e5, (len(pols), 12)), axis=1)
        args = (a_idx, res["dups_lb"], res["layerwise"], res["zskip"], times)
        before = SD.service_draw.launches
        card = pipe.fabric_percentiles(*args, seed=2**32 + 1)
        assert SD.service_draw.launches == before + 1
        monkeypatch.setattr(TFU, "service_indices", _host_draw)
        host = pipe.fabric_percentiles(*args, seed=2**32 + 1)
        np.testing.assert_array_equal(card, host)
    finally:
        TFU.clear_fused_caches()


def _tree(snap):
    by_id = {s["id"]: s for s in snap["spans"]}
    return [(s["name"], None if s["parent"] is None else by_id[s["parent"]]["name"]) for s in snap["spans"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["resnet18_s64", "resnet18_s128", "vgg11"])
def test_draw_counters_on_card(cell):
    """``vt.indices_device / vt.indices``: 1 for VGG11, 1 - 245 / 30,233 for
    ResNet18; ``vt.upload`` (under ``vt.draw``) only where numpy drew a
    layer, with the bytes it copied."""
    dev = _card()
    dims = _dims(cell)
    with TM.telemetry_session() as tel:
        TV.service_indices(11, dims, 6, dev)
    torch.cuda.synchronize()
    c = tel.counters
    share = c["vt.indices_device"] / c["vt.indices"]
    assert c["vt.indices"] == 6 * sum(p for _, p in dims)
    if cell == "vgg11":
        assert share == 1.0 and "vt.upload_bytes" not in c
        assert _tree(tel.snapshot()) == [("vt.draw", None)]
    else:
        assert share == pytest.approx(1 - 245 / 30_233, abs=1e-12)
        assert c["vt.upload_bytes"] == 4 * 6 * 245
        assert _tree(tel.snapshot()) == [("vt.pack_indices", "vt.upload"), ("vt.upload", "vt.draw"),
                                         ("vt.draw", None)]


@pytest.mark.cuda
def test_span_trees_on_card():
    """``vt.draw`` under ``vt.run_batch`` and ``dse.fused.fabric`` on the
    card's path; ``vt.upload`` only under it, where a layer is numpy's."""
    from repro_torch.core.cim.cost import DEFAULT_ARRAY
    from repro_torch.dse import fused as TFU

    dev = _card()
    spec = T.vgg11_cifar10()
    for samples, host_layers in ((MIXED, True), ([64] * 8, False)):
        prof = _profile(spec, dev, samples)
        allocs = [T.allocate(spec, prof, p, spec.min_pes() * 2) for p in ("weight_based", "blockwise")]
        vt = TF.VirtualTimeFabric(spec, prof, device=dev)
        with TM.telemetry_session() as tel:
            vt.run_batch(allocs, TF.ClosedLoop(9, 3), seed=1)
        spans = _tree(tel.snapshot())
        assert ("vt.draw", "vt.run_batch") in spans
        assert (("vt.upload", "vt.draw") in spans) == host_layers
        assert [name for name, _ in spans].count("vt.upload") == int(host_layers)
    pipe = TFU.get_fused_pipeline("vgg11", DEFAULT_ARRAY, (3, 4), sample_patches=16, device=dev)
    try:
        pols = ["baseline", "blockwise"]
        a_idx = np.array([0, 1], dtype=np.int32)
        res = pipe(a_idx, pols, [pipe.spec.min_pes() * 2] * len(pols))
        times = np.cumsum(np.random.default_rng(1).exponential(3e3, (len(pols), 3)), axis=1)
        with TM.telemetry_session() as tel:
            pipe.fabric_percentiles(a_idx, res["dups_lb"], res["layerwise"], res["zskip"], times, seed=5)
        spans = _tree(tel.snapshot())
        assert ("vt.draw", "dse.fused.fabric") in spans
        assert "vt.upload" not in [name for name, _ in spans]
        assert tel.counters["vt.indices_device"] == tel.counters["vt.indices"]
    finally:
        TFU.clear_fused_caches()

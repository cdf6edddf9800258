"""ViT-B/16 on the port's CIM path: the network, its capture against the
benchmark's plain NumPy reference (``cimbench/configs/vit_b16.py``), the
signed crossbar inputs, and the path after the capture.

A crossbar takes unsigned inputs.  A layer whose input has a negative
minimum m quantizes x - m and adds m * colsum(W) back; a non-negative
input (every CNN layer) takes the unshifted path, bit for bit.

Capture parity, on a small ViT (width 64, 4 heads, MLP 256, 2 blocks,
32x32 images, patch 8: a 4x4 grid):

* Layer by layer, each crossbar fed the same input gives the same
  quantized rows and row bit counts in both: the shift, the float64 scale
  applied in float32 and round half to even involve no product.
* End to end, the float32 products, LayerNorm, softmax and the
  reductions run in another order in torch than in NumPy.  Before layer 1
  only the patch embedding's product runs, so layers 0 and 1 are held to
  the benchmark's own limit (``capture_mismatch``, 0.002); past them one
  quantization flip moves every output of the next product, and the
  share of differing samples compounds as in ResNet18 (ROADMAP F3), so
  deeper layers are held to their derived density (atol 1e-2, the
  reference's cross-environment tolerance).
* With the quantization taken out of both (each crossbar im2col times W
  in float32), every crossbar's float input agrees on every layer within
  float32 rounding.  No flip cascades there, so this holds what the plan
  adds around the crossbars (position embedding, LayerNorm, attention and
  its scale, GELU, both residuals) at every depth.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch as T
from repro_torch.core.cim import DEFAULT_ARRAY, LayerSpec, NetworkSpec
from repro_torch.core.cim import profile as TP
from repro_torch.core.cim.network import vit
from repro_torch.dse import sweep as TS
from repro_torch.fabric import ClosedLoop, VirtualTimeFabric
from repro_torch.fabric import telemetry as TM
from repro_torch.kernels import vtime_scan as vtk

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from cimbench import harness  # noqa: E402
from cimbench.inputs import make_inputs  # noqa: E402
from cimbench.reference.capture import Tracer  # noqa: E402
from cimbench.reference.capture import _im2col as ref_im2col  # noqa: E402
from cimbench.reference.capture import capture as ref_capture  # noqa: E402
from cimbench.trace import Trace  # noqa: E402

CONFIG = json.loads((ROOT / "cimbench" / "configs" / "vit_b16.json").read_text())
REF = harness._load_py(ROOT / "cimbench" / "configs" / "vit_b16.py", "ref_vit_b16")
SAMPLES = 32


def small_vit():
    return vit("vit_small", depth=2, width=64, mlp=256, heads=4, patch=8, image_hw=32)


def config_of(spec):
    """``vit_b16.json`` with ``spec``'s layer table and image size."""
    cfg = copy.deepcopy(CONFIG)
    cfg["layers"] = [dict(name=l.name, kernel=l.kernel, cin=l.cin, cout=l.cout, out_hw=l.out_hw, stride=l.stride)
                     for l in spec.layers]
    cfg["image_hw"] = spec.layers[0].out_hw * spec.layers[0].stride
    cfg["spec"] = spec.name
    return cfg


@pytest.fixture(autouse=True)
def clean_recorder():
    TM.PROFILER_TELEMETRY.reset()
    yield
    TM.PROFILER_TELEMETRY.reset()


# ---------------------------------------------------------------- the network
def test_vit_b16_counts_and_layer_table():
    spec = T.vit_b16_imagenet()
    assert (len(spec.layers), spec.n_arrays, spec.n_blocks, spec.min_pes()) == (49, 41_760, 510, 653)
    assert sum(l.patches_per_image for l in spec.layers) == 9_604
    assert (spec.plan, spec.heads) == ("vit", 12)
    assert config_of(spec)["layers"] == CONFIG["layers"]
    assert (CONFIG["arrays"], CONFIG["blocks"], CONFIG["min_pes"]) == (41_760, 510, 653)
    assert CONFIG["spec"] == "vit_b16_imagenet" and CONFIG["reduced"] == []


def test_default_image_size_from_first_layer():
    for fn, hw in ((T.resnet18_imagenet, 224), (T.vgg11_cifar10, 32), (T.vit_b16_imagenet, 224)):
        l0 = fn().layers[0]
        assert l0.out_hw * l0.stride == hw
    cap = T.capture_activations(small_vit(), n_images=1, sample_patches=8, device="cpu")
    assert cap.layers[0].n_patches == 16 and cap.layers[0].sampled_q.shape == (8, 192)


def test_sweep_knows_vit_and_keeps_its_plan():
    spec = TS._spec_for("vit_b16", DEFAULT_ARRAY.variant(rows=256))
    assert len(spec.layers) == 49 and (spec.plan, spec.heads) == ("vit", 12)
    assert spec.layers[0].array.rows == 256


def test_posemb_matches_reference():
    got = TP.posemb_sincos_2d(14, 14, 768)
    np.testing.assert_array_equal(got, REF.posemb_sincos_2d(14, 14, 768))
    assert got.shape == (196, 768) and got.dtype == np.float32
    # token 15 is row 1, column 1: sin(x w) with w_0 = 1, cos(y w) with w_191 = 1e-4
    assert got[15, 0] == np.float32(np.sin(1.0)) and got[15, 767] == np.float32(np.cos(1e-4))


# ------------------------------------------------------------ signed crossbars
def test_shifted_layer_output_is_x_times_w():
    """An input on the quantization grid of its shift (x = m + k * s, k in
    0..255) quantizes exactly, so the layer's output is x W within float32
    rounding."""
    rng = np.random.default_rng(7)
    rows, cout, m, s = 64, 48, -3.0, 2.0**-5
    k = rng.integers(0, 256, (2, rows, 4, 4))
    k[0, 0, 0, 0] = 255
    x = (m + k * s).astype(np.float32)
    w = (rng.standard_normal((rows, cout)) * 0.2).astype(np.float32)
    spec = NetworkSpec("one", (LayerSpec("l", 1, rows, cout, 4),))
    sel = [torch.arange(4)]
    with TM.telemetry_session() as tel:
        y = TP._CaptureTracer(spec, (torch.as_tensor(w),), sel).conv(0, torch.as_tensor(x)).numpy()
    assert tel.counters["cim.capture.shifted_layers"] == 1
    want = np.einsum("nchw,co->nohw", x.astype(np.float64), w.astype(np.float64))
    mag = np.einsum("nchw,co->nohw", np.abs(x).astype(np.float64), np.abs(w).astype(np.float64))
    assert np.all(np.abs(y - want) <= 8 * np.finfo(np.float32).eps * mag)


class _Unshifted(TP._CaptureTracer):
    """The crossbar step as it was before signed inputs: rectify, quantize."""

    def conv(self, idx, x):
        layer = self.spec.layers[idx]
        pat = torch.relu(TP._im2col(x, layer))
        scale = pat.max().to(torch.float64) / 255.0 + 1e-12
        s32 = scale.to(torch.float32)
        q = torch.clamp(torch.round(pat / s32), 0, 255).to(torch.uint8)
        rowbits = torch.zeros(layer.rows, dtype=torch.int64, device=q.device)
        for p in range(8):
            rowbits += ((q >> (7 - p)) & 1).sum(dim=0, dtype=torch.int64)
        self.rowbits[idx] = rowbits
        self.sampled[idx] = q[self.sel[idx]]
        y = (q.to(torch.float32) * s32) @ self.weights[idx]
        n = x.shape[0]
        return y.reshape(n, layer.out_hw, layer.out_hw, layer.cout).permute(0, 3, 1, 2)


@pytest.mark.parametrize("net", ["vgg11_cifar10", "resnet18_imagenet"])
def test_cnn_captures_unchanged(net, monkeypatch):
    """Every CNN input is non-negative (m = 0): the captures are bit for bit
    those of the unshifted crossbar."""
    spec = getattr(T, net)()
    kw = dict(n_images=1, sample_patches=64, seed=3, device="cpu")
    with TM.telemetry_session() as tel:
        got = T.capture_activations(spec, **kw)
    assert tel.counters["cim.capture.shifted_layers"] == 0
    assert "cim.capture.offfabric_macs" not in tel.counters
    monkeypatch.setattr(TP, "_CaptureTracer", _Unshifted)
    want = T.capture_activations(spec, **kw)
    for g, w in zip(got.layers, want.layers):
        assert torch.equal(g.rowbits, w.rowbits) and torch.equal(g.sampled_q, w.sampled_q)


# ------------------------------------------------- the capture against NumPy's
def _inputs(spec, seed, n=2):
    images, weights = make_inputs(config_of(spec), n, seed, "cpu")
    return images, weights


def test_each_crossbar_exact_given_the_same_input(monkeypatch):
    """Every layer of the small ViT, fed the reference's own input: the same
    quantized rows and row bit counts, outputs within float32 rounding."""
    spec = small_vit()
    cfg = config_of(spec)
    images, weights = _inputs(spec, seed=1)
    seen = {}
    real = REF.crossbar

    def record(p, i, x):
        seen[i] = x
        return real(p, i, x)

    monkeypatch.setattr(REF, "crossbar", record)
    ref_capture(cfg["layers"], REF.make_forward(spec.heads), images.numpy(), [w.numpy() for w in weights], SAMPLES)
    assert sorted(seen) == list(range(len(spec.layers)))
    shifted = 0
    for i, x in seen.items():
        sel = [np.arange(min(SAMPLES, x.shape[0] * l.patches_per_image)) for l in spec.layers]
        ref = Tracer(cfg["layers"], [w.numpy() for w in weights], sel)
        want = real(ref, i, x)
        with TM.telemetry_session() as tel:
            prog = TP._CaptureTracer(spec, weights, [torch.as_tensor(s) for s in sel])
            got = prog.conv(i, torch.as_tensor(x)).numpy()
        shifted += tel.counters["cim.capture.shifted_layers"]
        np.testing.assert_array_equal(prog.rowbits[i].numpy(), ref.rowbits[i])
        np.testing.assert_array_equal(prog.sampled[i].numpy(), ref.sampled[i])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert shifted == len(spec.layers) - 1  # every layer but the patch embedding takes a signed input


@pytest.mark.parametrize("seed", [1, 2, 2**33 + 7])
def test_small_vit_capture_matches_reference(seed):
    spec = small_vit()
    cfg = config_of(spec)
    images, weights = _inputs(spec, seed)
    cap = T.capture_activations(spec, n_images=2, sample_patches=SAMPLES, batch_images=None, images=images,
                                weights=weights, device="cpu")
    rowbits, sampled = ref_capture(cfg["layers"], REF.make_forward(spec.heads), images.numpy(),
                                   [w.numpy() for w in weights], SAMPLES)
    for i, (c, rb, sq) in enumerate(zip(cap.layers, rowbits, sampled)):
        got = c.sampled_q.numpy()
        assert got.shape == sq.shape
        if i < 2:
            assert np.mean(got != sq) <= 0.002, i
        dens = [b.sum() / (c.n_patches * rb.size * 8) for b in (c.rowbits.numpy(), rb)]
        assert abs(dens[0] - dens[1]) <= 1e-2, i


class _FloatCrossbars(TP._CaptureTracer):
    """The program's plan with unquantized crossbars, keeping each input."""

    def conv(self, idx, x):
        self.inputs[idx] = x.numpy().copy()
        layer = self.spec.layers[idx]
        y = TP._im2col(x, layer) @ self.weights[idx]
        return y.reshape(x.shape[0], layer.out_hw, layer.out_hw, layer.cout).permute(0, 3, 1, 2)


class _FloatRef:
    """A stand-in for the reference's tracer: unquantized crossbars."""

    def __init__(self, layers, weights):
        self.layers, self.weights = layers, weights

    def conv(self, i, x):
        lay = self.layers[i]
        n, hw, cout = x.shape[0], int(lay["out_hw"]), int(lay["cout"])
        y = ref_im2col(x, int(lay["kernel"]), int(lay["stride"])) @ self.weights[i]
        return y.reshape(n, hw, hw, cout).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("seed", [1, 2, 2**33 + 7])
def test_forward_plan_matches_reference_without_quantization(seed, monkeypatch):
    """Every crossbar's float input, on every layer, within float32
    rounding of the reference's (at most 2.3e-6 of the layer's largest
    input over these seeds; held to 1e-5)."""
    spec = small_vit()
    cfg = config_of(spec)
    images, weights = _inputs(spec, seed)
    seen = {}
    real = REF.crossbar

    def record(p, i, x):
        seen[i] = x
        return real(p, i, x)

    monkeypatch.setattr(REF, "crossbar", record)
    REF.make_forward(spec.heads)(_FloatRef(cfg["layers"], [w.numpy() for w in weights]),
                                 np.ascontiguousarray(images.numpy().transpose(0, 3, 1, 2)))
    prog = _FloatCrossbars(spec, weights, [None] * len(spec.layers))
    prog.inputs = {}
    TP._FORWARD[spec.plan](prog, images.permute(0, 3, 1, 2))
    assert sorted(prog.inputs) == sorted(seen) == list(range(len(spec.layers)))
    for i, want in seen.items():
        assert prog.inputs[i].shape == want.shape
        np.testing.assert_allclose(prog.inputs[i], want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=str(i))


def test_capture_span_and_counters():
    spec = small_vit()
    images, weights = _inputs(spec, seed=2)
    with TM.telemetry_session() as tel:
        T.capture_activations(spec, n_images=2, sample_patches=SAMPLES, batch_images=1, images=images,
                              weights=weights, device="cpu")
    snap = tel.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["cim.capture"]
    c = snap["counters"]
    assert c["cim.capture.shifted_layers"] == 2 * (len(spec.layers) - 1)  # two batches of one image
    # per block and image: q k^T and p v, each T^2 x D MACs
    assert c["cim.capture.offfabric_macs"] == 2 * 2 * 2 * 16**2 * 64


# ------------------------------------------------------------ after the capture
def test_small_vit_through_the_closed_query_check(monkeypatch):
    """The small ViT through derive, the five policies and ``run_batch`` (VT's
    plain version), checked by the benchmark's entry against its NumPy
    reference: the path exact, the capture within the cell's limit."""
    spec = small_vit()
    monkeypatch.setattr(T, "vit_small", small_vit, raising=False)
    mix = json.loads((ROOT / "cimbench" / "traffic" / "closed_query.json").read_text())
    mix["arrivals"].update(n_requests=6, concurrency=3)
    mix["profile"] = {"n_images": 1, "sample_patches": SAMPLES}
    cfg = dict(config_of(spec), spec="vit_small")
    entry = harness.load_entry(ROOT, "run_batch")
    drv = entry.Driver(cfg, REF.make_forward(spec.heads), mix, 2**32 + 11, "cpu")
    drv.setup()
    assert [a.policy for a in drv.allocs] == list(T.POLICIES)
    records = [drv.call(i) for i in range(2)]
    drv.snapshot()
    drv.free()
    got = drv.check(records)
    assert got["path_gap"] == 0.0
    assert got["capture_mismatch"] <= mix["limits"]["capture_mismatch"]


def _vit_b16_lanes():
    from test_torch_vtime import policy_lanes

    spec = T.vit_b16_imagenet()
    return spec, policy_lanes(spec)


def test_stage_weights_are_the_split_stage_split_balanced():
    spec, lanes = _vit_b16_lanes()
    blocks = [l.n_blocks for l in spec.layers]
    ppi = [l.patches_per_image for l in spec.layers]
    plan = vtk.kernel_plan(lanes, blocks, ppi)
    w = plan.stage_weights
    assert len(w) == plan.stages and len(plan.split) == plan.stages + 1
    assert plan.stages * max(w) / sum(w) >= 1.0
    for S in range(1, 9):
        forced = vtk.kernel_plan(lanes, blocks, ppi, stages=S)
        assert len(forced.stage_weights) == S
        assert sum(forced.stage_weights) == pytest.approx(sum(w), rel=1e-12)
        assert max(forced.stage_weights) >= max(w)


def _span_attrs(snap, name):
    return [s["attrs"] for s in snap["spans"] if s["name"] == name]


@pytest.mark.cuda
def test_vt_launch_records_stage_weights_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    spec = small_vit()
    prof = T.profile_network(spec, n_images=1, sample_patches=SAMPLES, device=dev)
    allocs = [T.allocate(spec, prof, p, 2 * spec.min_pes()) for p in T.POLICIES]
    with TM.telemetry_session() as tel:
        VirtualTimeFabric(spec, prof, device=dev).run_batch(allocs, ClosedLoop(12, 4), seed=3)
        torch.cuda.synchronize()
    (attrs,) = _span_attrs(tel.snapshot(), "vt.launch")
    w = attrs["stage_weights"]
    assert len(w) == attrs["stages"] and attrs["stages"] * max(w) / sum(w) >= 1.0


def test_vt_stage_balance_reader():
    """The reader on a synthetic recording: two calls, one launch each."""
    rec = TM.PROFILER_TELEMETRY
    for weights in ([3.0, 1.0], [2.0, 2.0, 2.0]):
        with rec.span("vt.run_batch"):
            with rec.span("vt.launch", stages=len(weights), stage_weights=weights):
                pass
    read = harness.load_metric(ROOT, "vt_stage_balance.query")
    tr = Trace("query", [(0.0, 1.0), (2.0, 3.0)], [("k", 0.0, 1.0)])
    assert read(tr) == pytest.approx((2 * 3.0 / 4.0 + 1.0) / 2)
    assert read(Trace("sweep", tr.calls, tr.device)) is None


def test_vt_stage_balance_reader_without_the_attribute():
    """A program whose ``vt.launch`` spans carry no ``stage_weights`` (before
    this metric) gives nothing to read."""
    rec = TM.PROFILER_TELEMETRY
    with rec.span("vt.run_batch"):
        with rec.span("vt.launch", stages=2):
            pass
    tr = Trace("query", [(0.0, 1.0)], [("k", 0.0, 1.0)])
    assert harness.load_metric(ROOT, "vt_stage_balance.query")(tr) is None

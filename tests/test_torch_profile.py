"""Parity of the port's capture and derive with the reference profiler.

(a) Derive from a shared capture: the reference's ``ActivationCapture`` is
    carried across with ``convert.capture_from_numpy``; every port engine
    must equal the reference ``"reference"`` engine exactly (cycle samples,
    block densities, baseline cycles).
(b) Capture from shared inputs: the reference's images and kaiming weights,
    rebuilt with the key splits of ``capture_activations``, go to the port
    as numpy.
      * Layer by layer, each conv fed the reference's own input gives the
        same quantized rows and row bit counts: its arithmetic (SAME
        padding, im2col order, the float64 scale applied in float32,
        round half to even) involves no matmul, so this is exact.
      * End to end, float32 matmul and BN reductions run in another order
        than XLA's, a few quantized values move by one, and through
        ResNet18's 20 layers the moves compound.  The share of differing
        ``sampled_q`` entries is reported per layer; VGG11's entries may
        differ by at most 1.  Derived numbers are held to the reference's
        own cross-environment tolerance (``tests/test_profile_engines.py``):
        density atol 1e-2 and cycle statistics rtol 2e-2, per block for
        VGG11 and per layer for ResNet18, whose deepest blocks drift past
        it (ROADMAP F3).
"""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cim as R
from repro.core.cim import profile as RP
import repro_torch.core.cim as T
from repro_torch.convert import capture_from_numpy, capture_inputs_from_numpy
from repro_torch.core.cim import profile as TP

CASES = {
    "vgg11": dict(n_images=2),
    "resnet18": dict(n_images=1, sample_patches=128),
}
SPECS = {"vgg11": ("vgg11_cifar10", 32), "resnet18": ("resnet18_imagenet", 224)}


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


def _specs(net):
    fn, _ = SPECS[net]
    return getattr(R, fn)(), getattr(T, fn)()


@pytest.fixture(scope="module", params=list(CASES))
def ref_capture(request):
    rspec, tspec = _specs(request.param)
    return request.param, rspec, tspec, R.capture_activations(rspec, **CASES[request.param])


def _assert_profiles_equal(tprof, rprof):
    assert tprof.network == rprof.network
    for t, r in zip(tprof.layers, rprof.layers, strict=True):
        assert t.name == r.name and t.patches_per_image == r.patches_per_image
        np.testing.assert_array_equal(t.block_density.numpy(), r.block_density)
        np.testing.assert_array_equal(t.mean_cycles.numpy(), r.mean_cycles)
        np.testing.assert_array_equal(t.cycles_sample.numpy(), r.cycles_sample)
        np.testing.assert_array_equal(
            t.baseline_block_cycles.numpy(), r.baseline_block_cycles
        )


@pytest.mark.parametrize("engine", ["reference", "vectorized", "torch", None])
def test_derive_from_shared_capture_is_exact(ref_capture, engine):
    _, rspec, tspec, rcap = ref_capture
    tcap = capture_from_numpy(rcap, device="cpu")
    rprof = R.derive_profile(rcap, rspec, engine="reference")
    _assert_profiles_equal(T.derive_profile(tcap, tspec, engine=engine), rprof)


@pytest.mark.parametrize("variant", [dict(adc_bits=2), dict(rows=256, cols=256), dict(adc_bits=5, rows=64, cols=64)])
def test_derive_geometry_views_are_exact(ref_capture, variant):
    """Swept geometries re-slice and re-cost the same capture identically."""
    _, rspec, tspec, rcap = ref_capture
    rarr, tarr = R.DEFAULT_ARRAY.variant(**variant), T.DEFAULT_ARRAY.variant(**variant)
    rprof = R.derive_profile(rcap, R.with_array(rspec, rarr), array=rarr, engine="reference")
    tprof = T.derive_profile(
        capture_from_numpy(rcap, device="cpu"), T.with_array(tspec, tarr), array=tarr,
        engine="torch",
    )
    _assert_profiles_equal(tprof, rprof)


@pytest.mark.parametrize("variant", [None, dict(rows=256, cols=256)])
def test_grouped_derive_equals_vectorized_and_reference(ref_capture, variant):
    """The torch engine (the grouped derive: every layer in one pass, K1's
    plain grouped version) equals the layer-by-layer vectorized engine field
    by field and the reference's derive; every field is a contiguous view
    of one flat buffer, and a second derive (cached tables) is the same."""
    _, rspec, tspec, rcap = ref_capture
    rarr = tarr = None
    if variant is not None:
        rarr, tarr = R.DEFAULT_ARRAY.variant(**variant), T.DEFAULT_ARRAY.variant(**variant)
        rspec, tspec = R.with_array(rspec, rarr), T.with_array(tspec, tarr)
    tcap = capture_from_numpy(rcap, device="cpu")
    grouped = T.derive_profile(tcap, tspec, array=tarr, engine="torch")
    vectorized = T.derive_profile(tcap, tspec, array=tarr, engine="vectorized")
    fields = ("block_density", "mean_cycles", "cycles_sample", "baseline_block_cycles")
    for g, v in zip(grouped.layers, vectorized.layers, strict=True):
        for f in fields:
            a, b = getattr(g, f), getattr(v, f)
            assert a.dtype == b.dtype and torch.equal(a, b), (g.name, f)
            assert a.is_contiguous(), (g.name, f)
    _assert_profiles_equal(grouped, R.derive_profile(rcap, rspec, array=rarr, engine="reference"))
    for f in fields:
        assert len({getattr(g, f).untyped_storage().data_ptr() for g in grouped.layers}) == 1, f
    again = T.derive_profile(tcap, tspec, array=tarr, engine="torch")
    _assert_profiles_equal(again, R.derive_profile(rcap, rspec, array=rarr, engine="vectorized"))


def _shared_inputs(rspec, n_images, hw, seed=0):
    """The reference's images and weights, with ``capture_activations``'s
    key splits."""
    kimg, kw = jax.random.split(jax.random.PRNGKey(seed))
    keys = jax.random.split(kw, len(rspec.layers))
    weights = [np.asarray(RP._kaiming(keys[i], l.rows, l.cout)) for i, l in enumerate(rspec.layers)]
    return np.asarray(RP.synthetic_images(n_images, hw, kimg)), weights


def test_capture_from_shared_inputs(ref_capture):
    net, rspec, tspec, rcap = ref_capture
    kw = CASES[net]
    images, weights = _shared_inputs(rspec, kw["n_images"], SPECS[net][1])
    x, ws = capture_inputs_from_numpy(images, weights, tspec, device="cpu")
    tcap = T.capture_activations(tspec, images=x, weights=ws, device="cpu", **kw)
    shares = {}
    for t, r in zip(tcap.layers, rcap.layers, strict=True):
        assert t.name == r.name and t.n_patches == r.n_patches
        assert t.sampled_q.shape == r.sampled_q.shape and t.sampled_q.dtype == torch.uint8
        d = np.abs(t.sampled_q.numpy().astype(np.int64) - r.sampled_q.astype(np.int64))
        shares[t.name] = (float((d > 0).mean()), int(d.max()))
    print(f"\n{net} sampled_q (share differing, max |diff|) per layer: {shares}")
    first = tcap.layers[0]
    np.testing.assert_array_equal(first.sampled_q.numpy(), rcap.layers[0].sampled_q)
    np.testing.assert_array_equal(first.rowbits.numpy(), rcap.layers[0].rowbits)
    tprof = T.derive_profile(tcap, tspec)
    rprof = R.derive_profile(rcap, rspec)
    for t, r in zip(tprof.layers, rprof.layers):
        np.testing.assert_array_equal(t.baseline_block_cycles.numpy(), r.baseline_block_cycles)
        assert t.cycles_sample.shape == r.cycles_sample.shape
        tsum, rsum = float(t.cycles_sample.sum()), float(r.cycles_sample.sum())
        np.testing.assert_allclose(tsum, rsum, rtol=2e-2, err_msg=t.name)
        if net == "vgg11":
            assert max(m for _, m in shares.values()) <= 1
            np.testing.assert_allclose(t.block_density.numpy(), r.block_density, atol=1e-2, rtol=0)
            np.testing.assert_allclose(t.mean_cycles.numpy(), r.mean_cycles, rtol=2e-2)
        else:
            np.testing.assert_allclose(t.density, float(r.block_density.mean()), atol=1e-2, rtol=0)
            np.testing.assert_allclose(
                float(t.mean_cycles.mean()), float(r.mean_cycles.mean()), rtol=2e-2
            )


def test_capture_layer_local_is_exact():
    """Every ResNet18 conv, fed the reference's own input to that conv,
    quantizes to the same rows and counts the same bits."""
    rspec, tspec = _specs("resnet18")
    images, weights = _shared_inputs(rspec, 1, 224)

    class Recorder(RP._CaptureTracer):
        def conv(self, idx, x):
            self.inputs[idx] = x
            return super().conv(idx, x)

    def forward(weights, sel, x):
        rec = Recorder(rspec, weights, sel)
        rec.inputs = {}
        RP._forward_resnet18(rec, x)
        return rec.inputs, tuple(rec.sampled), tuple(rec.rowbits)

    rng = np.random.default_rng(0)
    sel = [rng.choice(l.patches_per_image, size=min(96, l.patches_per_image), replace=False) for l in rspec.layers]
    with jax.enable_x64(True):  # the scale is float64, as in the reference's capture
        inputs, sampled, rowbits = jax.jit(forward)(
            tuple(map(jnp.asarray, weights)),
            tuple(jnp.asarray(s.astype(np.int32)) for s in sel),
            jnp.asarray(images),
        )
    port = TP._CaptureTracer(tspec, [torch.tensor(w) for w in weights], [torch.tensor(s) for s in sel])
    for idx, layer in enumerate(tspec.layers):
        port.conv(idx, torch.tensor(np.asarray(inputs[idx])).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(port.sampled[idx].numpy(), np.asarray(sampled[idx]), err_msg=layer.name)
        np.testing.assert_array_equal(port.rowbits[idx].numpy(), np.asarray(rowbits[idx]), err_msg=layer.name)


def test_streaming_capture_matches_reference():
    """Images streamed one at a time (per-batch scales and BN statistics,
    the sample filled across batches) as in the reference.  BN over one
    image's 2x2 maps is sensitive to reduction order, so past the first
    layer the capture is held to the derived tolerance per layer."""
    rspec, tspec = _specs("vgg11")
    kw = dict(n_images=3, sample_patches=48, batch_images=1)
    rcap = R.capture_activations(rspec, **kw)
    images, weights = _shared_inputs(rspec, 3, 32)
    x, ws = capture_inputs_from_numpy(images, weights, tspec, device="cpu")
    tcap = T.capture_activations(tspec, images=x, weights=ws, device="cpu", **kw)
    # the first conv sees the images themselves: exact, which pins that each
    # sampled row came from the right image and patch
    np.testing.assert_array_equal(tcap.layers[0].sampled_q.numpy(), rcap.layers[0].sampled_q)
    np.testing.assert_array_equal(tcap.layers[0].rowbits.numpy(), rcap.layers[0].rowbits)
    for t, r in zip(T.derive_profile(tcap, tspec).layers, R.derive_profile(rcap, rspec).layers):
        np.testing.assert_allclose(t.density, float(r.block_density.mean()), atol=1e-2, rtol=0)
        np.testing.assert_allclose(
            float(t.mean_cycles.mean()), float(r.mean_cycles.mean()), rtol=2e-2
        )


def test_own_inputs_are_seeded_and_shaped():
    """Without given inputs the port draws its own from the seed: the same
    seed gives the same capture, another seed another one."""
    spec = T.vgg11_cifar10()
    a = T.capture_activations(spec, n_images=1, sample_patches=16, device="cpu")
    b = T.capture_activations(spec, n_images=1, sample_patches=16, device="cpu")
    c = T.capture_activations(spec, n_images=1, sample_patches=16, seed=1, device="cpu")
    for la, lb, lc, layer in zip(a.layers, b.layers, c.layers, spec.layers):
        take = min(16, layer.patches_per_image)
        assert la.sampled_q.shape == (take, layer.rows) and la.rowbits.shape == (layer.rows,)
        assert torch.equal(la.sampled_q, lb.sampled_q) and torch.equal(la.rowbits, lb.rowbits)
    assert not torch.equal(a.layers[0].rowbits, c.layers[0].rowbits)


def test_derive_validates_engine_device_and_network():
    spec = T.vgg11_cifar10()
    cap = T.capture_activations(spec, n_images=1, sample_patches=8, device="cpu")
    with pytest.raises(ValueError, match="engine must be"):
        T.derive_profile(cap, spec, engine="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        T.derive_profile(cap, spec, engine="kernel")
    with pytest.raises(ValueError, match="capture is for"):
        T.derive_profile(cap, T.resnet18_imagenet())
    with pytest.raises(ValueError, match="both images and weights"):
        T.capture_activations(spec, images=torch.zeros(1, 32, 32, 3), device="cpu")

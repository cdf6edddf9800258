"""The paper's headline results from the reference's own capture.

``benchmarks/run.py`` profiles each network with ``profile_network(spec,
n_images=2)`` (its ``_profile``) and reads Fig 8 (``fig8``: img/s of four
policies at 1, 1.41, 2, 2.83, 4 and 5.66 times the minimum PEs, ResNet18
and VGG11, and the blockwise ratios it prints) and Fig 9 (``fig9``: the
per-layer array utilization of three policies at twice the minimum,
ResNet18).  Here the reference's capture at those settings goes to the
port through ``convert.capture_from_numpy`` and the port's grouped
``torch`` derive; every number is held to the reference's at rtol 1e-9
(the golden contract).
"""

import functools

import jax
import jax.experimental
import numpy as np
import pytest

import repro.core.cim as R
import repro_torch.core.cim as T
from repro_torch.convert import capture_from_numpy

RTOL = 1e-9
FIG8_POLICIES = ("baseline", "weight_based", "perf_layerwise", "blockwise")
FIG9_POLICIES = ("weight_based", "perf_layerwise", "blockwise")
SPECS = {"resnet18": "resnet18_imagenet", "vgg11": "vgg11_cifar10"}


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


@functools.cache
def _profiles(net):
    """(reference spec and profile, port spec and profile), both derived
    from the reference's capture at ``benchmarks/run.py``'s settings."""
    rspec, tspec = getattr(R, SPECS[net])(), getattr(T, SPECS[net])()
    rcap = R.capture_activations(rspec, n_images=2)
    rprof = R.derive_profile(rcap, rspec)  # what profile_network(spec, n_images=2) returns
    tprof = T.derive_profile(capture_from_numpy(rcap, device="cpu"), tspec, engine="torch")
    return rspec, rprof, tspec, tprof


def _fig8_sizes(base):
    """``benchmarks/run.py``'s Fig 8 design sizes."""
    return [base, int(base * 1.41), base * 2, int(base * 2.83), base * 4, int(base * 5.66)]


@pytest.mark.parametrize("net", list(SPECS))
def test_fig8_throughput_and_ratios(net):
    rspec, rprof, tspec, tprof = _profiles(net)
    sizes = _fig8_sizes(rspec.min_pes())
    assert _fig8_sizes(tspec.min_pes()) == sizes
    got = {p: [T.run_policy(tspec, tprof, p, n).images_per_sec for n in sizes] for p in FIG8_POLICIES}
    want = {p: [R.run_policy(rspec, rprof, p, n).images_per_sec for n in sizes] for p in FIG8_POLICIES}
    for p in FIG8_POLICIES:
        np.testing.assert_allclose(got[p], want[p], rtol=RTOL, err_msg=p)
    # the ratios fig8 prints, at every size
    for other in ("weight_based", "baseline", "perf_layerwise"):
        np.testing.assert_allclose(
            np.divide(got["blockwise"], got[other]),
            np.divide(want["blockwise"], want[other]),
            rtol=RTOL,
            err_msg=f"blockwise / {other}",
        )


def test_fig9_layer_utilization():
    rspec, rprof, tspec, tprof = _profiles("resnet18")
    pes = rspec.min_pes() * 2
    for p in FIG9_POLICIES:
        got = T.run_policy(tspec, tprof, p, pes).layer_utilization.numpy()
        want = np.asarray(R.run_policy(rspec, rprof, p, pes).layer_utilization)
        assert got.shape == want.shape == (len(rspec.layers),)
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=p)
        np.testing.assert_allclose(got.mean(), want.mean(), rtol=RTOL, err_msg=p)

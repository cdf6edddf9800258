"""K1, the bit-plane popcount kernel: its plain PyTorch version against the
reference Pallas kernel (interpret mode), and the CUDA kernel against the
plain version on the card.

All outputs are integers, so every comparison is exact.  The reference is
imported inside a fixture, so the card-only test also runs where jax is
not installed.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.bitplane_profile import (
    bitplane_block_profile,
    bitplane_block_profile_ref,
    bitplane_profile,
)

R_RPR = [(r, rpr) for r in (128, 64, 37) for rpr in (4, 8, 16)]


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    # by module path: ``repro.kernels`` re-exports a function of the same name
    return importlib.import_module("repro.kernels.bitplane_profile")


def _blocks(seed, b, s, r, fill=None):
    rng = np.random.default_rng(seed)
    if fill is not None:
        return np.full((b, s, r), fill, np.uint8)
    q = rng.integers(0, 256, size=(b, s, r), dtype=np.uint8)
    q[rng.random((b, s, r)) < 0.5] = 0  # ReLU-like sparsity
    return q


@pytest.mark.parametrize("r,rpr", R_RPR)
def test_plain_block_profile_equals_pallas(ref, r, rpr):
    import jax.numpy as jnp

    q = _blocks(r + rpr, 3, 16, r)
    ones, cyc = bitplane_block_profile_ref(
        torch.from_numpy(q), rows_per_read=rpr, cycles_per_read=8
    )
    r_ones, r_cyc = ref.bitplane_block_profile(
        jnp.asarray(q.astype(np.int32)), rows_per_read=rpr, cycles_per_read=8, interpret=True
    )
    assert ones.dtype == torch.int32 and cyc.dtype == torch.int32
    np.testing.assert_array_equal(ones.numpy(), np.asarray(r_ones))
    np.testing.assert_array_equal(cyc.numpy(), np.asarray(r_cyc))


@pytest.mark.parametrize("fill", [0, 0xFF])
def test_plain_block_profile_edge_inputs(ref, fill):
    """All-zero rows cost the 1-read floor per plane; all-0xFF rows read
    every row group of every plane."""
    import jax.numpy as jnp

    q = _blocks(0, 2, 5, 100, fill=fill)
    ones, cyc = bitplane_block_profile_ref(torch.from_numpy(q))
    r_ones, r_cyc = ref.bitplane_block_profile(jnp.asarray(q.astype(np.int32)), interpret=True)
    np.testing.assert_array_equal(ones.numpy(), np.asarray(r_ones))
    np.testing.assert_array_equal(cyc.numpy(), np.asarray(r_cyc))
    want = 8 * 8 * (1 if fill == 0 else -(-100 // 8))
    assert (cyc == want).all()


@pytest.mark.parametrize("s,rows,block_rows", [(8, 256, 128), (16, 300, 128), (4, 100, 256), (32, 128, 64)])
@pytest.mark.parametrize("rpr", [4, 8, 16])
def test_bitplane_profile_equals_reference(ref, s, rows, block_rows, rpr):
    """The profiler-facing wrapper (zero-padded last block, (S, B, 8) and
    (S, B) layout) on a CPU tensor equals the reference wrapper."""
    rng = np.random.default_rng(s + rows + rpr)
    q = rng.integers(0, 256, size=(s, rows), dtype=np.uint8)
    ones, cyc = bitplane_profile(
        torch.from_numpy(q), block_rows=block_rows, rows_per_read=rpr, cycles_per_read=8
    )
    r_ones, r_cyc = ref.bitplane_profile(
        q, block_rows=block_rows, rows_per_read=rpr, cycles_per_read=8, interpret=True
    )
    assert ones.dtype == torch.int64 and cyc.dtype == torch.int64
    np.testing.assert_array_equal(ones.numpy(), r_ones)
    np.testing.assert_array_equal(cyc.numpy(), r_cyc)


def test_wrapper_takes_plain_version_on_cpu_and_validates():
    q = torch.from_numpy(_blocks(1, 2, 3, 64))
    before = bitplane_block_profile.launches
    ones, cyc = bitplane_block_profile(q, rows_per_read=4)
    want_ones, want_cyc = bitplane_block_profile_ref(q, rows_per_read=4)
    assert torch.equal(ones, want_ones) and torch.equal(cyc, want_cyc)
    assert bitplane_block_profile.launches == before  # the plain version is no launch
    with pytest.raises(TypeError, match="uint8"):
        bitplane_block_profile(q.to(torch.int32))
    with pytest.raises(ValueError, match=r"\(B, S, r\)"):
        bitplane_block_profile(q[0])
    with pytest.raises(TypeError, match="uint8"):
        bitplane_profile(torch.zeros((2, 8), dtype=torch.int32), block_rows=8)
    with pytest.raises(ValueError, match="rows"):
        bitplane_profile(torch.zeros(8, dtype=torch.uint8), block_rows=8)


@pytest.mark.cuda
@pytest.mark.parametrize("r,rpr", R_RPR)
def test_kernel_equals_plain_on_card(r, rpr):
    """The CUDA kernel against its plain version on the card, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    for fill in (None, 0, 0xFF):
        q = torch.from_numpy(_blocks(r * rpr, 5, 300, r, fill=fill)).cuda()
        before = bitplane_block_profile.launches
        ones, cyc = bitplane_block_profile(q, rows_per_read=rpr, cycles_per_read=8)
        torch.cuda.synchronize()
        assert bitplane_block_profile.launches == before + 1
        want_ones, want_cyc = bitplane_block_profile_ref(q, rows_per_read=rpr, cycles_per_read=8)
        assert torch.equal(ones, want_ones) and torch.equal(cyc, want_cyc)

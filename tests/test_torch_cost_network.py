"""Parity of the port's cost model and network specs with the reference.

Both are copies, so the contract is equality: specs field for field
(including ``block_table`` and ``min_pes``), cost functions integer for
integer on random uint8 input (numpy and torch inputs alike).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.cim.cost as rc
import repro.core.cim.network as rn
import repro_torch.core.cim.cost as tc
import repro_torch.core.cim.network as tn

NETS = ["resnet18_imagenet", "vgg11_cifar10"]
VARIANTS = [{}, dict(adc_bits=2), dict(rows=256, cols=256), dict(adc_bits=5, rows=64, cols=64)]


def _same_array(ta: tc.ArrayConfig, ra: rc.ArrayConfig):
    assert dataclasses.asdict(ta) == dataclasses.asdict(ra)
    for prop in ("rows_per_read", "cycles_per_read", "logical_cols", "act_bytes"):
        assert getattr(ta, prop) == getattr(ra, prop), prop
    assert ta.min_cycles() == ra.min_cycles() and ta.max_cycles() == ra.max_cycles()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("net", NETS)
def test_specs_field_equal(net, variant):
    rspec = rn.with_array(getattr(rn, net)(), rc.DEFAULT_ARRAY.variant(**variant))
    tspec = tn.with_array(getattr(tn, net)(), tc.DEFAULT_ARRAY.variant(**variant))
    assert tspec.name == rspec.name
    assert len(tspec.layers) == len(rspec.layers)
    for tl, rl in zip(tspec.layers, rspec.layers):
        _same_array(tl.array, rl.array)
        for f in ("name", "kernel", "cin", "cout", "out_hw", "stride", "rows", "n_blocks",
                  "arrays_per_block", "n_arrays", "patches_per_image", "macs_per_image"):
            assert getattr(tl, f) == getattr(rl, f), (tl.name, f)
        assert tl.block_row_slices() == rl.block_row_slices()
    assert tspec.n_arrays == rspec.n_arrays and tspec.n_blocks == rspec.n_blocks
    for apc in (16, 64, 100):
        assert tspec.min_pes(apc) == rspec.min_pes(apc)
    np.testing.assert_array_equal(tspec.block_table(), rspec.block_table())


def test_resnet18_paper_counts():
    spec = tn.resnet18_imagenet()
    assert len(spec.layers) == 20
    assert (spec.n_arrays, spec.n_blocks, spec.min_pes()) == (5472, 247, 86)


@pytest.mark.parametrize("shape", [(16, 128), (9, 37), (4, 3, 200), (1, 8)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cost_functions_equal_on_random_uint8(shape, variant):
    """Rows need not be a multiple of 8; numpy and torch inputs give the
    reference's integers exactly."""
    rng = np.random.default_rng(sum(shape) + len(variant))
    q = rng.integers(0, 256, size=shape, dtype=np.uint8)
    q[..., : shape[-1] // 3] = 0  # sparse rows, as after a ReLU
    rcfg, tcfg = rc.DEFAULT_ARRAY.variant(**variant), tc.DEFAULT_ARRAY.variant(**variant)
    ones = rc.bitplane_ones(q)
    np.testing.assert_array_equal(tc.bitplane_ones(q), ones)
    np.testing.assert_array_equal(tc.bitplane_ones(torch.from_numpy(q)).numpy(), ones)
    cyc = rc.zskip_cycles(q, rcfg)
    np.testing.assert_array_equal(tc.zskip_cycles(q, tcfg), cyc)
    np.testing.assert_array_equal(tc.zskip_cycles(torch.from_numpy(q), tcfg).numpy(), cyc)
    np.testing.assert_array_equal(
        tc.zskip_cycles_from_ones(torch.from_numpy(ones), tcfg).numpy(),
        rc.zskip_cycles_from_ones(ones, rcfg),
    )
    rows = np.arange(1, 300)
    np.testing.assert_array_equal(tc.baseline_cycles(rows, tcfg), rc.baseline_cycles(rows, rcfg))
    dens = np.linspace(0.0, 1.0, 11)
    np.testing.assert_array_equal(
        tc.expected_cycles_from_density(dens, 128, tcfg),
        rc.expected_cycles_from_density(dens, 128, rcfg),
    )


def test_ceil_division_on_torch_ints():
    """``-(-x // k)`` is a ceiling on torch ints as on numpy ints (torch's
    ``//`` floors), including 0 and values past 2**31."""
    x = np.array([0, 1, 7, 8, 9, 127, 128, 129, 2**33 + 5], dtype=np.int64)
    for k in (1, 2, 4, 8, 16, 32):
        want = -(-x // k)
        np.testing.assert_array_equal((-(-torch.from_numpy(x) // k)).numpy(), want)
        np.testing.assert_array_equal(want, np.ceil(x / k).astype(np.int64))


def test_bitplane_ones_rejects_non_uint8():
    with pytest.raises(TypeError, match="uint8"):
        tc.bitplane_ones(np.zeros((2, 8), np.int32))
    with pytest.raises(TypeError, match="uint8"):
        tc.bitplane_ones(torch.zeros((2, 8), dtype=torch.int32))

"""K1, the bit-plane popcount kernel: its plain PyTorch versions (the block
entry and the grouped derive entry) against the reference Pallas kernel
(interpret mode), and the CUDA kernel against the plain versions on the
card.

All outputs are integers, so every comparison is exact.  The reference is
imported inside a fixture, so the card-only tests also run where jax is
not installed.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.bitplane_profile import (
    bitplane_block_profile,
    bitplane_block_profile_ref,
    bitplane_grouped_cycles,
    bitplane_grouped_cycles_ref,
    bitplane_profile,
    grouped_plan,
)

R_RPR = [(r, rpr) for r in (128, 64, 37) for rpr in (4, 8, 16)]
# ragged grouped tables: (block rows, ((S, rows), ...), fill).  Rows 147 are
# not 16-byte aligned (ResNet18's conv1), 64 < 128 is one short block, 256
# and 384 are exact multiples, 27 is VGG11's conv1; S differs between
# entries and is 1 in some
TABLES = {
    "ragged128": (128, ((37, 147), (1, 64), (130, 256), (5, 300), (3, 27)), None),
    "block256": (256, ((20, 147), (9, 600), (1, 256), (129, 384)), None),
    "zeros": (128, ((37, 147), (1, 64), (130, 256)), 0),
    "ones": (128, ((37, 147), (1, 64), (130, 256)), 0xFF),
}


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


def _table(name, seed=0):
    br, shapes, fill = TABLES[name]
    rng = np.random.default_rng(seed)
    qs = []
    for s, rows in shapes:
        if fill is not None:
            qs.append(np.full((s, rows), fill, np.uint8))
            continue
        q = rng.integers(0, 256, size=(s, rows), dtype=np.uint8)
        q[rng.random((s, rows)) < 0.5] = 0  # ReLU-like sparsity
        qs.append(q)
    return br, qs


# rows_per_read 4 / 8 / 16 on the ragged table, 8 on the others (each
# (shape, rows_per_read) compiles the Pallas kernel anew)
GROUPED_CASES = [("ragged128", rpr) for rpr in (4, 8, 16)] + [(n, 8) for n in ("block256", "zeros", "ones")]


@pytest.mark.parametrize("name,rpr", GROUPED_CASES)
def test_plain_grouped_equals_pallas_layer_by_layer(ref, name, rpr):
    """The grouped plain version's flat cycles, entry by entry, equal the
    reference wrapper's (S, B) cycles per matrix (zero-padded last block)."""
    br, qs = _table(name)
    flat = bitplane_grouped_cycles(
        [torch.from_numpy(q) for q in qs], [br] * len(qs), rows_per_read=rpr, cycles_per_read=8
    )
    assert flat.dtype == torch.int64 and flat.dim() == 1
    off = 0
    for q in qs:
        _, want = ref.bitplane_profile(q, block_rows=br, rows_per_read=rpr, cycles_per_read=8, interpret=True)
        n = want.size
        np.testing.assert_array_equal(flat[off : off + n].numpy().reshape(want.shape), want)
        off += n
    assert off == flat.numel()


def test_grouped_fill_costs():
    """All-zero rows cost the 1-read floor per plane; all-0xFF rows read
    every row group of every plane of a block's true rows."""
    for name, per_plane in (("zeros", lambda rows: 1), ("ones", lambda rows: -(-rows // 8))):
        br, qs = _table(name)
        flat = bitplane_grouped_cycles_ref([torch.from_numpy(q) for q in qs], [br] * len(qs))
        want = []
        for q in qs:
            s, rows = q.shape
            blk = [min(br, rows - b * br) for b in range(-(-rows // br))]
            want.append(np.tile([8 * 8 * per_plane(n) for n in blk], s))
        np.testing.assert_array_equal(flat.numpy(), np.concatenate(want))


def test_grouped_wrapper_takes_plain_version_on_cpu_and_validates():
    br, qs = _table("ragged128")
    ts = [torch.from_numpy(q) for q in qs]
    before = bitplane_grouped_cycles.launches
    got = bitplane_grouped_cycles(ts, [br] * len(ts), rows_per_read=4)
    assert torch.equal(got, bitplane_grouped_cycles_ref(ts, [br] * len(ts), rows_per_read=4))
    assert bitplane_grouped_cycles.launches == before  # the plain version is no launch
    with pytest.raises(TypeError, match="uint8"):
        bitplane_grouped_cycles([ts[0].to(torch.int32)], [br])
    with pytest.raises(ValueError, match=r"\(S, rows\)"):
        bitplane_grouped_cycles([ts[0][0]], [br])
    with pytest.raises(ValueError, match="block row counts"):
        bitplane_grouped_cycles(ts, [br])
    with pytest.raises(ValueError, match="rows_per_read"):
        bitplane_grouped_cycles(ts, [br] * len(ts), rows_per_read=0)
    with pytest.raises(ValueError, match="block rows"):
        bitplane_grouped_cycles(ts, [0] * len(ts))


def test_grouped_plan_table():
    """The table the kernel reads: each entry's work items (blocks x tiles
    of 128 samples) after the previous entry's, its cycles after the
    previous entry's, the 16-byte alignment that picks the copy path, and
    a staged row pitch of an odd number of 16-byte units above the block."""
    br, qs = _table("ragged128")
    ts = [torch.from_numpy(q) for q in qs]
    plan = grouped_plan(ts, [br] * len(ts))
    table = plan.table.numpy()
    assert table.shape == (len(ts), 16)
    item = cyc = 0
    for row, (s, rows) in zip(table, TABLES["ragged128"][1]):
        nb, tiles = -(-rows // br), -(-s // 128)
        ptr, S, nrows, b, st_s, st_b, out_off, cs_s, cs_b, start, t, aligned = row[:12]
        assert (S, nrows, b, st_s, st_b, cs_s, cs_b) == (s, rows, br, rows, br, nb, 1)
        assert (out_off, start, t) == (cyc, item, tiles)
        assert aligned == int(ptr % 16 == 0 and rows % 16 == 0)
        item, cyc = item + nb * tiles, cyc + s * nb
    assert (plan.n_items, plan.total) == (item, cyc)
    assert plan.offsets == tuple(table[:, 6])
    assert plan.row_pitch % 16 == 0 and (plan.row_pitch // 16) % 2 == 1 and plan.row_pitch > br
    assert grouped_plan(ts, [br] * len(ts)) is plan  # cached


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("rpr", [4, 8, 16])
@pytest.mark.parametrize("name", list(TABLES))
def test_grouped_kernel_equals_plain_on_card(name, rpr):
    """One launch of the grouped kernel over a ragged table equals its plain
    version exactly, and the plan's offsets find each entry."""
    _cuda()
    br, qs = _table(name, seed=rpr)
    ts = [torch.from_numpy(q).cuda() for q in qs]
    before = bitplane_grouped_cycles.launches
    got = bitplane_grouped_cycles(ts, [br] * len(ts), rows_per_read=rpr, cycles_per_read=8)
    torch.cuda.synchronize()
    assert bitplane_grouped_cycles.launches == before + 1
    want = bitplane_grouped_cycles_ref(ts, [br] * len(ts), rows_per_read=rpr, cycles_per_read=8)
    assert torch.equal(got, want)
    offs = grouped_plan(ts, [br] * len(ts)).offsets
    assert offs[0] == 0 and list(offs) == sorted(offs)


@pytest.mark.cuda
def test_one_k1_launch_per_derive_on_card():
    """derive_profile on a capture on the card launches K1 once, whatever
    the layer count, and equals the torch engine there."""
    _cuda()
    import repro_torch as T

    for spec in (T.vgg11_cifar10(), T.resnet18_imagenet()):
        cap = T.capture_activations(spec, n_images=1, sample_patches=64, device="cuda")
        grouped, block = bitplane_grouped_cycles.launches, bitplane_block_profile.launches
        prof = T.derive_profile(cap, spec)
        torch.cuda.synchronize()
        assert bitplane_grouped_cycles.launches == grouped + 1
        assert bitplane_block_profile.launches == block
        plain = T.derive_profile(cap, spec, engine="torch")
        for a, b in zip(prof.layers, plain.layers, strict=True):
            for f in ("block_density", "mean_cycles", "cycles_sample", "baseline_block_cycles"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (a.name, f)

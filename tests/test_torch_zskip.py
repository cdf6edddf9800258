"""K3 (the zero-skip matmul) of the port against the reference.

On the host the port's ``zskip_matmul`` runs its plain version; it is held
against the reference's Pallas kernel in interpret mode and its
``ref.zskip_matmul_ref`` on the same numpy inputs, over every case of the
reference's own K3 tests (``tests/test_kernels.py:16-50`` and
``tests/test_zskip_masks.py``): masks derived from post-ReLU activations,
random masks at four densities, all-zero and all-ones masks, a mask that
drops live tiles, and unaligned shapes refused.  Tolerances are the
reference's: 1e-5 in float32 (1e-4 for its full-range random-mask cases),
2e-2 in bfloat16; on the card, float32 at 1e-4.

``zskip_matmul_op``, the model's entry point, builds the mask on A's device
and takes a ragged M (2 x 100 prompt rows, 4 decode rows), N (64) and K
(padded with zero columns); its mask is held against ``block_mask_ref`` on
the zero-padded input.

The card-only tests hold the CUDA kernel against its plain version; they
skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.zskip_matmul import zskip_matmul as pallas_zskip
from repro_torch.kernels import ops as tops
from repro_torch.kernels.zskip_matmul import (
    block_mask,
    block_mask_ref,
    zero_tiles,
    zskip_matmul,
    zskip_matmul_op_ref,
    zskip_matmul_ref,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# on the card the plain version's products are cuBLAS's, summed in another
# order: float32 at the reference's 1e-4 for full-range inputs
CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _torch(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _jax(a, dtype="float32"):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _sparse_act(rng, M, K, tile=128, keep=0.5):
    """Post-ReLU activations with about half the (tile, tile) tiles zero, as
    the reference's test builds them."""
    a = np.maximum(rng.standard_normal((M, K)), 0.0)
    tiles = rng.random((M // tile, K // tile)) < keep
    return (a * np.kron(tiles, np.ones((tile, tile)))).astype(np.float32)


# ------------------------------------------- tests/test_kernels.py:16-50


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 384, 128), (384, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel_and_ref(M, K, N, dtype):
    rng = np.random.default_rng(M + K + N)
    a = _sparse_act(rng, M, K)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ja, jb = _jax(a, dtype), _jax(b, dtype)
    mask = rref.block_mask_ref(ja, 128, 128)
    want = pallas_zskip(ja, jb, mask, interpret=True)
    want_ref = rref.zskip_matmul_ref(ja, jb, mask, 128, 128)
    ta = _torch(a, dtype)
    tmask = block_mask_ref(ta, 128, 128)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    got = zskip_matmul(ta, _torch(b, dtype), tmask)
    assert got.dtype == getattr(torch, dtype) and got.shape == (M, N)
    _close(got, want, TOL[dtype])
    _close(got, want_ref, TOL[dtype])


def test_exact_on_zero_tiles():
    a = np.zeros((256, 256), np.float32)
    a[:128, :128] = 1.0
    b = np.ones((256, 128), np.float32)
    mask = block_mask_ref(_torch(a), 128, 128)
    assert mask.tolist() == [[1, 0], [0, 0]]
    got = zskip_matmul(_torch(a), _torch(b), mask)
    np.testing.assert_array_equal(got.numpy(), a @ b)
    want = pallas_zskip(_jax(a), _jax(b), rref.block_mask_ref(_jax(a), 128, 128), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_op_matches_reference_op():
    rng = np.random.default_rng(1)
    a = np.maximum(rng.standard_normal((256, 256)), 0).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    want = rops.zskip_matmul_op(_jax(a), _jax(b))
    got = tops.zskip_matmul_op(_torch(a), _torch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=2e-5, atol=2e-5)


# ------------------------------------------------ tests/test_zskip_masks.py


@pytest.mark.parametrize(
    "M,K,N,bm,bn,bk",
    [
        (128, 256, 128, 64, 64, 64),
        (192, 64, 128, 64, 64, 64),
        (64, 320, 192, 64, 64, 64),
        (128, 128, 128, 128, 128, 128),
    ],
)
@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_random_masks(M, K, N, bm, bn, bk, density):
    rng = np.random.default_rng(int(M + K + N + density * 100))
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    mask = (rng.random((M // bm, K // bk)) < density).astype(np.int32)
    want = pallas_zskip(_jax(a), _jax(b), jnp.asarray(mask), bm=bm, bn=bn, bk=bk, interpret=True)
    want_ref = rref.zskip_matmul_ref(_jax(a), _jax(b), jnp.asarray(mask), bm, bk)
    got = zskip_matmul(_torch(a), _torch(b), torch.from_numpy(mask), bm=bm, bn=bn, bk=bk)
    # full-range gaussian inputs cancel: absolute-dominated, as the reference's 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=1e-4, atol=1e-4)


def test_all_zero_mask_is_exact_zero():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((128, 256)).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    mask = np.zeros((2, 4), np.int32)
    want = pallas_zskip(_jax(a), _jax(b), jnp.asarray(mask), bm=64, bn=64, bk=64, interpret=True)
    got = zskip_matmul(_torch(a), _torch(b), torch.from_numpy(mask), bm=64, bn=64, bk=64)
    np.testing.assert_array_equal(got.numpy(), np.zeros((128, 128), np.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_all_ones_mask_is_dense_matmul():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((128, 192)).astype(np.float32)
    b = rng.standard_normal((192, 64)).astype(np.float32)
    mask = np.ones((2, 3), np.int32)
    want = pallas_zskip(_jax(a), _jax(b), jnp.asarray(mask), bm=64, bn=64, bk=64, interpret=True)
    got = zskip_matmul(_torch(a), _torch(b), torch.from_numpy(mask), bm=64, bn=64, bk=64)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mask_zeroes_live_tiles():
    """'masked tile == zero tile', not 'mask == nonzero map'."""
    mask = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    got = zskip_matmul(torch.ones((128, 128)), torch.ones((128, 64)), mask, bm=64, bn=64, bk=64)
    np.testing.assert_array_equal(got.numpy(), np.full((128, 64), 64.0, np.float32))
    want = pallas_zskip(jnp.ones((128, 128)), jnp.ones((128, 64)), jnp.asarray(mask.numpy()),
                        bm=64, bn=64, bk=64, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_derived_mask_matches_dense_matmul():
    rng = np.random.default_rng(7)
    a = np.maximum(rng.standard_normal((128, 256)), 0)
    a = (a * np.kron(np.array([[1, 0, 0, 1], [0, 1, 1, 0]]), np.ones((64, 64)))).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    mask = block_mask_ref(_torch(a), 64, 64)
    assert int(mask.sum()) == 4
    got = zskip_matmul(_torch(a), _torch(b), mask, bm=64, bn=64, bk=64)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-4, atol=1e-4)


def test_rejects_unaligned_shapes():
    with pytest.raises(AssertionError):
        pallas_zskip(jnp.zeros((100, 128)), jnp.zeros((128, 128)), jnp.ones((1, 1), jnp.int32),
                     interpret=True)
    with pytest.raises(ValueError, match="multiples"):
        zskip_matmul(torch.zeros((100, 128)), torch.zeros((128, 128)), torch.ones((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="block_mask"):
        zskip_matmul(torch.zeros((128, 128)), torch.zeros((128, 128)), torch.ones((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="takes bm"):
        zskip_matmul(torch.zeros((96, 96)), torch.zeros((96, 96)), torch.ones((1, 1)), bm=96, bn=96, bk=96)
    with pytest.raises(TypeError, match="dtype"):
        tops.zskip_matmul_op(torch.zeros((4, 128)), torch.zeros((128, 64), dtype=torch.bfloat16))


# --------------------------------------------- the op's mask, ragged M and N


@pytest.mark.parametrize("M,N", [(200, 128), (4, 128), (200, 64), (256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_ragged_shapes(M, N, dtype):
    """The op's mask (built on A's device) against ``block_mask_ref`` on the
    zero-padded input; its product against the reference kernel's on the
    padded input, cut back, and against the plain product."""
    rng = np.random.default_rng(M + N)
    K, rows = 256, -(-M // 128) * 128
    a = np.zeros((rows, K), np.float32)
    a[:M] = _sparse_act(rng, rows, K)[:M]
    b = rng.standard_normal((K, N)).astype(np.float32)
    ta = _torch(a[:M], dtype)
    mask = block_mask(ta, 128, 128)
    np.testing.assert_array_equal(mask.numpy(), block_mask_ref(_torch(a, dtype), 128, 128).numpy())
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rref.block_mask_ref(_jax(a, dtype), 128, 128)))
    assert zero_tiles(ta) == (int((mask == 0).sum()), mask.numel())
    got = tops.zskip_matmul_op(ta, _torch(b, dtype))
    assert got.shape == (M, N) and got.dtype == getattr(torch, dtype)
    if N % 128 == 0:
        jmask = rref.block_mask_ref(_jax(a, dtype), 128, 128)
        want = pallas_zskip(_jax(a, dtype), _jax(b, dtype), jmask, interpret=True)[:M]
        _close(got, want, TOL[dtype])
    _close(got, (ta.float() @ _torch(b, dtype).float()).numpy(), TOL[dtype])


@pytest.mark.parametrize("K", [48, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_ragged_k(K, dtype):
    """A K off the tile is padded with zero columns: the product is the
    plain one, and a zero tile of the real columns is still skipped."""
    rng = np.random.default_rng(K)
    a = np.maximum(rng.standard_normal((130, K)), 0).astype(np.float32)
    a[128:] = 0.0
    b = rng.standard_normal((K, 64)).astype(np.float32)
    got = tops.zskip_matmul_op(_torch(a, dtype), _torch(b, dtype))
    assert got.shape == (130, 64)
    _close(got, (_torch(a, dtype).float() @ _torch(b, dtype).float()).numpy(), TOL[dtype])
    padded = np.pad(a, ((0, 0), (0, -K % 128)))
    assert zero_tiles(_torch(padded)) == (-(-K // 128), 2 * -(-K // 128))


def test_zero_tiles_counts_skipped_tiles():
    a = torch.zeros((200, 256))
    a[0, 0] = 1.0
    a[150, 200] = -2.0
    assert zero_tiles(a) == (2, 4)
    assert zero_tiles(a, bm=64, bk=64) == (14, 16)


def test_tma_copies_only_what_it_must():
    """bf16 operands go to the Hopper kernel through TMA, which reads rows
    that start on 16 bytes: an aligned operand is passed as it is; a row
    stride off 8 elements (N = 6100) or a base off 16 bytes is copied, with
    zero columns added up to a multiple of 8."""
    from repro_torch.kernels.zskip_matmul import _for_tma, _tma_ready

    b = torch.randn(64, 6144).to(torch.bfloat16)
    assert _tma_ready(b) and _for_tma(b) is b
    ragged = torch.randn(64, 6100).to(torch.bfloat16)
    padded = _for_tma(ragged)
    assert not _tma_ready(ragged) and _tma_ready(padded)
    assert padded.shape == (64, 6104) and torch.equal(padded[:, :6100], ragged)
    assert not padded[:, 6100:].any()
    base = torch.randn(129, 128).to(torch.bfloat16)
    view = torch.as_strided(base, (128, 128), (128, 1), 1)  # a base 2 bytes off
    assert not _tma_ready(view) and torch.equal(_for_tma(view)[:, :128], view)


# ------------------------------------------------------------ on the card


def _card_case(rng, M, K, N, dtype, density=None, bm=128, bk=128):
    a = rng.standard_normal((M, K)).astype(np.float32)
    if density is None:
        a = np.maximum(a, 0)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ta, tb = _torch(a, dtype).cuda(), _torch(b, dtype).cuda()
    if density is None:
        return ta, tb, None
    mask = torch.from_numpy((rng.random((M // bm, K // bk)) < density).astype(np.int32)).cuda()
    return ta, tb, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_equals_plain_on_card(dtype):
    """Random masks at four densities and tiles of 64 and 128, an all-ones
    and an all-zero mask, and both output types."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(0)
    tol = CARD_TOL[dtype]
    shapes = ((128, 256, 128, 64), (192, 64, 128, 64), (384, 256, 256, 128))
    # a grid of many blocks in bf16 (float32's full-range sums over K = 2048
    # differ from cuBLAS's by more than 1e-4: summation order)
    for M, K, N, t in shapes + (((1024, 2048, 512, 128),) if dtype == "bfloat16" else ()):
        for density in (0.0, 0.3, 0.7, 1.0):
            a, b, mask = _card_case(rng, M, K, N, dtype, density, t, t)
            for out in (torch.float32, torch.bfloat16):
                before = zskip_matmul.launches
                got = zskip_matmul(a, b, mask, bm=t, bn=t, bk=t, out_dtype=out)
                torch.cuda.synchronize()
                assert zskip_matmul.launches == before + 1 and got.dtype == out
                want = zskip_matmul_ref(a, b, mask, t, t, out)
                o_tol = max(tol, TOL["bfloat16"] if out == torch.bfloat16 else 0.0)
                torch.testing.assert_close(got.float(), want.float(), rtol=o_tol, atol=o_tol)
            if density == 0.0:
                assert not got.float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_ragged_on_card(dtype):
    """Ragged M (2 x 200 prompt rows, 4 decode rows: K split across blocks)
    and N (64), against the plain product with the same mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(1)
    tol = CARD_TOL[dtype]
    for M, K, N in ((400, 1024, 512), (4, 4096, 1024), (4, 256, 64), (400, 256, 64), (130, 200, 64)):
        a, b, _ = _card_case(rng, M, K, N, dtype)
        got = tops.zskip_matmul_op(a, b)
        want = zskip_matmul_op_ref(a, b)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_hopper_kernel_shapes_on_card():
    """The bf16 kernel's own cases: bm = 64, where the two consumer
    warpgroups of a 128-row block read different mask rows (random masks);
    M spanning many persistent waves with ragged M and N (B copied for
    TMA); and Nemotron-4-15B's decode shape, K split across blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(2)
    tol = CARD_TOL["bfloat16"]
    for density in (0.3, 0.7):
        a, b, mask = _card_case(rng, 448, 512, 320, "bfloat16", density, 64, 64)
        got = zskip_matmul(a, b, mask, bm=64, bn=64, bk=64)
        torch.testing.assert_close(got.float(), zskip_matmul_ref(a, b, mask, 64, 64).float(), rtol=tol, atol=tol)
    for M, K, N in ((4000, 24576, 6100), (4, 24576, 6144)):
        a = torch.square(torch.relu(torch.randn(M, K, device="cuda"))).to(torch.bfloat16)
        b = (torch.randn(K, N, device="cuda") / K ** 0.5).to(torch.bfloat16)
        before = zskip_matmul.launches
        got = tops.zskip_matmul_op(a, b)
        torch.cuda.synchronize()
        assert zskip_matmul.launches == before + 1 and got.shape == (M, N)
        want = zskip_matmul_op_ref(a, b).float()
        err = ((got.float() - want).abs() / (1 + want.abs())).max()
        assert err <= tol, (M, K, N, float(err))

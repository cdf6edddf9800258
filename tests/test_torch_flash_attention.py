"""K4 (flash attention) of the port against the reference.

On the host the port's K4 runs its plain version (dense float32 softmax);
it is held against the reference's Pallas kernel in interpret mode, the
reference's ``ref.flash_attention_ref`` and the model's ``layers._sdpa``,
on the same inputs made with numpy.  Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-5 in float32, 3e-2 in bfloat16.  The
Pallas kernel needs s to be a multiple of its tile (min(128, s)), so the
ragged s = 200 is held against ``_sdpa`` only.

The card-only tests hold the CUDA kernel against its plain version at the
shapes ``chip_smoke.py`` checks; they skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as rlayers
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_op,
    flash_attention_op_ref,
    flash_attention_ref,
)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=TOL[dtype], atol=TOL[dtype]
    )


@pytest.mark.parametrize("s", [77, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_kernel_and_ref(s, dtype, causal):
    q, k, v = _qkv((3, s, 32), seed=s)
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    bq = min(128, s)
    want = pallas_flash(jq, jk, jv, causal=causal, bq=bq, bk=bq, interpret=True)
    want_ref = rref.flash_attention_ref(jq, jk, jv, causal=causal)
    got = flash_attention(*(_torch(a, dtype) for a in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, s, 32)
    _close(got, want, dtype)
    _close(got, want_ref, dtype)


@pytest.mark.parametrize("s", [77, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_reference_op(s, dtype):
    """The (b, s, h, hd) wrappers: the reference folds the heads into the
    batch axis, the port reads them by stride."""
    q, k, v = _qkv((2, s, 4, 16), seed=7)
    want = rops.flash_attention_op(*(_jax(a, dtype) for a in (q, k, v)), causal=True)
    got = tops.flash_attention_op(*(_torch(a, dtype) for a in (q, k, v)), causal=True)
    assert got.shape == (2, s, 4, 16)
    _close(got, want, dtype)


@pytest.mark.parametrize("s", [1, 77, 128, 200, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_model_sdpa(s, dtype, causal):
    """K4 is what the model's _sdpa computes over a whole prompt from
    position 0, with or without the masked tail of a preallocated cache."""
    q, k, v = _qkv((2, s, 4, 16), seed=11)
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    got = flash_attention_op(*(_torch(a, dtype) for a in (q, k, v)), causal=causal)
    _close(got, rlayers._sdpa(jq, jk, jv, causal), dtype)
    # the cache path of gqa_fwd at len 0: keys padded to max_seq, kv_len = s
    pad = ((0, 0), (0, 5), (0, 0), (0, 0))
    want = rlayers._sdpa(jq, jnp.pad(jk, pad), jnp.pad(jv, pad), causal, q_offset=0, kv_len=s)
    _close(got, want, dtype)


@pytest.mark.parametrize("group", [2, 6, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_grouped_plain_matches_model_sdpa(group, dtype, causal):
    """Grouped kv heads: query head h reads kv head h // group, as the
    reference model's _sdpa_block groups them (q.reshape(b, s, kv, rep, hd))."""
    nkv, s = 2, 77
    rng = np.random.default_rng(group)
    q = rng.standard_normal((2, s, nkv * group, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, nkv, 16)).astype(np.float32) for _ in range(2))
    want = rlayers._sdpa(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype), causal)
    got = flash_attention_op(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype), causal=causal)
    assert got.shape == (2, s, nkv * group, 16)
    _close(got, want, dtype)
    # and K4's function per head: query head h against kv head h // group
    h = nkv * group - 1
    one = flash_attention_ref(_torch(q, dtype)[:, :, h], _torch(k, dtype)[:, :, h // group],
                              _torch(v, dtype)[:, :, h // group], causal)
    _close(got[:, :, h], one.float().numpy(), dtype)


def test_round_scores_plain_matches_model_sdpa():
    """F6 closed: with ``round_scores`` the plain version rounds q . k to
    bf16 before the float32 scale, as the reference model's _sdpa_block
    does; what is left is the reference rounding its normalised
    probabilities.  (2, 200, 12 q / 2 kv heads, 128), N(0, 2^2), causal."""
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((2, 200, 12, 128)) * 2).astype(np.float32)
    k, v = ((rng.standard_normal((2, 200, 2, 128)) * 2).astype(np.float32) for _ in range(2))
    want = np.asarray(rlayers._sdpa(*(_jax(a, "bfloat16") for a in (q, k, v)), True), np.float32)
    got = flash_attention_op_ref(*(_torch(a, "bfloat16") for a in (q, k, v)), True, round_scores=True)
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= 2.0 ** -6 * np.maximum(1.0, np.abs(want))).all(), float(diff.max())
    # the op takes the keyword on the host too
    assert torch.equal(tops.flash_attention_op(*(_torch(a, "bfloat16") for a in (q, k, v)), causal=True,
                                               round_scores=True), got)


@pytest.mark.parametrize("causal", [True, False])
def test_round_scores_changes_nothing_in_float32(causal):
    q, k, v = (_torch(a, "float32") for a in _qkv((2, 33, 4, 16), seed=5))
    assert torch.equal(flash_attention_op(q, k[:, :, :2], v[:, :, :2], causal=causal, round_scores=True),
                       flash_attention_op(q, k[:, :, :2], v[:, :, :2], causal=causal))


def test_checks():
    q = torch.zeros((2, 8, 4, 16))
    with pytest.raises(ValueError, match="multiple of the kv heads"):
        flash_attention_op(q, torch.zeros((2, 8, 3, 16)), torch.zeros((2, 8, 3, 16)))
    with pytest.raises(TypeError, match="share a dtype"):
        flash_attention_op(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="at least one"):
        flash_attention(torch.zeros((2, 0, 16)), torch.zeros((2, 4, 16)), torch.zeros((2, 4, 16)))
    with pytest.raises(ValueError, match="differ"):
        flash_attention(torch.zeros((2, 4, 16)), torch.zeros((3, 4, 16)), torch.zeros((3, 4, 16)))


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_equals_plain_on_card(dtype, hd):
    """s in 1, 77, 200, 1000, 1024, causal and not; sq != sk; unaligned rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    for s in (1, 77, 200, 1000, 1024):
        for causal in (True, False):
            q, k, v = (_torch(a, dtype).cuda() for a in _qkv((6, s, hd), seed=hd + s))
            before = flash_attention.launches
            got = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1
            want = flash_attention_ref(q, k, v, causal)
            torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    # fewer or more keys than queries
    for sq, sk in ((200, 77), (77, 200)):
        q = _torch(_qkv((6, sq, hd), seed=1)[0], dtype).cuda()
        k, v = (_torch(a, dtype).cuda() for a in _qkv((6, sk, hd), seed=2)[:2])
        for causal in (True, False):
            got, want = flash_attention(q, k, v, causal=causal), flash_attention_ref(q, k, v, causal)
            torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    # rows that are not 16-byte aligned (float32 reads them by stride; bf16 copies them first)
    q, k, v = (_torch(a, dtype).cuda()[..., :hd] for a in _qkv((6, 77, hd + 1), seed=hd))
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, True)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_on_model_layout_on_card(dtype):
    """Zamba2's prefill shape, (4, 1024, 32, 64), read by stride."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    q, k, v = (_torch(a, dtype).cuda() for a in _qkv((4, 1024, 32, 64), seed=3))
    got = tops.flash_attention_op(q, k, v, causal=True)
    want = flash_attention_op_ref(q, k, v, True)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_grouped_kernel_on_card():
    """Grouped kv heads at the dense models' prefill shapes in bf16, causal
    (Nemotron-4-15B 48 on 8, GLM-4-9B 32 on 2, Qwen2-VL-2B 12 on 2, head
    dim 128), and small float32 shapes with groups of 1, 2, 6 and 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(5)
    cases = [((4, 1024, nq, 128), nkv, "bfloat16", True) for nq, nkv in ((48, 8), (32, 2), (12, 2))]
    cases += [((2, 77, 2 * g, 64), 2, "float32", c) for g in (1, 2, 6, 16) for c in (True, False)]
    for (b, s, nq, hd), nkv, dtype, causal in cases:
        q = _torch(rng.standard_normal((b, s, nq, hd)).astype(np.float32), dtype).cuda()
        k, v = (_torch(rng.standard_normal((b, s, nkv, hd)).astype(np.float32), dtype).cuda()
                for _ in range(2))
        before = flash_attention.launches
        got = tops.flash_attention_op(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = flash_attention_op_ref(q, k, v, causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_hopper_kernel_groups_on_card(hd):
    """The bf16 wgmma kernel at head dims 64 and 128 with groups of 1, 6
    and 16 (two query heads of a group share a block), causal and not,
    with and without the rounding of the scores, against the plain version
    with the same keyword.  Unit-scale inputs, as the reference's tolerance
    assumes: rounding the scores is not continuous, and where the kernel's
    and the plain version's float32 sums of a score fall on two sides of a
    bf16 rounding boundary the two round it one step apart, a step that
    grows with the scores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(hd)
    for group in (1, 6, 16):
        for s in (77, 200, 1024):
            q = _torch(rng.standard_normal((2, s, 2 * group, hd)).astype(np.float32), "bfloat16").cuda()
            k, v = (_torch(rng.standard_normal((2, s, 2, hd)).astype(np.float32), "bfloat16").cuda()
                    for _ in range(2))
            for causal in (True, False):
                for rounded in (False, True):
                    got = tops.flash_attention_op(q, k, v, causal=causal, round_scores=rounded)
                    torch.cuda.synchronize()
                    want = flash_attention_op_ref(q, k, v, causal, round_scores=rounded)
                    torch.testing.assert_close(got.float(), want.float(), rtol=TOL["bfloat16"],
                                               atol=TOL["bfloat16"])


def _step_share(got, want):
    """The share of entries more than one bf16 step, 2^-7 of 1 + |want|,
    from ``want``."""
    d = (got.float() - want.float()).abs()
    return float((d > 2.0 ** -7 * (1 + want.float().abs())).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_round_scores_told_apart_on_card(hd):
    """At N(0, 2^2) inputs the rounding of the scores moves about a tenth of
    the outputs by more than a bf16 step, so the wgmma kernel with either
    keyword must be within a step of the plain version with the same one at
    all but 1e-3 of the entries, and farther than a step at 1e-2 or more
    from the other one.  A share, not a maximum: where the kernel's and the
    plain version's float32 sums of a large score round to neighbouring bf16
    values, a few outputs move by more than the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(10 + hd)
    for s in (200, 1024):
        q = _torch(2 * rng.standard_normal((2, s, 12, hd)).astype(np.float32), "bfloat16").cuda()
        k, v = (_torch(2 * rng.standard_normal((2, s, 2, hd)).astype(np.float32), "bfloat16").cuda()
                for _ in range(2))
        want = {r: flash_attention_op_ref(q, k, v, True, round_scores=r) for r in (False, True)}
        for rounded in (False, True):
            got = tops.flash_attention_op(q, k, v, causal=True, round_scores=rounded)
            torch.cuda.synchronize()
            assert _step_share(got, want[rounded]) <= 1e-3
            assert _step_share(got, want[not rounded]) >= 1e-2

"""K5 (the SSD chunk kernel) and the port's Mamba2 layer against the reference.

* K5's plain version against the reference's Pallas ``ssd_chunk`` in
  interpret mode, at the shapes of ``tests/test_kernels.py``
  (``test_ssd_chunk_matches_ref``), with its tolerances (1e-4 float32,
  5e-2 bfloat16).
* The port's ``ssd_chunked`` (K5 inside, the inter-chunk recurrence in
  torch) against the reference's, with a carried-in state and a ragged
  length; ``ssd_step``; and the whole Mamba2 mixer (``mamba2_fwd``,
  ``mamba2_step``) from the reference's parameters.  Float32 at 1e-4 of
  max |ref|; bfloat16 at 5e-2 on inputs whose log-decays stay small (see
  ``test_torch_lm.py`` for why the model's bf16 drifts further).

Inputs are made with numpy from a seed and handed to both packages.  The
card-only tests hold the CUDA kernels against their plain version at the
Zamba2 and Mamba2-370M prefill shapes (the Hopper kernel), at shapes whose
work queue is ragged, and at small ones (the mma.sync and float32 kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.ssd_scan import ssd_chunk as pallas_ssd
from repro.models import ssm as rssm
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import head_group, ssd_chunk, ssd_chunk_ref
from repro_torch.models import ssm as tssm

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _chunk_inputs(nc, Q, H, P, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((nc, Q, H)))) * 0.1
    cum = np.cumsum(-dt, axis=1).astype(np.float32)
    xdt = (rng.standard_normal((nc, Q, H, P)) * 0.5).astype(np.float32)
    B = rng.standard_normal((nc, Q, N)).astype(np.float32)
    C = rng.standard_normal((nc, Q, N)).astype(np.float32)
    return cum, xdt, B, C


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("Q,H,P,N", [(32, 4, 16, 32), (64, 8, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(Q, H, P, N, dtype):
    cum, xdt, B, C = _chunk_inputs(3, Q, H, P, N, seed=Q + H)
    y_want, s_want = pallas_ssd(*(_jax(a, dtype) for a in (cum, xdt, B, C)),
                                head_block=min(4, H), interpret=True)
    y, s = ssd_chunk(*(_torch(a, dtype) for a in (cum, xdt, B, C)))
    assert y.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    assert y.shape == (3, Q, H, P) and s.shape == (3, H, N, P)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_want, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want, np.float32), rtol=tol, atol=tol)


def test_head_group_fills_the_card():
    """The work split: heads per item for (cells, heads, SMs), the fewest
    waves of items, each item costing its heads plus one."""
    assert head_group(32, 64, 132) == 16  # Zamba2 prefill: 128 items, one wave on the H100
    assert head_group(8, 32, 132) == 2  # Mamba2-370M at 2 x 512: 128 items
    assert head_group(140, 7, 132) == 4  # groups of 4 and 3, 280 items: the queue hands out 2 or 3 a block
    assert head_group(45, 37, 132) == 8  # four groups of 8 and one of 5, 225 items
    assert head_group(1, 3, 132) == 1  # one cell: a head an item, three SMs in parallel
    assert head_group(300, 1, 132) == 1
    with pytest.raises(ValueError, match="head_group"):
        head_group(0, 4, 132)


def _scan_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.2)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    S0 = (rng.standard_normal((b, h, n, p)) * 0.3).astype(np.float32)
    return x, dt, A, B, C, S0


_ref_ssd_chunked = jax.jit(rssm.ssd_chunked, static_argnames=("chunk",))


@pytest.mark.parametrize("s,chunk", [(64, 32), (50, 16), (7, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(s, chunk, dtype, with_state):
    x, dt, A, B, C, S0 = _scan_inputs(2, s, 4, 16, 32, seed=s)
    init_j = _jax(S0, dtype) if with_state else None
    init_t = _torch(S0, dtype) if with_state else None
    y_w, S_w = _ref_ssd_chunked(*(_jax(a, dtype) for a in (x, dt, A, B, C)), chunk=chunk, init_state=init_j)
    y, S = tssm.ssd_chunked(*(_torch(a, dtype) for a in (x, dt, A, B, C)), chunk=chunk, init_state=init_t)
    assert y.shape == (2, s, 4, 16) and S.shape == (2, 4, 32, 16)
    assert y.dtype == S.dtype == getattr(torch, dtype)
    assert _rel(y, y_w) <= TOL[dtype] and _rel(S, S_w) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_step_matches_reference(dtype):
    x, dt, A, B, C, S0 = _scan_inputs(3, 1, 4, 16, 32, seed=5)
    args = (S0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    y_w, S_w = rssm.ssd_step(*(_jax(a, dtype) for a in args))
    y, S = tssm.ssd_step(*(_torch(a, dtype) for a in args))
    assert _rel(y, y_w) <= TOL[dtype] and _rel(S, S_w) <= TOL[dtype]


def test_ssd_step_continues_the_chunked_scan():
    """Decoding one more token from the scan's final state equals the scan
    over the longer sequence (float32)."""
    x, dt, A, B, C, _ = (torch.from_numpy(a) for a in _scan_inputs(2, 21, 4, 16, 32, seed=9))
    y_all, S_all = tssm.ssd_chunked(x, dt, A, B, C, chunk=8)
    _, S_20 = tssm.ssd_chunked(x[:, :20], dt[:, :20], A, B[:, :20], C[:, :20], chunk=8)
    y_last, S_last = tssm.ssd_step(S_20, x[:, 20], dt[:, 20], A, B[:, 20], C[:, 20])
    torch.testing.assert_close(y_last, y_all[:, 20], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(S_last, S_all, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def mamba_layer():
    """Mamba2-370M SMOKE's mixer with the reference's parameters."""
    rcfg, tcfg = ref_config("mamba2-370m", smoke=True), get_config("mamba2-370m", smoke=True)
    rp = rssm.init_mamba2(jax.random.PRNGKey(3), rcfg)
    layer = tssm.Mamba2(tcfg, None, "cpu")
    state = {k: np.asarray(v) for k, v in rp.items() if k != "gate_norm"}
    state["gate_norm.scale"] = np.asarray(rp["gate_norm"]["scale"])
    layer.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in state.items()})
    return rcfg, rp, tcfg, layer


def test_mamba2_fwd_and_step_match_reference(mamba_layer):
    """float32: the full-sequence mixer with a carried state at a ragged
    length, then one decode step from a cache."""
    rcfg, rp, tcfg, layer = mamba_layer
    rcfg, tcfg = rcfg.with_(dtype="float32"), tcfg.with_(dtype="float32")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 45, rcfg.d_model)).astype(np.float32)
    S0 = (rng.standard_normal((2, 8, 16, 16)) * 0.1).astype(np.float32)
    y_w, S_w = jax.jit(rssm.mamba2_fwd, static_argnums=1)(rp, rcfg, jnp.asarray(x), init_state=jnp.asarray(S0))
    y, S = tssm.mamba2_fwd(layer, tcfg, torch.from_numpy(x), init_state=torch.from_numpy(S0))
    assert _rel(y, y_w) <= 1e-4 and _rel(S, S_w) <= 1e-4

    cache_j = rssm.init_mamba2_cache(rcfg, 2, jnp.float32)
    cache_j = dict(cache_j, ssm=jnp.asarray(S0), conv_x=jnp.asarray(rng.standard_normal(cache_j["conv_x"].shape), jnp.float32))
    cache_t = {k: torch.from_numpy(np.array(v)) for k, v in cache_j.items()}
    out_w, new_w = jax.jit(rssm.mamba2_step, static_argnums=1)(rp, rcfg, jnp.asarray(x[:, :1]), cache_j)
    out, new = tssm.mamba2_step(layer, tcfg, torch.from_numpy(x[:, :1]), cache_t)
    assert new is cache_t  # written in place
    assert _rel(out, out_w) <= 1e-4
    for k in ("conv_x", "conv_B", "conv_C", "ssm"):
        assert _rel(new[k], new_w[k]) <= 1e-4, k


# ------------------------------------------------------------ on the card

CARD_SHAPES = [
    (32, 128, 64, 64, 64),  # Zamba2-1.2B prefill, 4 x 1024 tokens
    (8, 128, 32, 64, 128),  # Mamba2-370M prefill, 2 x 512 tokens
    (140, 128, 7, 64, 64),  # the Hopper kernel's work queue ragged: groups of 4 and 3, 280 items
    (45, 128, 37, 64, 128),  # and at N 128: groups of 8 and 5, 225 items
    (3, 32, 4, 16, 32),
    (5, 16, 3, 16, 16),
    (3, 48, 5, 24, 48),
    (2, 77, 5, 24, 40),  # Q and N off the bf16 kernel's multiples of 16: float32 only
]
# The kernel against its plain version, of 1 + |plain|: in bf16 one bf16 step,
# since both round the decayed B alike and differ only in summation order
# and y's final rounding.
CARD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_equals_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    tol = CARD_TOL[dtype]
    for nc, Q, H, P, N in CARD_SHAPES:
        ins = [_torch(a, dtype).cuda() for a in _chunk_inputs(nc, Q, H, P, N, seed=nc + Q)]
        if dtype == "bfloat16" and Q % 16:
            with pytest.raises(ValueError, match="bfloat16 takes"):
                ssd_chunk(*ins)
            continue
        y_w, s_w = ssd_chunk_ref(*ins)
        for _ in range(2):  # twice: the work queue is left at zero for the next launch
            before = ssd_chunk.launches
            y, s = ssd_chunk(*ins)
            torch.cuda.synchronize()
            assert ssd_chunk.launches == before + 1
            # y and S apart, each of 1 + |plain|
            torch.testing.assert_close(y.float(), y_w.float(), rtol=tol, atol=tol)
            torch.testing.assert_close(s, s_w, rtol=tol, atol=tol)

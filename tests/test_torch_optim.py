"""The port's optimizer and gradient compression against the reference.

* AdamW (``optim.adamw``): the schedule at every step of warmup, decay and
  past the end; the global norm; one update from a non-zero state with the
  clip active and inactive, and its metrics.  The port writes the
  reference's expressions in the same order in float32, so parameters, m
  and v agree to a float32 rounding or two (``b ** step`` and ``cos`` are
  the two libraries' own: rtol 1e-6).
* ``quantize_int8`` with deterministic rounding bit for bit (q and scale,
  ties to even as ``jnp.round``), ``dequantize_int8`` and the
  error-feedback helpers equal.
* The reference's compression properties (``tests/test_compress.py``) on
  the port: the rounding error bound, unbiased stochastic rounding from a
  ``torch.Generator``, error feedback transmitting a sub-step component, SGD
  with int8 + error feedback converging, float32 residuals; the mesh-only
  ``compressed_psum`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.optim import adamw as radamw
from repro.optim import compress as rcomp
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcomp

SHAPES = {"w": (16, 8), "b": (8,), "scale": (3, 5, 2)}


def _tree(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in SHAPES.items():
        x = rng.standard_normal(s).astype(np.float32) * scale
        out[k] = np.abs(x) if positive else x
    return out


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(lr=1e-3, warmup_steps=5, total_steps=8),
    dict(lr=2e-2, warmup_steps=0, total_steps=3, min_lr_frac=0.0),
    dict(lr=1e-3, warmup_steps=10, total_steps=10),
])
def test_schedule_matches_reference(cfg):
    rc, tc = radamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    for step in range(0, 40):
        want = float(radamw._schedule(rc, jnp.asarray(step, jnp.int32)))
        got = float(tadamw._schedule(tc, torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_global_norm_matches_reference():
    tree = _tree(0, 3.0)
    want = float(radamw.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    assert float(tadamw.global_norm(_torch(tree))) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # clip inactive, active
@pytest.mark.parametrize("step0", [0, 7])
def test_update_matches_reference(grad_scale, step0):
    cfg = dict(lr=1e-3, warmup_steps=5, total_steps=20, weight_decay=0.1, clip_norm=1.0)
    params, grads = _tree(1), _tree(2, grad_scale)
    m0 = _tree(3, 0.01) if step0 else {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    v0 = _tree(4, 1e-4, positive=True) if step0 else {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    rstate = {"m": {k: jnp.asarray(v) for k, v in m0.items()}, "v": {k: jnp.asarray(v) for k, v in v0.items()},
              "step": jnp.asarray(step0, jnp.int32)}
    rp, rs, rm = jax.jit(lambda g, p, s: radamw.adamw_update(radamw.AdamWConfig(**cfg), g, p, s))(
        {k: jnp.asarray(v) for k, v in grads.items()}, {k: jnp.asarray(v) for k, v in params.items()}, rstate)
    tp = _torch(params)
    tstate = {"m": _torch(m0), "v": _torch(v0), "step": torch.tensor(step0, dtype=torch.int32)}
    out_p, out_s, tm = tadamw.adamw_update(tadamw.AdamWConfig(**cfg), _torch(grads), tp, tstate)
    assert out_p is tp and out_s is tstate  # updated in place
    assert int(out_s["step"]) == int(rs["step"]) == step0 + 1 and out_s["step"].dtype == torch.int32
    assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
    assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    clipped = float(rm["grad_norm"]) > cfg["clip_norm"]
    assert clipped == (grad_scale > 1)
    for k in SHAPES:
        np.testing.assert_allclose(out_p[k].numpy(), np.asarray(rp[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(out_s["m"][k].numpy(), np.asarray(rs["m"][k]), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(out_s["v"][k].numpy(), np.asarray(rs["v"][k]), rtol=1e-6, atol=1e-15)


def test_init_keys_like_the_parameters():
    model = torch.nn.Linear(3, 2)
    st_ = tadamw.adamw_init(model)
    assert set(st_["m"]) == set(st_["v"]) == {"weight", "bias"}
    assert st_["m"]["weight"].dtype == torch.float32 and int(st_["step"]) == 0
    assert st_["step"].dtype == torch.int32


# ----------------------------------------------------------- compression


@pytest.mark.parametrize("seed", range(4))
def test_quantize_int8_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(257) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    x[:4] = [0.0, x.max(), -x.max(), x.max() / 2]  # a tie at 63.5
    q, s = rcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert float(ts) == float(s)
    np.testing.assert_array_equal(tcomp.dequantize_int8(tq, ts).numpy(), np.asarray(rcomp.dequantize_int8(q, s)))


def test_error_feedback_helpers_match_reference():
    grads, res = _tree(5), _tree(6, 0.1)
    want = rcomp.apply_error_feedback({k: jnp.asarray(v) for k, v in grads.items()},
                                      {k: jnp.asarray(v) for k, v in res.items()})
    got = tcomp.apply_error_feedback(_torch(grads), _torch(res))
    for k in SHAPES:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False), min_size=4, max_size=64))
@settings(max_examples=100, deadline=None)
def test_quantization_error_bound(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    q, scale = tcomp.quantize_int8(x)
    err = (tcomp.dequantize_int8(q, scale) - x).abs()
    # deterministic rounding: error <= scale/2 elementwise
    assert float(err.max()) <= float(scale) / 2 + 1e-6


def test_stochastic_rounding_unbiased():
    x = torch.full((20000,), 0.3) * 127.0 / 127.0
    q, scale = tcomp.quantize_int8(x, torch.Generator().manual_seed(0))
    assert abs(float(tcomp.dequantize_int8(q, scale).mean()) - 0.3) < 0.01


def test_error_feedback_recovers_signal():
    """A component smaller than half a quantization step still transmits
    through the residual."""
    big, small = 127.0, 0.2
    g = {"g": torch.tensor([big, small])}
    residual = {"g": torch.zeros(2)}
    sent = torch.zeros(2)
    for _ in range(20):
        carried = tcomp.apply_error_feedback(g, residual)
        q, scale = tcomp.quantize_int8(carried["g"])
        approx = tcomp.dequantize_int8(q, scale)
        residual = {"g": carried["g"] - approx}
        sent += approx
    assert float(sent[1]) == pytest.approx(20 * small, rel=0.15)
    assert float(sent[0]) == pytest.approx(20 * big, rel=0.01)


def test_sgd_with_compression_converges():
    target = torch.tensor([1.5, -2.0, 0.5, 3.0])
    for compressed in (False, True):
        w = torch.zeros(4, requires_grad=True)
        residual = {"w": torch.zeros(4)}
        for _ in range(200):
            loss = torch.sum((w - target) ** 2)
            (g,) = torch.autograd.grad(loss, w)
            if compressed:
                carried = tcomp.apply_error_feedback({"w": g}, residual)
                q, scale = tcomp.quantize_int8(carried["w"])
                g = tcomp.dequantize_int8(q, scale)
                residual = {"w": carried["w"] - g}
            with torch.no_grad():
                w -= 0.05 * g
        assert float(torch.sum((w.detach() - target) ** 2)) < 1e-3, "compressed" if compressed else "exact"


def test_init_error_feedback_shapes():
    tree = {"a": torch.zeros((3, 4), dtype=torch.bfloat16), "b": torch.ones(2)}
    r = tcomp.init_error_feedback(tree)
    assert r["a"].shape == (3, 4) and r["a"].dtype == torch.float32


def test_compressed_psum_needs_a_mesh():
    """One rank (no process group): the int8 ring has no hop, so the mean
    is the dequantised tensor and the error what quantising lost, x - q *
    scale rounded once, as XLA fuses the reference's expression (the
    multi-rank ring is ``test_torch_compress_dist.py``'s)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32))
    mean, err = tcomp.compressed_psum(x)
    q, scale = tcomp.quantize_int8(x)
    assert mean.dtype == x.dtype and err.dtype == torch.float32
    assert torch.equal(mean, tcomp.dequantize_int8(q, scale))
    assert torch.equal(err, (x.double() - q.double() * scale.double()).float())
    assert float(err.abs().max()) <= float(scale) / 2

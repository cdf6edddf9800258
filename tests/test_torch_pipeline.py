"""The port's GPipe schedule (``distrib.pipeline``) against the reference's.

The reference's test program (``tests/test_pipeline_pp.py``: L 8 tanh
layers of width 16, microbatches of 2, M 6, 4 stages) runs on 4 host
devices in a subprocess, its 'pipe' mesh with an Auto axis, and the port's
on 4 gloo ranks (``test_torch_distrib_ranks.run_both``), from the same
numpy inputs.  The outputs are within 2e-5 of the reference's; the
gradients of sum(out^2) with respect to every stage's parameters, which the
reference's own test only checks are finite, are within 1e-5 of
``jax.grad`` of the reference's schedule (and of the sequential loop's).
``bubble_fraction``, ``stack_stages`` and ``report_stage_plan`` equal the
reference's.
"""

import numpy as np
import pytest
import torch

from test_torch_distrib_ranks import run_both

L, D, MB, M, STAGES = 8, 16, 2, 6, 4
OUT_TOL, GRAD_TOL = 2e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _x64_shim():
    # the reference imports jax.experimental.enable_x64, which jax 0.9
    # removed; provide it for this module only
    import jax.experimental

    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)
        yield


def inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return w, b, xs


REF_PROG = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, "tests")
from test_torch_pipeline import L, M, STAGES, inputs
from repro.distrib.pipeline import make_pipeline_fn, stack_stages
work = sys.argv[1]
w, b, xs = (jnp.asarray(a) for a in inputs())

def stage_fn(stage_params, x):
    def body(xx, pl):
        return jnp.tanh(xx @ pl["w"] + pl["b"]), None
    return jax.lax.scan(body, x, stage_params)[0]

mesh = jax.make_mesh((STAGES,), ("pipe",), axis_types=(AxisType.Auto,))
stages, _ = stack_stages({"w": w, "b": b}, np.ones(L), STAGES)
fn = make_pipeline_fn(stage_fn, mesh, n_micro=M)
with mesh:
    out = jax.jit(fn)(stages, xs)
    g = jax.jit(jax.grad(lambda st, x: jnp.sum(fn(st, x) ** 2)))(stages, xs)
np.savez(work + "/ref.npz", out=np.asarray(out), gw=np.asarray(g["w"]), gb=np.asarray(g["b"]))
"""


def pipeline_ranks(rank, world, work):
    """The schedule on this rank's stage; each rank saves its output and its
    stage's gradients."""
    from test_torch_pipeline import L, M, inputs

    from repro_torch.distrib.pipeline import make_pipeline_fn, stack_stages
    from repro_torch.launch.mesh import make_device_mesh

    w, b, xs = (torch.from_numpy(a) for a in inputs())

    def stage_fn(sp, x):
        for i in range(sp["w"].shape[0]):
            x = torch.tanh(x @ sp["w"][i] + sp["b"][i])
        return x

    mesh = make_device_mesh((world,), ("pipe",), "cpu")
    stages, _ = stack_stages({"w": w, "b": b}, np.ones(L), world)
    sw, sb = (stages[k].clone().requires_grad_(True) for k in ("w", "b"))
    out = make_pipeline_fn(stage_fn, mesh, n_micro=M)({"w": sw, "b": sb}, xs).to_local()
    (out**2).sum().backward()
    np.savez(f"{work}/port_{rank}.npz", out=out.detach().numpy(), gw=sw.grad[rank].numpy(), gb=sb.grad[rank].numpy())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipe")
    run_both(REF_PROG, STAGES, "test_torch_pipeline", "pipeline_ranks", STAGES, work)
    ref = dict(np.load(work / "ref.npz"))
    port = [dict(np.load(work / f"port_{r}.npz")) for r in range(STAGES)]
    return ref, port


def _sequential():
    """The layers in order, and autograd's gradients of sum(out^2)."""
    w, b, xs = (torch.from_numpy(a) for a in inputs())
    w.requires_grad_(True)
    b.requires_grad_(True)
    x = xs
    for i in range(L):
        x = torch.tanh(x @ w[i] + b[i])
    (x**2).sum().backward()
    return x.detach().numpy(), w.grad.numpy(), b.grad.numpy()


def test_outputs_match_reference(results):
    ref, port = results
    seq, _, _ = _sequential()
    for r in range(STAGES):  # the masked psum leaves every rank the outputs
        np.testing.assert_allclose(port[r]["out"], ref["out"], rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(ref["out"], seq, rtol=OUT_TOL, atol=OUT_TOL)


def test_gradients_match_reference(results):
    ref, port = results
    per = L // STAGES
    gw = np.stack([port[r]["gw"] for r in range(STAGES)])
    gb = np.stack([port[r]["gb"] for r in range(STAGES)])
    np.testing.assert_allclose(gw, ref["gw"], rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(gb, ref["gb"], rtol=GRAD_TOL, atol=GRAD_TOL)
    _, sw, sb = _sequential()
    np.testing.assert_allclose(gw.reshape(L, D, D), sw, rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(gb.reshape(L, D), sb, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert gw.shape == (STAGES, per, D, D)


@pytest.mark.parametrize("n_stages,n_micro", [(1, 8), (4, 12), (4, 48), (4, 4), (8, 3)])
def test_bubble_fraction_matches_reference(n_stages, n_micro):
    from repro.distrib.pipeline import bubble_fraction as ref_bubble
    from repro_torch.distrib.pipeline import bubble_fraction

    assert bubble_fraction(n_stages, n_micro) == ref_bubble(n_stages, n_micro)


def test_stack_stages_matches_reference():
    import jax.numpy as jnp

    from repro.distrib.pipeline import stack_stages as ref_stack
    from repro_torch.distrib.pipeline import stack_stages

    costs = np.random.default_rng(1).random(12)
    layers = np.arange(12 * 3, dtype=np.float32).reshape(12, 3)
    got, loads = stack_stages({"w": torch.from_numpy(layers)}, costs, 3)
    want, want_loads = ref_stack({"w": jnp.asarray(layers)}, costs, 3)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(loads, want_loads)
    with pytest.raises(ValueError, match="must divide"):
        stack_stages({"w": torch.zeros(10, 2)}, np.ones(10), 3)


@pytest.mark.parametrize("costs", [[10, 1, 1, 1, 10, 1, 1, 1, 10, 1, 1, 1], [1, 1, 1, 1, 1, 1, 1, 1, 20, 1, 1, 1],
                                   list(range(1, 13))])
def test_report_stage_plan_matches_reference(costs):
    from repro.distrib.pipeline import report_stage_plan as ref_plan
    from repro_torch.distrib.pipeline import report_stage_plan

    costs = np.asarray(costs, dtype=float)
    assert report_stage_plan(costs, 3) == ref_plan(costs, 3)

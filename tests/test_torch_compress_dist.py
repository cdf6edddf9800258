"""The int8 pod reduction (``optim.compress.compressed_psum``) and the
compressed train step (``train.step.make_compressed_train_step``) across
ranks, against the reference's.

The reference runs in a subprocess with 4 host devices, its meshes with
Auto axes; the port on gloo ranks (2 and 4, ``test_torch_distrib_ranks``'s
launchers), from the same numpy inputs.

* ``compressed_psum`` at 2 and 4 ranks: every payload a rank receives on
  the ring is int8, and it and its float32 scale are bit-equal to the
  reference's ``quantize_int8`` of the sending rank's tensor (the tensor
  ``i - h`` after h hops); each rank's mean is bit-equal to the reference's
  ring expressions on those payloads, each product and sum rounded once (as
  XLA fuses them), and within 1 float32 ulp of the reference's
  ``compressed_psum`` under ``shard_map`` on that rank, its error equal.
  Where the compiled ring quantises with a scale one step off its own
  ``quantize_int8`` (XLA took max / 127 as a product by the reciprocal in
  one of these programs; it is recorded from the same program), the means
  are held at 1e-6 of max |mean| instead.
* ``make_compressed_train_step`` on GLM-4-9B SMOKE in float32, as
  ``tests/test_compress.py`` runs it, 2 steps at pod 1 and at pod 2 (a
  (pod, 1, 1) mesh, the batch split over the pods): the losses within 1e-6
  and the parameters by ``test_torch_train_step``'s rule (a few entries
  may differ by up to 2 lr: AdamW's first steps turn rounding at a half
  quantum into a whole step); and on a loss linear in the parameters,
  whose gradients are the same numbers in both packages, the losses and
  every parameter within 1e-5 of the reference's.  The int8 scale is per
  reference leaf (a stack's layers together), as the reference quantises
  its stacked leaves.
"""

import numpy as np
import pytest
import torch

from test_torch_distrib_ranks import run_both, save_tree, start_ranks, wait_all

SHAPES = [(37, 11), (5,), (3, 4, 8)]
STEP_TOL = 1e-5
LOSS_TOL, PARAM_TOL, PARAM_SHARE = 1e-6, 1e-5, 1e-3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
BATCH, SEQ, STEPS = 4, 32, 2


@pytest.fixture(scope="module", autouse=True)
def _x64_shim():
    # the reference imports jax.experimental.enable_x64, which jax 0.9
    # removed; provide it for this module only
    import jax.experimental

    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)
        yield


def tensors(n: int):
    """Rank r's tensors: one per shape, rank-dependent scales, a few exact
    halves of a quantum (ties, which both round to even)."""
    rng = np.random.default_rng(100 + n)
    out = []
    for shape in SHAPES:
        xs = (rng.standard_normal((n, *shape)) * (1.0 + np.arange(n)).reshape(-1, *[1] * len(shape)))
        out.append(xs.astype(np.float32))
    return out


REF_PROG = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh, PartitionSpec as P
sys.path.insert(0, "tests")
from test_torch_compress_dist import BATCH, OPT, STEPS, tensors
from test_torch_distrib_ranks import load_tree
from repro.configs import get_config
from repro.distrib.compat import shard_map
from repro.distrib.context import set_mesh
from repro.models import lm
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.optim.compress import compressed_psum, init_error_feedback, quantize_int8
from repro.train.step import make_compressed_train_step
work = sys.argv[1]
out = {}
for n in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("pod",), axis_types=(AxisType.Auto,))
    for j, xs in enumerate(tensors(n)):
        # the ring, and the payload it quantises as this program compiles it
        fn = shard_map(lambda x: tuple(a[None] for a in compressed_psum(x[0], "pod", n) + quantize_int8(x[0])),
                       mesh=mesh, in_specs=P("pod"), out_specs=(P("pod"),) * 4)
        with mesh:
            mean, err, ring_q, ring_scale = jax.jit(fn)(jnp.asarray(xs))
        out[f"psum{n}_{j}_mean"], out[f"psum{n}_{j}_err"] = np.asarray(mean), np.asarray(err)
        out[f"psum{n}_{j}_ring_q"], out[f"psum{n}_{j}_ring_scale"] = np.asarray(ring_q), np.asarray(ring_scale)
        qs = [quantize_int8(jnp.asarray(x)) for x in xs]
        out[f"psum{n}_{j}_q"] = np.stack([np.asarray(q) for q, _ in qs])
        out[f"psum{n}_{j}_scale"] = np.stack([np.asarray(s) for _, s in qs])
cfg = get_config("glm4-9b", smoke=True).with_(dtype="float32")
toks = np.load(work + "/tokens.npy")
coeffs = jax.tree.map(jnp.asarray, load_tree(work + "/coeffs.npz"))
model_loss = lm.loss_fn


def linear_loss(params, cfg, tokens, targets):
    w = jnp.mean(tokens.astype(jnp.float32)) / cfg.vocab
    return sum(jnp.sum(p * c) for p, c in zip(jax.tree.leaves(params), jax.tree.leaves(coeffs))) * w


for tag, pods in (("step", 1), ("step", 2), ("lin", 1), ("lin", 2)):
    lm.loss_fn = model_loss if tag == "step" else linear_loss
    set_mesh(None)
    mesh = Mesh(np.array(jax.devices()[:pods]).reshape(pods, 1, 1), ("pod", "data", "model"),
                axis_types=(AxisType.Auto,) * 3)
    params = jax.tree.map(jnp.asarray, load_tree(work + "/params.npz"))
    opt, ef = adamw_init(params), init_error_feedback(params)
    step = make_compressed_train_step(cfg, AdamWConfig(**OPT), mesh)
    with mesh:
        jitted = jax.jit(step)
        for s in range(STEPS):
            batch = {"tokens": jnp.asarray(toks[s, :, :-1]), "targets": jnp.asarray(toks[s, :, 1:])}
            params, opt, ef, m = jitted(params, opt, ef, batch)
            out[f"{tag}{pods}_loss_{s}"] = np.asarray(m["loss"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"{tag}{pods}_param_" + "/".join(k.key for k in path)] = np.asarray(leaf)
np.savez(work + "/ref.npz", **out)
"""


def psum_ranks(rank, world, work):
    """compressed_psum over the world group, the payloads received kept."""
    from test_torch_compress_dist import tensors

    from repro_torch.optim import compress as tcomp

    got = []
    orig = tcomp._ring_hop

    def hop(q, scale, group):
        rq, rs = orig(q, scale, group)
        got.append((rq.clone(), rs.clone()))
        return rq, rs

    tcomp._ring_hop = hop
    out = {}
    for j, xs in enumerate(tensors(world)):
        got.clear()
        mean, err = tcomp.compressed_psum(torch.from_numpy(xs[rank]))
        out[f"mean_{j}"], out[f"err_{j}"] = mean.numpy(), err.numpy()
        out[f"hops_{j}"] = np.stack([q.numpy() for q, _ in got])
        out[f"hop_scales_{j}"] = np.stack([s.numpy()[0] for _, s in got])
        out[f"hop_dtypes_{j}"] = np.array([str(q.dtype) for q, _ in got])
    tcomp._ring_hop = orig
    if world == 2:
        out.update(_steps(rank, world, work))
        out.update(_steps(rank, world, work, linear=True))
    np.savez(f"{work}/port{world}_{rank}.npz", **out)


def _steps(rank, pods, work, linear=False) -> dict:
    """The compressed step on GLM-4-9B SMOKE at ``pods`` pods; with
    ``linear``, on the linear loss instead of the model's."""
    from test_torch_compress_dist import OPT, STEPS
    from test_torch_distrib_ranks import load_tree

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.distrib.sharding import distribute, param_specs
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.compress import init_error_feedback
    from repro_torch.train.step import make_compressed_train_step

    from repro_torch.models import lm

    cfg = get_config("glm4-9b", smoke=True).with_(dtype="float32")
    toks = torch.from_numpy(np.load(f"{work}/tokens.npy")).long()
    mesh = make_device_mesh((pods, 1, 1), ("pod", "data", "model"), "cpu")
    model_loss, tag = lm.loss_fn, "lin" if linear else "step"
    if linear:
        coeffs = dict(lm_params_from_numpy(load_tree(f"{work}/coeffs.npz"), cfg, "cpu").named_parameters())

        def linear_loss(params, cfg, tokens, targets):
            w = tokens.float().mean() / cfg.vocab
            return sum((p * coeffs[k]).sum() for k, p in params.named_parameters()) * w

        lm.loss_fn = linear_loss
    params = lm_params_from_numpy(load_tree(f"{work}/params.npz"), cfg, "cpu")
    opt, ef = adamw_init(params), init_error_feedback(params)
    distribute(params, param_specs(cfg, params, mesh), mesh)
    step = make_compressed_train_step(cfg, AdamWConfig(**OPT), mesh)
    out = {}
    try:
        for s in range(STEPS):
            params, opt, ef, m = step(params, opt, ef, {"tokens": toks[s, :, :-1], "targets": toks[s, :, 1:]})
            out[f"{tag}_loss_{s}"] = m["loss"].numpy()
    finally:
        lm.loss_fn = model_loss
    full = {k: p.full_tensor() for k, p in params.named_parameters()}
    for path, leaf in _flat(lm_params_to_numpy(full)):
        out[f"{tag}_param_" + path] = leaf
    return out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def one_rank_steps(rank, world, work):
    np.savez(f"{work}/port1_{rank}.npz", **_steps(rank, 1, work), **_steps(rank, 1, work, linear=True))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import lm as rlm

    work = tmp_path_factory.mktemp("compress")
    cfg = ref_config("glm4-9b", smoke=True)
    params = jax.tree.map(np.asarray, rlm.init_params(cfg, jax.random.PRNGKey(0)))
    save_tree(work / "params.npz", params)
    rng = np.random.default_rng(4)
    # the sign of each initial parameter, so that the sum of p * c has no
    # cancellation and its float32 rounding stays near 1e-7
    save_tree(work / "coeffs.npz", jax.tree.map(
        lambda a: (np.abs(rng.standard_normal(a.shape)) * np.where(a < 0, -1, 1)).astype(np.float32), params))
    np.save(work / "tokens.npy", np.random.default_rng(3).integers(0, cfg.vocab, (STEPS, BATCH, SEQ + 1)))
    (work / "w4").mkdir()
    (work / "w1").mkdir()
    for sub in ("w4", "w1"):
        for f in ("tokens.npy", "params.npz", "coeffs.npz"):
            (work / sub / f).write_bytes((work / f).read_bytes())
    procs = start_ranks("test_torch_compress_dist", "psum_ranks", 4, work / "w4")
    procs1 = start_ranks("test_torch_compress_dist", "one_rank_steps", 1, work / "w1")
    run_both(REF_PROG, 4, "test_torch_compress_dist", "psum_ranks", 2, work)
    wait_all(procs, "port ranks (4)", 240)
    wait_all(procs1, "port rank (1)", 240)
    ref = dict(np.load(work / "ref.npz"))
    port = {2: [dict(np.load(work / f"port2_{r}.npz")) for r in range(2)],
            4: [dict(np.load(work / "w4" / f"port4_{r}.npz")) for r in range(4)],
            1: [dict(np.load(work / "w1" / "port1_0.npz"))]}
    return ref, port


def _ring_model(q, scale, r, n):
    """The reference's ring expressions on rank r, each product and sum
    rounded once (the fused multiply-add XLA compiles them to)."""
    total = (q[r].astype(np.float32) * scale[r]).astype(np.float32)
    for h in range(1, n):
        k = (r - h) % n
        total = (total.astype(np.float64) + q[k].astype(np.float64) * np.float64(scale[k])).astype(np.float32)
    return total / np.float32(n)


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_payload_and_mean(results, n):
    ref, port = results
    for j in range(len(SHAPES)):
        q, scale = ref[f"psum{n}_{j}_q"], ref[f"psum{n}_{j}_scale"]
        same_payload = np.array_equal(ref[f"psum{n}_{j}_ring_scale"], scale) and np.array_equal(
            ref[f"psum{n}_{j}_ring_q"], q)
        for r in range(n):
            got = port[n][r]
            assert list(got[f"hop_dtypes_{j}"]) == ["torch.int8"] * (n - 1)  # int8 on the wire
            for h in range(1, n):
                np.testing.assert_array_equal(got[f"hops_{j}"][h - 1], q[(r - h) % n])
                assert got[f"hop_scales_{j}"][h - 1] == scale[(r - h) % n]
            np.testing.assert_array_equal(got[f"mean_{j}"], _ring_model(q, scale, r, n))
            want = ref[f"psum{n}_{j}_mean"][r]
            if same_payload:
                ulp = np.spacing(np.abs(want).astype(np.float32))
                assert np.all(np.abs(got[f"mean_{j}"] - want) <= ulp), (n, j, r)
                np.testing.assert_array_equal(got[f"err_{j}"], ref[f"psum{n}_{j}_err"][r])
            else:
                # this compiled ring took a scale one float32 step off its own
                # quantize_int8 (max / 127 as a product by the reciprocal); the
                # port sends the expression's payload, and the means then
                # differ by what that step moves: within 1e-6 of max |mean|
                assert np.abs(got[f"mean_{j}"] - want).max() <= 1e-6 * np.abs(want).max(), (n, j, r)


def _params(ref, got, tag, pods):
    keys = [k for k in ref if k.startswith(f"{tag}{pods}_param_")]
    assert len(keys) == len([k for k in got if k.startswith(f"{tag}_param_")])
    for k in keys:
        yield k, got[f"{tag}_param_" + k[len(f"{tag}{pods}_param_"):]], ref[k]


@pytest.mark.parametrize("pods", [1, 2])
def test_compressed_step_matches_reference(results, pods):
    """On the model's loss: both steps' losses within 1e-6 (relative), and
    the parameters by ``test_torch_train_step``'s rule: within 1e-5 of their
    leaf's max |p| for all but 1e-3 of the entries, every entry within 2 lr
    a step.  AdamW's first steps normalise each gradient element to about
    +-1, and the int8 ring turns a gradient element that sits within the
    packages' rounding differences of a half quantum into a whole quantum,
    so a few entries may move by up to 2 lr differently (measured: 2 of
    139,584 after two steps, at pods 1 and 2)."""
    ref, port = results
    lr, wd = OPT["lr"], 0.1
    for r, got in enumerate(port[pods]):
        for s in range(STEPS):
            want = float(ref[f"step{pods}_loss_{s}"])
            assert abs(float(got[f"step_loss_{s}"]) - want) <= LOSS_TOL * abs(want), (r, s)
        off = total = 0
        for k, have, want in _params(ref, got, "step", pods):
            d = np.abs(have - want)
            off += int((d > PARAM_TOL * np.abs(want).max()).sum())
            total += d.size
            assert d.max() <= 2 * lr * STEPS * (1 + wd * np.abs(want).max()), (r, k)
        assert off <= PARAM_SHARE * total, (r, off, total)


@pytest.mark.parametrize("pods", [1, 2])
def test_compressed_step_exact_on_a_linear_loss(results, pods):
    """On a loss linear in the parameters (sum of p * c over every
    parameter, c fixed and of p's initial sign, times the pod's mean token /
    vocab), whose gradients
    are the same numbers in both packages: the error feedback, the int8
    ring across the pods, the pod-averaged loss and AdamW give the
    reference's losses and parameters within 1e-5, two steps."""
    ref, port = results
    for r, got in enumerate(port[pods]):
        for s in range(STEPS):
            want = float(ref[f"lin{pods}_loss_{s}"])
            assert abs(float(got[f"lin_loss_{s}"]) - want) <= STEP_TOL * max(abs(want), 1.0), (r, s)
        for k, have, want in _params(ref, got, "lin", pods):
            assert np.abs(have - want).max() <= STEP_TOL, (r, k)

"""The port's sharding rules against the reference's, leaf by leaf.

The reference's specs are computed on ``jax.sharding.AbstractMesh`` (no
devices), the port's on ``distrib.compat.MeshShape`` of the same axes, for
every architecture at SMOKE and FULL on the (1, 1), (16, 16) and
(2, 16, 16) meshes.  The parameter trees come from ``jax.eval_shape`` of
the reference's ``init_params`` and from the port's model on the meta
device; ``convert.lm_param_path`` maps the port's names to the reference's
stacked paths, whose spec carries one more leading ``None`` (the layer
axis).  Entries are compared after normalising (a 1-tuple is its name,
trailing ``None``s dropped).

* ``param_specs`` and ``cache_specs``: equal.
* ``opt_specs``: equal, except where the reference puts ZeRO-1's DP axes on
  a stacked moment's layer axis, which the port's per-layer tensors do not
  have; there the port's spec is the parameter's with the DP axes on the
  first per-layer dim they divide (the same bytes a device whenever one
  does).
* ``moe_ep_axes`` (with and without replication), ``data_specs`` and
  ``cell_is_defined`` for every (arch, shape): equal.
* ``kernels.ref``'s oracles equal to the reference's on the same inputs.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import cell_is_defined as ref_cell_is_defined
from repro.configs import get_config as ref_config
from repro.distrib import sharding as rs
from repro.kernels import ref as rref
from repro.models import encdec as renc
from repro.models import lm as rlm
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.configs import cell_is_defined, get_config
from repro_torch.convert import lm_param_path
from repro_torch.distrib import sharding as ps
from repro_torch.distrib.compat import P, MeshShape, axes_of, placements
from repro_torch.kernels import ref as tref
from repro_torch.models.encdec import EncDec, init_decoder_cache
from repro_torch.models.lm import LM, init_cache

MESHES = [(1, 1), (16, 16), (2, 16, 16)]


@pytest.fixture(scope="module", autouse=True)
def _x64_shim():
    # the reference imports jax.experimental.enable_x64, which jax 0.9
    # removed; provide it for this module only
    import jax.experimental

    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)
        yield


def meshes(shape):
    names = ("pod", "data", "model")[-len(shape):]
    return AbstractMesh(shape, names), MeshShape(dict(zip(names, shape)))


def norm(spec) -> tuple:
    e = list(P(*tuple(spec)))
    while e and e[-1] is None:
        e.pop()
    return tuple(e)


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


def trees(arch, smoke):
    rc, pc = ref_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    if rc.family == "encdec":
        rt = jax.eval_shape(lambda: renc.init_encdec_params(rc, jax.random.PRNGKey(0)))
        return rc, pc, rt, EncDec(pc, None, "meta")
    return rc, pc, jax.eval_shape(lambda: rlm.init_params(rc, jax.random.PRNGKey(0))), LM(pc, None, "meta")


def port_as_ref(name, spec):
    path, layer = lm_param_path(name)
    return path, norm(((None,) if layer is not None else ()) + tuple(spec))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, shape):
    am, pm = meshes(shape)
    for smoke in (True, False):
        rc, pc, rt, model = trees(arch, smoke)
        ref = dict(flat(rs.param_specs(rc, rt, am)))
        got = ps.param_specs(pc, model, pm)
        assert {lm_param_path(n)[0] for n in got} == set(ref)
        for name, spec in got.items():
            path, mine = port_as_ref(name, spec)
            assert mine == norm(ref[path]), (smoke, name)


def zero_per_layer(param_spec, shape, dp, dp_n) -> P:
    """Where the reference put ZeRO-1's DP axes on a stacked moment's layer
    axis, the port's spec: the parameter's, with the DP axes on the first
    per-layer dim they divide (none if none does)."""
    full = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = {a for e in full for a in axes_of(e)}
    if not used.intersection(dp):
        for i, n in enumerate(shape):
            if full[i] is None and n % dp_n == 0 and n >= dp_n:
                full[i] = dp
                break
    return P(*full)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_specs_match_reference(arch):
    for shape in MESHES:
        am, pm = meshes(shape)
        dp = ps.batch_axes(pm)
        sizes = dict(zip(pm.mesh_dim_names, pm.shape))
        dp_n = math.prod(sizes[a] for a in dp)
        for smoke in (True, False):
            rc, pc, rt, model = trees(arch, smoke)
            ref = dict(flat(rs.opt_specs(rc, jax.eval_shape(lambda: ref_adamw_init(rt)), am)))
            shapes = dict(model.named_parameters())
            got = ps.opt_specs(pc, {"m": shapes, "v": shapes}, pm)
            assert got["step"] == P() and norm(ref["step"]) == ()
            pspec = ps.param_specs(pc, model, pm)
            for name, t in shapes.items():
                path, layer = lm_param_path(name)
                for k in ("m", "v"):
                    want = norm(ref[f"{k}/{path}"])
                    _, mine = port_as_ref(name, got[k][name])
                    if layer is not None and want and want[0] is not None:
                        want = norm((None,) + tuple(zero_per_layer(pspec[name], tuple(t.shape), dp, dp_n)))
                    assert mine == want, (shape, smoke, k, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch):
    for shape in MESHES:
        am, pm = meshes(shape)
        for smoke, (b, s) in ((True, (4, 64)), (False, (128, 1024))):
            rc, pc = ref_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
            if rc.family == "encdec":
                rcache = jax.eval_shape(lambda: renc.init_decoder_cache(rc, b, s, jnp.bfloat16))
                pcache = init_decoder_cache(pc, b, s, torch.bfloat16, "meta")
            else:
                rcache = jax.eval_shape(lambda: rlm.init_cache(rc, b, s, jnp.bfloat16))
                pcache = init_cache(pc, b, s, torch.bfloat16, "meta")
            ref = dict(flat(rs.cache_specs(rc, rcache, am)))
            got = ps.cache_specs(pc, pcache, pm)
            names = {f"{g}/{n}" for g, sub in got.items() for n in sub}
            assert names == {k for k in ref if not k.endswith("/len")}  # the port's len is a host int
            for g, sub in got.items():
                for n, spec in sub.items():
                    assert norm(spec) == norm(ref[f"{g}/{n}"]), (shape, smoke, g, n)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_ep_axes_and_cells_match_reference(arch):
    for shape in MESHES:
        am, pm = meshes(shape)
        for smoke in (True, False):
            rc, pc = ref_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
            assert ps.moe_ep_axes(pc, pm) == tuple(rs.moe_ep_axes(rc, am))
            if rc.moe.n_experts:
                n = rc.moe.n_experts
                repl = tuple([2] * (n // 2) + [1] * (n - n // 2))
                rr = rc.with_(moe=dataclasses.replace(rc.moe, replication=repl))
                pr = pc.with_(moe=dataclasses.replace(pc.moe, replication=repl))
                assert ps.moe_ep_axes(pr, pm) == tuple(rs.moe_ep_axes(rr, am))
    for shape in SHAPES:
        assert cell_is_defined(arch, shape) == ref_cell_is_defined(arch, shape)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_data_specs_and_placements(shape):
    am, pm = meshes(shape)
    for b in (1, 7, 16, 32, 256, 512):
        assert norm(ps.data_specs(pm, b)) == norm(rs.data_specs(am, b))
    # a spec's placements: Shard on each axis an entry names, major to minor
    # in mesh order; Replicate elsewhere
    spec = P(ps.batch_axes(pm), None, "model")
    pls = placements(spec, pm)
    for name, pl in zip(pm.mesh_dim_names, pls):
        want = 2 if name == "model" else 0
        assert pl.is_shard(want), (name, pl)
    with pytest.raises(ValueError, match="mesh's order"):
        placements(P(("model", "data")), pm)


KERNEL_CASES = ["block_mask", "zskip_matmul", "flash_attention", "ssd_chunk"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernels_ref_matches_reference(name):
    """``kernels.ref`` has the reference's oracle names, each the plain
    version its kernel's module keeps, equal to the reference's on the same
    inputs (float32: 1e-5 of max |ref|)."""
    rng = np.random.default_rng(7)
    assert set(tref.__all__) == set(rref.__all__)
    if name == "block_mask":
        a = rng.standard_normal((64, 96)).astype(np.float32)
        a[:32, 32:64] = 0
        got = tref.block_mask_ref(torch.from_numpy(a), 16, 32).numpy()
        np.testing.assert_array_equal(got, np.asarray(rref.block_mask_ref(jnp.asarray(a), 16, 32)))
        return
    if name == "zskip_matmul":
        a = rng.standard_normal((64, 96)).astype(np.float32)
        b = rng.standard_normal((96, 48)).astype(np.float32)
        mask = (rng.random((4, 3)) > 0.3).astype(np.int32)
        got = tref.zskip_matmul_ref(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(mask), 16, 32)
        want = np.asarray(rref.zskip_matmul_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), 16, 32))
    elif name == "flash_attention":
        q, k, v = (rng.standard_normal((3, 40, 16)).astype(np.float32) for _ in range(3))
        got = tref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
        want = np.asarray(rref.flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)), causal=True))
    else:
        cum = np.cumsum(-rng.random((2, 16, 3)).astype(np.float32), axis=1)
        xdt = rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
        B, C = (rng.standard_normal((2, 16, 4)).astype(np.float32) for _ in range(2))
        got_y, got_s = tref.ssd_chunk_ref(*(torch.from_numpy(x) for x in (cum, xdt, B, C)))
        want_y, want_s = rref.ssd_chunk_ref(*(jnp.asarray(x) for x in (cum, xdt, B, C)))
        want_s = np.asarray(want_s)
        assert np.abs(got_s.numpy() - want_s).max() <= 1e-5 * np.abs(want_s).max()
        got, want = got_y, np.asarray(want_y)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()

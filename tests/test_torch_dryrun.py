"""The port's dry run (``launch.specs``, ``launch.dryrun``,
``core.hlo_analysis``, ``core.roofline``) against the reference's.

The port's cells run one rank of a ``fake`` process group under
``FakeTensorMode`` (``launch.dryrun.fake_group``), here at SMOKE size on a
(2, 2) ("data", "model") mesh of 4 fake ranks; the reference's numbers come
from its specs on ``jax.sharding.AbstractMesh`` (no devices) and, for the
FLOPs, from its ``hlo_analysis`` of the compiled step on a (1, 1) mesh with
Auto axes (the Explicit axes jax 0.9 makes by default fail there, ROADMAP
F2).

* ``build_cell`` for every (arch, shape) at SMOKE: the step, its kind, the
  model FLOPs of the reference's formulas, and every argument a DTensor
  placed as the specs say.
* Argument bytes a device equal to the reference's specs' arithmetic
  (numpy, no compile): parameters (bf16 when serving), the AdamW state
  when training (ZeRO-1 per layer where the reference shards the layer
  axis, ``test_torch_distrib.zero_per_layer``), the batch, the cache when
  decoding (less the reference's per-layer ``len`` counters, a host int in
  the port).
* A SMOKE train cell's FLOPs are within 5% of the reference's HLO count
  (one rank's step of every cell: ``test_torch_dryrun_cells.py``).
* ``Roofline``'s properties equal the reference's formulas on the same
  inputs and hardware; the port's hardware is the H100's data sheet.
"""

import math

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, AxisType
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, SHAPE_SPECS, SHAPES
from repro.configs import get_config as ref_config
from repro.core import roofline as rroof
from repro.distrib import sharding as rs
from repro.models import encdec as renc
from repro.models import lm as rlm
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.core import roofline as troof
from repro_torch.core.hlo_analysis import analyze_step
from repro_torch.distrib.compat import auto_region
from repro_torch.distrib.context import set_mesh
from repro_torch.launch.dryrun import fake_group, shard_bytes
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.specs import build_cell
from test_torch_distrib import zero_per_layer

FLOP_TOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _x64_shim():
    # the reference imports jax.experimental.enable_x64, which jax 0.9
    # removed; provide it for this module only
    import jax.experimental

    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)
        yield


@pytest.fixture
def mesh22():
    with fake_group(4):
        yield make_device_mesh((2, 2), ("data", "model"), "cpu")
    set_mesh(None)


def _spec_bytes(tree, specs, am) -> int:
    """Bytes a device of ``tree``'s leaves under ``specs`` (the reference's)."""
    sizes = dict(zip(am.axis_names, am.axis_sizes))
    total = 0
    for (path, leaf), spec in zip(jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        if path and getattr(path[-1], "key", None) == "len":
            continue  # the port's cache length is a host int
        n = 1
        for entry in spec:
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                n *= sizes[a]
        total += math.prod(leaf.shape) // n * jnp.dtype(leaf.dtype).itemsize
    return total


def _port_zero(rc, opt, specs, pspecs, am):
    """The reference's opt specs, with the port's ZeRO-1 on the leaves where
    the reference shards the stacked layer axis (the port has none; see
    ``test_torch_distrib.zero_per_layer``), stack kept: the spec of the
    reference's leaf whose layers the port shards one by one."""
    sizes = dict(zip(am.axis_names, am.axis_sizes))
    dp = tuple(a for a in am.axis_names if a in ("pod", "data"))
    dp_n = math.prod(sizes[a] for a in dp)

    def fix(path, leaf, spec):
        keys = [getattr(k, "key", None) for k in path]
        stacked = len(keys) > 1 and keys[1] in ("layers", "enc_layers", "dec_layers")
        if not stacked or not tuple(spec) or tuple(spec)[0] is None:
            return spec
        pspec = pspecs
        for k in keys[1:]:
            pspec = pspec[k]
        per_layer = tuple(pspec)[1:]
        return P(None, *zero_per_layer(per_layer, leaf.shape[1:], dp, dp_n))

    return jax.tree_util.tree_map_with_path(
        lambda path, leaf, spec: fix(path, leaf, spec), opt, specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _ref_arg_bytes(arch, shape, am) -> int:
    rc = ref_config(arch, smoke=True)
    kind = SHAPE_SPECS[shape]["kind"]
    B, S = 2, 32
    enc = rc.family == "encdec"
    p = jax.eval_shape(lambda: (renc.init_encdec_params if enc else rlm.init_params)(rc, jax.random.PRNGKey(0)))
    if kind != "train":
        p = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.bfloat16) if a.dtype == jnp.float32 else a, p)
    total = _spec_bytes(p, rs.param_specs(rc, p, am), am)
    d = rs.data_specs(am, B)
    frames = jax.ShapeDtypeStruct((B, rc.encoder_seq, rc.d_model), jnp.dtype(rc.dtype))
    tok = jax.ShapeDtypeStruct((B, S if kind != "decode" else 1), jnp.int32)
    n_tok = 2 if kind == "train" else 1
    total += n_tok * _spec_bytes(tok, d, am) + (_spec_bytes(frames, d, am) if enc else 0)
    if kind == "train":
        o = jax.eval_shape(lambda: ref_adamw_init(p))
        total += _spec_bytes(o, _port_zero(rc, o, rs.opt_specs(rc, o, am), rs.param_specs(rc, p, am), am), am)
    if kind == "decode":
        c = jax.eval_shape(lambda: (renc.init_decoder_cache if enc else rlm.init_cache)(rc, B, S, jnp.dtype(rc.dtype)))
        total += _spec_bytes(c, rs.cache_specs(rc, c, am), am)
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_cell_every_shape(mesh22, arch):
    from repro_torch.configs import get_config

    am = AbstractMesh((2, 2), ("data", "model"))
    for shape in SHAPES:
        cell = build_cell(arch, shape, mesh22, smoke=True)
        set_mesh(None)
        kind = SHAPE_SPECS[shape]["kind"]
        assert cell.kind == kind and callable(cell.fn)
        n = get_config(arch, smoke=True).active_param_count()
        tokens = 2 * (32 if kind != "decode" else 1)
        assert cell.model_flops == (6.0 if kind == "train" else 2.0) * n * tokens
        params = dict(cell.args[0].named_parameters())
        assert all(list(p.placements) == cell.in_shardings[0][k] for k, p in params.items())
        assert shard_bytes(cell.args) == _ref_arg_bytes(arch, shape, am), shape


@pytest.mark.parametrize("arch", ["glm4-9b", "zamba2-1.2b"])
def test_train_flops_match_reference_hlo(arch):
    """FLOPs of one SMOKE train step on a (1, 1) mesh: the port's counted
    ops against the reference's ``analyze_hlo`` of its compiled step."""
    from repro.core.hlo_analysis import analyze_hlo
    from repro.distrib.context import set_mesh as ref_set_mesh
    from repro.launch.specs import build_cell as ref_build_cell

    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rcell = ref_build_cell(arch, "train_4k", mesh, smoke=True)
    with mesh:
        compiled = jax.jit(rcell.fn, in_shardings=rcell.in_shardings,
                           out_shardings=rcell.out_shardings).lower(*rcell.args).compile()
    ref_set_mesh(None)
    want = analyze_hlo(compiled.as_text()).flops
    with fake_group(1):
        cell = build_cell(arch, "train_4k", make_device_mesh((1, 1), ("data", "model"), "cpu"), smoke=True)
        try:
            with cell.fake_mode, auto_region():
                _, cost = analyze_step(cell.fn, *cell.args)
        finally:
            set_mesh(None)
    assert cell.model_flops == rcell.model_flops
    assert abs(cost.flops - want) <= FLOP_TOL * want, (cost.flops, want)


@pytest.mark.parametrize("terms", [(197e12 * 256, 819e9 * 128, 50e9 * 64, 256, 197e12 * 128),
                                   (3.1e17, 2.2e16, 4.0e13, 256, 5.9e16),
                                   (9.4e15, 1.2e13, 4.0e11, 512, 2.1e13),
                                   (0.0, 0.0, 0.0, 1, 0.0)])
def test_roofline_matches_reference(terms):
    flops, nbytes, coll, chips, model = terms
    hw = troof.HW()
    got = troof.Roofline(flops, nbytes, coll, chips, model, hw)
    want = rroof.Roofline(flops, nbytes, coll, chips, model, rroof.HW(hw.peak_flops, hw.hbm_bw, hw.link_bw))
    assert got.as_dict() == want.as_dict()
    assert got.step_time_s == want.step_time_s
    # the port's hardware is one H100 SXM's data sheet, no TPU number
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)

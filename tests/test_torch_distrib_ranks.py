"""The port's mesh paths at 4 ranks against the reference on the same mesh
shapes: ``moe_fwd``'s EP and TP paths, the sequence-sharded decode
attention reached through ``gqa_fwd``, and ``_constrain_heads``.

The port runs in 4 processes joined by a gloo group (``file://``
rendezvous, ``run_ranks``), the model placed by ``distrib.sharding``'s
specs as DTensors.  The reference runs in one subprocess with 4 host
devices (``--xla_force_host_platform_device_count=4``, ``run_ref``), its
mesh made with Auto axes (``jax.make_mesh(..., axis_types=Auto)``): jax 0.9
makes Explicit axes by default, on which the reference's own
``tests/test_distrib.py`` smoke cells fail (ROADMAP F2); the program is
unchanged.  Both start from the same parameters, the reference's
``init_params`` carried as numpy, and the same numpy tokens; float32, and
capacity factor 16 (no token dropped, so a rounding cannot move a token
between buckets).

* DeepSeek-V2 SMOKE (EP over ``moe_ep_axes``) at (2, 2) and (1, 4), and
  forced onto the TP path (3 experts, top 2, at (2, 2); and with
  ``serve_ff_2d``): logits within 1e-4 of max |logit|.
* GLM-4-9B SMOKE at (1, 4), kv heads the TP degree does not divide: a
  prefill into the cache, then decode steps through
  ``_decode_attn_seq_sharded`` (counted), logits within 1e-5.
* ``_constrain_heads`` moves a DTensor to heads on 'model' and leaves its
  values equal.

Every spawn has a timeout, so a hung rendezvous fails the test.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL, DECODE_TOL = 1e-4, 1e-5

RANK_PROG = r"""
import importlib, os, sys
sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.path.join(os.getcwd(), "tests")]
module, fn, rank, world, work = sys.argv[1:6]
import logging
logging.disable(logging.WARNING)
import torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + os.path.join(work, "rdzv"), rank=int(rank),
                        world_size=int(world))
try:
    getattr(importlib.import_module(module), fn)(int(rank), int(world), work)
finally:
    dist.destroy_process_group()
"""

X64_SHIM = r"""
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
"""


def _env(devices: int = 0) -> dict:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


def wait_all(procs, what: str, timeout: float):
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{what}: no result in {timeout} s (a hung rendezvous?)")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{what} failed:\n{out[-3000:]}"


def start_ranks(module: str, fn: str, world: int, work: Path):
    """``world`` processes, each ``module.fn(rank, world, work)`` inside a
    gloo group."""
    return [subprocess.Popen([sys.executable, "-c", RANK_PROG, module, fn, str(r), str(world), str(work)],
                             cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def start_ref(prog: str, work: Path, devices: int):
    """The reference's program ``prog`` (argv[1] = ``work``) on ``devices``
    host devices."""
    return [subprocess.Popen([sys.executable, "-c", X64_SHIM + prog, str(work)], cwd=ROOT, env=_env(devices),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]


def run_both(ref_prog: str, devices: int, module: str, fn: str, world: int, work: Path, timeout: float = 240):
    """The reference's subprocess and the port's ranks, side by side."""
    ref, ranks = start_ref(ref_prog, work, devices), start_ranks(module, fn, world, work)
    wait_all(ref, "reference", timeout)
    wait_all(ranks, "port ranks", timeout)


def save_tree(path: Path, tree: dict):
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(tree, ())
    np.savez(path, **flat)


def load_tree(path) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *head, leaf = key.split("/")
            node = tree
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = z[key]
    return tree


# ---------------------------------------------------------------- the cases

CASES = {
    # name: (arch, mesh shape, moe overrides)
    "ep_2x2": ("deepseek-v2-236b", (2, 2), {}),
    "ep_1x4": ("deepseek-v2-236b", (1, 4), {}),
    "tp_2x2": ("deepseek-v2-236b", (2, 2), {"n_experts": 3, "top_k": 2}),
    "tp2d_2x2": ("deepseek-v2-236b", (2, 2), {"n_experts": 3, "top_k": 2, "serve_ff_2d": True}),
}
DECODE = ("glm4-9b", (1, 4), 8, 4)  # arch, mesh, prompt, decode steps (a cache of 12 splits 4 ways)
BATCH, SEQ = 4, 16


def configs(get_config, arch, moe):
    import dataclasses

    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    if cfg.moe.n_experts:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0, **moe))
    return cfg


REF_PROG = r"""
import sys, dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, "tests")
from test_torch_distrib_ranks import CASES, DECODE, configs, load_tree
from repro.configs import get_config
from repro.distrib.context import set_mesh, use_mesh
from repro.models import lm
work = sys.argv[1]
toks = np.load(work + "/tokens.npy")
out = {}
for name, (arch, shape, moe) in list(CASES.items()) + [("decode", (DECODE[0], DECODE[1], {}))]:
    cfg = configs(get_config, arch, moe)
    params = jax.tree.map(jnp.asarray, load_tree(f"{work}/params_{name}.npz"))
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    with use_mesh(mesh), mesh:
        if name != "decode":
            out[name] = np.asarray(jax.jit(lambda p, t: lm.forward(p, cfg, t)[0])(params, toks))
            continue
        _, _, prompt, steps = DECODE
        cache = lm.init_cache(cfg, toks.shape[0], prompt + steps, jnp.float32)
        fwd = jax.jit(lambda p, t, c: lm.forward(p, cfg, t, cache=c))
        logits, cache = fwd(params, toks[:, :prompt], cache)
        out["decode_0"] = np.asarray(logits)
        for i in range(steps):
            logits, cache = fwd(params, toks[:, prompt + i : prompt + i + 1], cache)
            out[f"decode_{i + 1}"] = np.asarray(logits)
    set_mesh(None)
np.savez(work + "/ref.npz", **out)
"""


def forward_ranks(rank, world, work):
    """Each case on its mesh; rank 0 saves the logits and the paths taken."""
    from test_torch_distrib_ranks import CASES, DECODE, configs, load_tree

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distrib import compat
    from repro_torch.distrib.context import use_mesh
    from repro_torch.distrib.sharding import cache_specs, data_specs, distribute, param_specs
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import layers, lm

    toks = torch.from_numpy(np.load(f"{work}/tokens.npy"))
    calls = {"ep": 0, "tp": 0, "seq": 0}
    orig_a2a, orig_seq = compat.all_to_all, layers._decode_attn_seq_sharded

    def a2a(*a, **k):
        calls["ep"] += 1
        return orig_a2a(*a, **k)

    def seq(*a, **k):
        calls["seq"] += 1
        return orig_seq(*a, **k)

    compat.all_to_all, layers._decode_attn_seq_sharded = a2a, seq
    out = {}
    for name, (arch, shape, moe) in list(CASES.items()) + [("decode", (DECODE[0], DECODE[1], {}))]:
        cfg = configs(get_config, arch, moe)
        params = lm_params_from_numpy(load_tree(f"{work}/params_{name}.npz"), cfg, "cpu")
        mesh = make_device_mesh(shape, ("data", "model"), "cpu")
        distribute(params, param_specs(cfg, params, mesh), mesh)

        def placed(t):
            return distribute(t, data_specs(mesh, t.shape[0]), mesh)

        with use_mesh(mesh), compat.auto_region():
            if name != "decode":
                out[name] = lm.forward(params, cfg, placed(toks))[0].full_tensor().numpy()
                continue
            _, _, prompt, steps = DECODE
            cache = lm.init_cache(cfg, toks.shape[0], prompt + steps, torch.float32, "cpu")
            cache = distribute(cache, cache_specs(cfg, cache, mesh), mesh)
            out["decode_0"] = lm.forward(params, cfg, placed(toks[:, :prompt]), cache=cache)[0].full_tensor().numpy()
            for i in range(steps):
                logits, cache = lm.forward(params, cfg, placed(toks[:, prompt + i : prompt + i + 1]), cache=cache)
                out[f"decode_{i + 1}"] = logits.full_tensor().numpy()
            out["cache_k_placements"] = np.array([str(p) for p in cache["layers"]["k"].placements])
    # _constrain_heads: heads onto 'model', values unchanged
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = make_device_mesh((2, 2), ("data", "model"), "cpu")
    t = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 6, 8, 16)).astype(np.float32))
    dt = distribute_tensor(t, mesh, [Shard(0), Replicate()])
    with use_mesh(mesh):
        c = layers._constrain_heads(dt)
    out["constrain_placements"] = np.array([str(p) for p in c.placements])
    out["constrain_equal"] = np.array(bool(torch.equal(c.full_tensor(), t)))
    out["calls"] = np.array([calls["ep"], calls["seq"]])
    compat.all_to_all, layers._decode_attn_seq_sharded = orig_a2a, orig_seq
    if rank == 0:
        np.savez(f"{work}/port.npz", **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import lm as rlm

    work = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(0)
    vocab = min(ref_config(a, smoke=True).vocab for a in ("deepseek-v2-236b", "glm4-9b"))
    np.save(work / "tokens.npy", rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32))
    for name, (arch, _, moe) in list(CASES.items()) + [("decode", (DECODE[0], DECODE[1], {}))]:
        cfg = configs(ref_config, arch, moe)
        save_tree(work / f"params_{name}.npz", jax.tree.map(np.asarray, rlm.init_params(cfg, jax.random.PRNGKey(0))))
    run_both(REF_PROG, 4, "test_torch_distrib_ranks", "forward_ranks", 4, work)
    with np.load(work / "ref.npz") as r, np.load(work / "port.npz") as p:
        return dict(r), dict(p)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_mesh_paths_match_reference(results, case):
    ref, port = results
    assert port[case].shape == ref[case].shape
    assert _rel(port[case], ref[case]) <= FWD_TOL
    assert port["calls"][0] > 0  # the EP path's all_to_all ran


def test_seq_sharded_decode_matches_reference(results):
    ref, port = results
    _, _, _, steps = DECODE
    for i in range(steps + 1):
        key = f"decode_{i}"
        assert _rel(port[key], ref[key]) <= DECODE_TOL, key
    # the cache's sequence dim is sharded over 'model', and every decode step
    # of every layer took the sequence-sharded attention
    assert list(port["cache_k_placements"]) == ["S(1)", "S(2)"]
    from repro_torch.configs import get_config

    assert port["calls"][1] == steps * get_config(DECODE[0], smoke=True).n_layers


def test_constrain_heads_keeps_values(results):
    _, port = results
    assert bool(port["constrain_equal"])
    assert list(port["constrain_placements"]) == ["S(0)", "S(2)"]

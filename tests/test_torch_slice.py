"""The port's slice end to end on the host, and the package's boundaries.

* VGG11 (whose full spec is small) from shared inputs, through
  ``profile_network`` -> ``run_policy`` for the five Fig 8 policies,
  against the reference.  The capture runs float32 matmuls in another order
  than XLA's, so throughput and utilization are held to the reference's
  cycle-statistics tolerance (rtol 2e-2, atol 1e-2); the MAC-proportional
  policies do not read the profile and use exactly the same arrays.
* ``repro_torch`` imports and runs with jax unimportable (the MoE family's
  serving and its routing capture and plan included), and its sources
  import neither jax nor ``repro``.
* The multi-chip half (topology, the placed allocators, the multi-chip
  sweeps, fleet replay, the fault sweep, observability) runs end to end on
  the host with jax unimportable.
* Entry points called without ``device=`` (the slice-1 ones, the fused
  sweep's, the multi-chip and fault sweeps, and the serving slices'
  ``launch.serve.main``, ``models.lm.init_params`` and
  ``models.lm.init_cache``, the MoE family's too) ask for the card, and raise where there is none.
"""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.core.cim as R
from repro.core.cim import profile as RP
import repro_torch as T
from repro_torch import convert
from repro_torch.core.alloc.greedy import greedy_allocate_batch
from repro_torch.configs import get_config
from repro_torch.core.cim.profile import synthetic_images
from repro_torch.dse import (
    FusedPipeline,
    chip_grid,
    design_grid,
    fault_grid,
    get_captured,
    get_fused_pipeline,
    run_fault_sweep,
    run_fused_multichip_sweep,
    run_fused_sweep,
    run_multichip_sweep,
    run_sweep,
)
from repro_torch.launch import serve
from repro_torch.models import lm

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _x64_shim():
    """The reference imports ``jax.experimental.enable_x64``, which jax 0.9
    removed; provide it for this module only."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(
                jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False
            )
        yield


@pytest.fixture(scope="module")
def vgg_profiles():
    rspec, tspec = R.vgg11_cifar10(), T.vgg11_cifar10()
    rprof = R.profile_network(rspec, n_images=2)
    kimg, kw = jax.random.split(jax.random.PRNGKey(0))
    keys = jax.random.split(kw, len(rspec.layers))
    weights = [np.asarray(RP._kaiming(keys[i], l.rows, l.cout)) for i, l in enumerate(rspec.layers)]
    images = np.asarray(RP.synthetic_images(2, 32, kimg))
    x, ws = convert.capture_inputs_from_numpy(images, weights, tspec, device="cpu")
    tprof = T.profile_network(tspec, n_images=2, images=x, weights=ws, device="cpu")
    return rspec, rprof, tspec, tprof


@pytest.mark.parametrize("policy", list(R.POLICIES))
def test_vgg11_slice_matches_reference(vgg_profiles, policy):
    rspec, rprof, tspec, tprof = vgg_profiles
    for mult in (1, 2, 4):
        pes = rspec.min_pes() * mult
        r = R.run_policy(rspec, rprof, policy, pes)
        t = T.run_policy(tspec, tprof, policy, pes)
        assert np.isfinite(t.images_per_sec) and t.layer_utilization.shape == (len(tspec.layers),)
        np.testing.assert_allclose(t.images_per_sec, r.images_per_sec, rtol=2e-2)
        np.testing.assert_allclose(t.mean_utilization, r.mean_utilization, atol=1e-2)
        if policy in ("baseline", "weight_based", "weight_blockflow"):
            assert t.arrays_used == r.arrays_used


def test_blockwise_beats_layerwise_beats_weight_based(vgg_profiles):
    """The paper's Fig 8 ordering holds on the port's own numbers."""
    _, _, tspec, tprof = vgg_profiles
    pes = tspec.min_pes() * 2
    ips = {p: T.run_policy(tspec, tprof, p, pes).images_per_sec for p in T.POLICIES}
    assert ips["blockwise"] >= ips["perf_layerwise"] >= ips["weight_based"] > ips["baseline"]


def test_runs_with_jax_unimportable():
    code = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import repro_torch as T
spec = T.vgg11_cifar10()
cap = T.capture_activations(spec, n_images=1, sample_patches=16, device="cpu")
prof = T.derive_profile(cap, spec)
res = T.simulate(spec, prof, T.allocate(spec, prof, "blockwise", spec.min_pes() * 2))
assert res.images_per_sec > 0, res
from repro_torch.dse import design_grid, run_fused_sweep
pts = design_grid(networks=("vgg11",), policies=("weight_based", "blockwise"), pe_multipliers=(2.0,))
sweep = run_fused_sweep(pts, sample_patches=16, engine="kernel", device="cpu")
assert (sweep.images_per_sec > 0).all(), sweep
from repro_torch.launch import serve
serve.main(["--arch", "zamba2-1.2b", "--smoke", "--batch", "1", "--prompt-len", "20", "--gen", "2", "--device", "cpu"])
for arch in ("deepseek-v2-236b", "grok-1-314b"):
    serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12", "--gen", "3", "--device", "cpu"])
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.core.alloc import plan_replication
from repro_torch.models import layers, lm
cfg = get_config("deepseek-v2-236b", smoke=True)
with layers.capture_routing() as rec:
    lm.forward(lm.init_params(cfg, device="cpu"), cfg, torch.zeros((1, 9), dtype=torch.long))
hist = np.bincount(np.concatenate([r.reshape(-1) for r in rec]), minlength=cfg.moe.n_experts)
assert len(rec) == cfg.n_layers and plan_replication(hist / hist.sum(), 12).n_physical == 12
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "ok", out.stderr[-3000:]


def test_multichip_half_runs_with_jax_unimportable():
    code = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import repro_torch as T
from repro_torch.core.cim import FabricTopology, allocate_placed
from repro_torch.dse import chip_grid, fault_grid, run_fault_sweep, run_fused_multichip_sweep, run_multichip_sweep
from repro_torch.fabric import (
    CoarsenConfig, FabricSim, PoissonOpen, VirtualTimeFabric, arrival_times, run_stream, run_trace_segments,
    segment_growth_plan,
)
from repro_torch.obs import AllocationAudit, build_trace, utilization_report, validate_trace
spec = T.vgg11_cifar10()
prof = T.derive_profile(T.capture_activations(spec, n_images=1, sample_patches=16, device="cpu"), spec)
pes = spec.min_pes() * 2
audit = AllocationAudit()
pa = allocate_placed(spec, prof, "blockwise", FabricTopology.split(2, pes, link_gbps=16.0), audit=audit)
assert pa.placement.max_stage_transfer > 0 and len(audit) > 0
kw = dict(n_requests=6, closed_requests=4, concurrency=2, sample_patches=16, device="cpu")
pts = chip_grid(networks=("vgg11",), chips=(1, 2), link_gbps=(16.0,))
mc = run_multichip_sweep(pts, **kw)
fu = run_fused_multichip_sweep(pts, load_fracs=(0.5, 0.7), **kw)
assert np.allclose(fu.pcts[:, 1, 2], mc.p99_cycles, rtol=1e-12, atol=0)
vt = VirtualTimeFabric(spec, prof, device="cpu")
bw = T.allocate(spec, prof, "blockwise", pes)
proc = PoissonOpen(6, 1e-5, seed=1)
st = run_stream(vt, [bw], proc, seed=2, materialize=True, coarsen=CoarsenConfig(tail_lanes=2))
times = arrival_times(proc)
plan = segment_growth_plan(spec, prof, bw, budgets=[32])
seg = run_trace_segments(vt, [[bw, p] for p in plan], times, [float(times[3])], seed=2)
assert st.sketches[0].n == 6 and seg.sketches[1].n == 6
fs = run_fault_sweep(fault_grid(networks=("vgg11",), spare_fractions=(0.0,), rates=(1e-8,)), n_requests=6,
                     sample_patches=16, device="cpu")
assert 0.0 <= fs.availability[0] <= 1.0
sim = FabricSim(spec, prof, pa.allocation, seed=3, record_timeline=True, stats=True, placement=pa.placement)
res = sim.run(PoissonOpen(3, 1e-5, seed=5))
assert validate_trace(build_trace(sim, res, placement=pa.placement)) > 0
assert utilization_report(res).mean_duty_cycle > 0
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "ok", out.stderr[-3000:]


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__",
        ):
            mods.update(a.value for a in node.args if isinstance(a, ast.Constant))
    return mods


def test_port_sources_import_neither_jax_nor_reference():
    scripts = [ROOT / "chip_smoke.py", ROOT / "chip_decode_rope.py"]
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + scripts
    names = {str(f.relative_to(ROOT / "src")) for f in files[:-len(scripts)]}
    for module in (
        "repro_torch/dse/fused.py",
        "repro_torch/dse/sweep.py",
        "repro_torch/dse/pareto.py",
        "repro_torch/dse/faults.py",
        "repro_torch/core/cim/topology.py",
        "repro_torch/core/alloc/pipeline_stages.py",
        "repro_torch/core/alloc/expert.py",
        "repro_torch/distrib/sharding.py",
        "repro_torch/fabric/fleet.py",
        "repro_torch/obs/audit.py",
        "repro_torch/obs/report.py",
        "repro_torch/obs/trace.py",
        "repro_torch/fabric/telemetry.py",
        "repro_torch/kernels/fused_alloc_eval.py",
        "repro_torch/kernels/flash_attention.py",
        "repro_torch/kernels/ssd_scan.py",
        "repro_torch/kernels/ops.py",
        "repro_torch/models/config.py",
        "repro_torch/models/layers.py",
        "repro_torch/models/ssm.py",
        "repro_torch/models/lm.py",
        "repro_torch/configs/__init__.py",
        "repro_torch/configs/zamba2_1_2b.py",
        "repro_torch/configs/deepseek_v2_236b.py",
        "repro_torch/configs/grok_1_314b.py",
        "repro_torch/train/step.py",
        "repro_torch/launch/serve.py",
    ):
        assert module in names, module
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


ENTRY_POINTS = [
    "capture_activations",
    "profile_network",
    "synthetic_images",
    "greedy_allocate_batch",
    "capture_inputs_from_numpy",
    "capture_from_numpy",
    "FusedPipeline",
    "get_fused_pipeline",
    "run_fused_sweep",
    "run_sweep",
    "run_multichip_sweep",
    "run_fused_multichip_sweep",
    "run_fault_sweep",
    "get_captured",
    "serve_main",
    "init_params",
    "init_cache",
    "serve_main_deepseek_v2",
    "init_params_grok_1",
    "init_cache_deepseek_v2",
]


def _call(name):
    spec = T.vgg11_cifar10()
    if name == "capture_activations":
        return T.capture_activations(spec, n_images=1)
    if name == "profile_network":
        return T.profile_network(spec, n_images=1)
    if name == "synthetic_images":
        return synthetic_images(1, 8, torch.Generator())
    if name == "greedy_allocate_batch":
        return greedy_allocate_batch([1.0], [1.0], [2.0])
    if name == "FusedPipeline":
        return FusedPipeline("vgg11", T.DEFAULT_ARRAY, (3,))
    if name == "get_fused_pipeline":
        return get_fused_pipeline("vgg11", T.DEFAULT_ARRAY, (3,))
    if name == "run_fused_sweep":
        return run_fused_sweep(design_grid(networks=("vgg11",), pe_multipliers=(2.0,)))
    if name == "run_sweep":
        return run_sweep(design_grid(networks=("vgg11",), pe_multipliers=(2.0,)))
    if name == "run_multichip_sweep":
        return run_multichip_sweep(chip_grid(networks=("vgg11",), chips=(1,), link_gbps=(16.0,)))
    if name == "run_fused_multichip_sweep":
        return run_fused_multichip_sweep(chip_grid(networks=("vgg11",), chips=(1,), link_gbps=(16.0,)))
    if name == "run_fault_sweep":
        return run_fault_sweep(fault_grid(networks=("vgg11",), spare_fractions=(0.0,), rates=(1e-9,)))
    if name == "get_captured":
        return get_captured("vgg11")
    if name == "serve_main":
        return serve.main(["--arch", "zamba2-1.2b", "--smoke", "--batch", "1", "--prompt-len", "4", "--gen", "2"])
    if name == "init_params":
        return lm.init_params(get_config("mamba2-370m", smoke=True))
    if name == "init_cache":
        return lm.init_cache(get_config("zamba2-1.2b", smoke=True), 1, 8)
    if name == "serve_main_deepseek_v2":
        return serve.main(["--arch", "deepseek-v2-236b", "--smoke", "--batch", "1", "--prompt-len", "4", "--gen", "2"])
    if name == "init_params_grok_1":
        return lm.init_params(get_config("grok-1-314b", smoke=True))
    if name == "init_cache_deepseek_v2":
        return lm.init_cache(get_config("deepseek-v2-236b", smoke=True), 1, 8)
    if name == "capture_inputs_from_numpy":
        weights = [np.zeros((l.rows, l.cout), np.float32) for l in spec.layers]
        return convert.capture_inputs_from_numpy(np.zeros((1, 32, 32, 3)), weights, spec)

    class Cap:  # the fields capture_from_numpy reads
        network, n_images, sample_patches, seed, layers = "vgg11", 1, 1, 0, ()

    return convert.capture_from_numpy(Cap())


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _call(name)

"""Nothing a cell runs loads JAX or the JAX package, compared by whole
top-level name; the reference loads nothing of the port; and without a
card a run fails and prints no result."""

import json
import os
import subprocess
import sys

from cimbench import harness
from cimbench.tests.tiny import ROOT

PROG = r"""
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from pathlib import Path
from cimbench import harness, drivers, trace, yardstick, inputs
root = Path({root!r})
bench = json.loads((root / "BENCHMARK.json").read_text())
for w in bench["workloads"]:
    cell = harness.find_cell(root, w["name"])
    harness.load_entry(root, cell.mix["entry"])
    for m in cell.metrics("per_layer"):
        harness.load_metric(root, m["name"])
import repro_torch, repro_torch.dse, repro_torch.fabric, repro_torch.kernels.vtime_scan
import repro_torch.kernels.fused_alloc_eval, repro_torch.kernels.bitplane_profile
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = r"""
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import cimbench.reference.capture, cimbench.reference.cim, cimbench.reference.fabric
from cimbench import harness
from pathlib import Path
for name in ("resnet18", "vgg11"):
    harness._load_py(Path({root!r}) / "cimbench" / "configs" / f"{{name}}.py", "r_" + name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_modules(prog):
    out = subprocess.run([sys.executable, "-c", prog.format(src=str(ROOT / "src"), root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_whole_names():
    assert harness.banned_modules(["repro_torch", "repro_torch.dse", "numpy"]) == []
    assert harness.banned_modules(["repro.fabric", "jaxlib.xla", "reproduce"]) == ["jaxlib", "repro"]


def test_cells_load_no_jax():
    top = _top_modules(PROG)
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_port():
    top = _top_modules(REF)
    assert not top & {"repro_torch", "jax", "jaxlib", "flax", "repro", "torch"}


def test_nothing_reads_the_jax_benchmarks():
    for path in (ROOT / "cimbench").rglob("*.py"):
        text = path.read_text()
        if path.name == "test_cimbench_imports.py":
            continue
        assert "benchmarks/" not in text and "import repro\n" not in text and "from repro " not in text, path


def test_no_card_no_result():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    out = subprocess.run([sys.executable, str(ROOT / "cimbench" / "run.py"), "--workload", cell, "--seed",
                          str(2**33 + 5), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT), env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "cimbench", tmp_path / "cimbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "cimbench/run.py", "--workload", cell, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""

"""One short run of every cell on the card (``python -m pytest -q -m cuda
cimbench/tests``): the harness's own command, traced and not."""

import json
import subprocess
import sys

import pytest

from cimbench.tests.tiny import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "cimbench/run.py", "--workload", cell, "--seed", str(2**31 + 99),
                          "--seconds", "2", "--trace", str(trace)], capture_output=True, text=True, timeout=360,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["attempted"] >= 1
    assert list(res)[-1] == "check"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"]
    else:
        assert "setup_s" in res["metrics"]

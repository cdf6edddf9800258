"""The harness finds a cell's configuration, mix and metrics by name, and a
new one is new files and entries."""

import json
import shutil
import time

import pytest

from cimbench import harness
from cimbench.tests.tiny import ROOT
from cimbench.trace import Trace


def test_every_cell_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.find_cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(cell.forward)
        entry = harness.load_entry(ROOT, cell.mix["entry"])
        assert callable(entry.end_to_end) and entry.FAMILY and callable(entry.Driver)
        assert set(cell.mix["limits"]) == {"capture_mismatch", "path_gap"}
        e2e = {m["name"] for m in cell.metrics("end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in cell.metrics("per_layer"):
            assert callable(harness.load_metric(ROOT, m["name"]))


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        harness.find_cell(ROOT, "no.such_cell")


TOY_ENTRY = """
FAMILY = "toy"


def end_to_end(records, lat_s, window_s, work):
    return {"toy_items_per_s": sum(work) / window_s}


class Driver:
    def __init__(self, config, forward, mix, seed, device):
        self.mix, self.seed = mix, seed

    def setup(self):
        import repro_torch

        self.spec = getattr(repro_torch, "toy_net")()

    def call(self, i):
        return {"items": int(self.mix["items"]), "layers": len(self.spec.layers)}

    def work(self, rec):
        return rec["items"]

    def info(self):
        return {}

    def snapshot(self):
        pass

    def free(self):
        self.__dict__.pop("spec", None)

    def check(self, records, control=False):
        return {"layers_gap": float(any(r["layers"] != 8 for r in records)) + float(control)}
"""

TOY_METRIC = """
def read(trace, family):
    if trace.family != family:
        return None
    return float(len(trace.calls))
"""


def _tree(tmp_path):
    shutil.copytree(ROOT / "cimbench", tmp_path / "cimbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_are_new_files(tmp_path):
    """A later change adds a config, a mix and a metric as files, and the
    cell, its mix and its metric entry to BENCHMARK.json: nothing else."""
    before = _tree(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "cimbench" / "configs" / "vgg11.json").read_text())
    cfg["name"], cfg["reference"] = "vgg11_b", "cimbench/configs/vgg11_b.py"
    (tmp_path / "cimbench" / "configs" / "vgg11_b.json").write_text(json.dumps(cfg))
    shutil.copy(ROOT / "cimbench" / "configs" / "vgg11.py", tmp_path / "cimbench" / "configs" / "vgg11_b.py")
    mix = json.loads((ROOT / "cimbench" / "traffic" / "tail_query.json").read_text())
    mix["arrivals"]["loads"] = [0.95]
    (tmp_path / "cimbench" / "traffic" / "hot_query.json").write_text(json.dumps(mix))
    (tmp_path / "cimbench" / "metrics" / "calls.py").write_text(TOY_METRIC)
    bench["configs"].append({"name": "vgg11_b", "source": "https://arxiv.org/abs/1409.1556",
                             "file": "cimbench/configs/vgg11_b.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "vgg11_b.hot_query", "config": "vgg11_b", "traffic": "hot_query", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "calls.query", "unit": "calls", "better": "higher", "source": "program_span",
                               "layer": "device", "moves": "query_ms", "workloads": ["vgg11_b.hot_query"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("query"):
            m["workloads"].append("vgg11_b.hot_query")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items() if p.name != "BENCHMARK.json")
    cell = harness.find_cell(tmp_path, "vgg11_b.hot_query")
    assert cell.mix["arrivals"]["loads"] == [0.95]
    assert [m["name"] for m in cell.metrics("per_layer")][-1] == "calls.query"
    tr = Trace("query", [(0.0, 1.0), (2.0, 3.0), (4.0, 5.0)], [("k", 0.0, 1.0)])
    assert harness.load_metric(tmp_path, "calls.query")(tr) == 3
    assert harness.load_metric(tmp_path, "calls.sweep")(tr) is None
    assert {m["name"] for m in cell.metrics("end_to_end")} == {"query_ms", "query_p95_ms", "setup_s"}


def test_new_entry_family_and_network_are_new_files(tmp_path, monkeypatch):
    """A later change adds an entry of the program (its driver, a family
    of its own and that family's end-to-end metric), a network the port
    builds by a new name, a mix and a per-layer metric, as new files and
    entries, and a run of the new cell reports them."""
    import repro_torch

    before = _tree(tmp_path)
    monkeypatch.setattr(repro_torch, "toy_net", repro_torch.vgg11_cifar10, raising=False)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "cimbench" / "configs" / "vgg11.json").read_text())
    cfg.update(name="toy", spec="toy_net")
    (tmp_path / "cimbench" / "configs" / "toy.json").write_text(json.dumps(cfg))
    (tmp_path / "cimbench" / "entries" / "toy_count.py").write_text(TOY_ENTRY)
    (tmp_path / "cimbench" / "traffic" / "toy.json").write_text(json.dumps(
        {"entry": "toy_count", "items": 5, "limits": {"layers_gap": 0.0}}))
    (tmp_path / "cimbench" / "metrics" / "toy_calls.py").write_text(TOY_METRIC)
    bench["configs"].append({"name": "toy", "source": "https://arxiv.org/abs/1409.1556",
                             "file": "cimbench/configs/toy.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.count", "config": "toy", "traffic": "toy", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "toy_items_per_s", "unit": "items/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["toy.count"]})
    bench["per_layer"].append({"name": "toy_calls.toy", "unit": "calls", "better": "higher",
                               "source": "program_span", "layer": "toy", "moves": "toy_items_per_s",
                               "workloads": ["toy.count"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items() if p.name != "BENCHMARK.json")

    cell = harness.find_cell(tmp_path, "toy.count")
    res, lines = harness.execute(cell, 2**32 + 3, 0.05, False, False, "cpu", time.perf_counter())
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"toy_items_per_s", "setup_s"}
    assert res["metrics"]["toy_items_per_s"]["value"] > 0
    assert res["check"] == {"layers_gap": {"value": 0.0, "limit": 0.0}}
    res, _ = harness.execute(cell, 2**32 + 3, 0.05, False, True, "cpu", time.perf_counter())
    assert not res["correct"]
    tr = Trace("toy", [(0.0, 1.0), (2.0, 3.0)], [("k", 0.0, 1.0)])
    assert harness.load_metric(tmp_path, "toy_calls.toy")(tr) == 2

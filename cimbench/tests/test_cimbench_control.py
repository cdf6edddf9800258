"""The check fails what it must, at a size a test run can hold: the
control (the reference one precision lower in the program's place) and the
timed path broken underneath a run whose look for a chip is skipped.

Faults a cell can have: a step that returns its state unchanged (VT hands
back the arrivals as completions), half of the batch left out (the
percentiles taken over the first half of the requests), an answer altered
where it is produced (one completion a cycle late).  No cell spans chips,
so an exchange between chips has nothing to leave out."""

import time

import numpy as np
import pytest

from cimbench import harness
from cimbench.inputs import derive_seed
from cimbench.tests.tiny import ROOT, tiny_cell

SEED = 2**32 + 77


def run(cell, control=False, driver_cls=None):
    res, lines = harness.execute(cell, SEED, 0.2, False, control, "cpu", time.perf_counter(), driver_cls=driver_cls)
    return res


@pytest.mark.parametrize("name", ["vgg11.tail_query", "resnet18.dse_tail", "resnet18.closed_query"])
def test_sound_run_is_correct(name):
    assert run(tiny_cell(name))["correct"]


@pytest.mark.parametrize("name", ["vgg11.tail_query", "resnet18.dse_tail", "resnet18.closed_query"])
def test_control_is_not_correct(name):
    res = run(tiny_cell(name), control=True)
    assert not res["correct"]
    assert res["check"]["capture_mismatch"]["value"] > res["check"]["capture_mismatch"]["limit"]


def _vt_unchanged(real):
    def vt(*args, **kw):
        t_arr, comp, busy, wait = real(*args, **kw)
        return t_arr, t_arr.clone(), busy, wait
    return vt


def _vt_altered(real):
    """Each config's slowest request one cycle late."""
    def vt(*args, **kw):
        t_arr, comp, busy, wait = real(*args, **kw)
        comp = comp.clone()
        slow = (comp - t_arr).argmax(dim=1)
        comp[range(comp.shape[0]), slow] += 1.0
        return t_arr, comp, busy, wait
    return vt


@pytest.mark.parametrize("fault", [_vt_unchanged, _vt_altered])
@pytest.mark.parametrize("name,module", [("vgg11.tail_query", "repro_torch.fabric.vtime"),
                                         ("resnet18.closed_query", "repro_torch.fabric.vtime"),
                                         ("resnet18.dse_tail", "repro_torch.dse.fused")])
def test_broken_vt_is_not_correct(monkeypatch, fault, name, module):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, "vtime_scan", fault(mod.vtime_scan))
    assert not run(tiny_cell(name))["correct"]


class HalfTheRequests(harness.load_entry(ROOT, "run_batch").Driver):
    """The percentiles of each config over the first half of its requests."""

    def call(self, i):
        aseed, sseed = derive_seed(self.seed, "arrivals", i), derive_seed(self.seed, "service", i)
        res = self.vt.run_batch(self.allocs, self._procs(aseed), seed=sseed)
        lat = res.latencies[:, : res.latencies.shape[1] // 2]
        return {"aseed": aseed, "sseed": sseed, "pct": np.percentile(lat, (50.0, 95.0, 99.0), axis=1).T}


@pytest.mark.parametrize("name", ["vgg11.tail_query", "resnet18.closed_query"])
def test_half_the_batch_is_not_correct(name):
    assert not run(tiny_cell(name), driver_cls=HalfTheRequests)["correct"]

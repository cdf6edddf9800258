"""The port's recorder (``repro_torch.fabric.telemetry``) and the spans and
counters of the paths it traces, on the host.

The recorder is off with no session and no profiler; inside a
``torch.profiler`` window it is the process-wide ``PROFILER_TELEMETRY``.
Spans nest by parent and call id, host spans are mirrored to the profiler
and the others are not, and a snapshot survives JSON.  ``run_batch``
(VT's plain version) and the fused sweep's stages record their span trees
once a call, with counts that equal what their inputs need, and return
the same results with recording on and off.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch as T
from repro_torch.core.cim.cost import DEFAULT_ARRAY
from repro_torch.core.cim.network import LayerSpec, NetworkSpec
from repro_torch.core.cim.profile import LayerProfile, NetworkProfile
from repro_torch.dse import FabricEval, design_grid
from repro_torch.dse import fused as TFU
from repro_torch.dse import sweep as TS
from repro_torch.fabric import ClosedLoop, PoissonOpen, VirtualTimeFabric
from repro_torch.fabric import telemetry as TM

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from cimbench import yardstick  # noqa: E402


@pytest.fixture(autouse=True)
def clean_recorder():
    TM.PROFILER_TELEMETRY.reset()
    yield
    TM.PROFILER_TELEMETRY.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def tree(snap):
    """{call: [(name, parent name) in order of closing]} of a snapshot."""
    by_id = {s["id"]: s for s in snap["spans"]}
    out = {}
    for s in snap["spans"]:
        parent = None if s["parent"] is None else by_id[s["parent"]]["name"]
        out.setdefault(s["call"], []).append((s["name"], parent))
    return out


def test_off_without_session_or_profiler():
    assert TM.get_telemetry() is TM.NULL_TELEMETRY
    with TM.NULL_TELEMETRY.span("x", host=True, a=1) as attrs:
        assert attrs is None
    with cpu_profile():
        assert TM.get_telemetry() is TM.PROFILER_TELEMETRY
        with TM.telemetry_session() as t:
            assert TM.get_telemetry() is t
        assert TM.get_telemetry() is TM.PROFILER_TELEMETRY
    assert TM.get_telemetry() is TM.NULL_TELEMETRY


def test_parent_and_call_ids_nest():
    t = TM.Telemetry()
    for _ in range(2):
        with t.span("top"):
            with t.span("a", k=1) as attrs:
                attrs["n"] = 3
                with t.span("b"):
                    pass
            with t.span("c"):
                pass
    s = {(x.call, x.name): x for x in t.spans}
    assert [x.name for x in t.spans[:4]] == ["b", "a", "c", "top"]
    for call in (0, 1):
        top = s[call, "top"]
        assert top.parent is None
        assert s[call, "a"].parent == top.id and s[call, "c"].parent == top.id
        assert s[call, "b"].parent == s[call, "a"].id
        assert s[call, "a"].attrs == {"k": 1, "n": 3}
        assert top.start <= s[call, "a"].start <= s[call, "b"].start <= s[call, "b"].end <= s[call, "c"].start
        assert s[call, "c"].end <= top.end
    assert s[0, "top"].id != s[1, "top"].id
    assert abs(s[0, "top"].start - time.time_ns()) < 60e9  # Unix-epoch ns


def test_mirrored_span_is_a_cpu_annotation():
    with cpu_profile() as prof:
        tel = TM.get_telemetry()
        with tel.span("test.host", host=True):
            np.zeros(10).sum()
        with tel.span("test.unmirrored"):
            np.zeros(10).sum()
    ev = {e.name: e for e in prof.events()}
    assert "test.host" in ev and ev["test.host"].device_type == torch.autograd.DeviceType.CPU
    assert "test.unmirrored" not in ev
    assert [s.name for s in TM.PROFILER_TELEMETRY.spans] == ["test.host", "test.unmirrored"]


def test_snapshot_round_trips_through_json():
    with TM.telemetry_session() as t:
        t.count("n", 2)
        t.gauge("g", 1.5)
        t.observe("h", 3.0)
        with t.span("top", configs=4, flag=True):
            with t.span("inner", host=True):
                pass
        snap = t.snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert [s["name"] for s in snap["spans"]] == ["inner", "top"]
    assert snap["spans"][1]["attrs"] == {"configs": 4, "flag": True}


# ------------------------------------------------ the traced paths, on the host
def _tiny():
    """A two-layer network with random integer cycles a (sample, block)."""
    spec = NetworkSpec("tiny", (LayerSpec("c1", 3, 16, 32, 4), LayerSpec("c2", 3, 32, 300, 2)))
    rng = np.random.default_rng(0)
    layers = []
    for l in spec.layers:
        c = rng.integers(20, 400, (16, l.n_blocks))
        layers.append(LayerProfile(l.name, torch.full((l.n_blocks,), 0.3, dtype=torch.float64),
                                   torch.as_tensor(c.mean(axis=0)), torch.as_tensor(c),
                                   torch.as_tensor(c.max(axis=0) + 16), l.patches_per_image))
    return spec, NetworkProfile("tiny", tuple(layers))


RUN_BATCH_TREE = [("vt.arrivals", "vt.run_batch"), ("vt.draw", "vt.run_batch"),
                  ("vt.pack_indices", "vt.upload"), ("vt.upload", "vt.run_batch"), ("vt.configs", "vt.run_batch"),
                  ("vt.prepare", "vt.run_batch"), ("vt.wait", "vt.run_batch"),
                  ("vt.percentiles", "vt.run_batch"), ("vt.run_batch", None)]


@pytest.mark.parametrize("closed", [False, True])
def test_run_batch_spans_and_counts(closed):
    spec, prof = _tiny()
    allocs = [T.allocate(spec, prof, p, spec.min_pes() * 2) for p in ("weight_based", "blockwise", "baseline")]
    vt = VirtualTimeFabric(spec, prof, device="cpu")
    n = 7
    proc = ClosedLoop(n, 3) if closed else [PoissonOpen(n, 1e-3, seed=s) for s in range(len(allocs))]
    off = [vt.run_batch(allocs, proc, seed=s) for s in (3, 4)]
    with cpu_profile():
        on = [vt.run_batch(allocs, proc, seed=s) for s in (3, 4)]
    assert TM.get_telemetry() is TM.NULL_TELEMETRY
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.completions, b.completions)
        np.testing.assert_array_equal(a.arrivals, b.arrivals)
        np.testing.assert_array_equal(a.percentiles, b.percentiles)
    snap = TM.PROFILER_TELEMETRY.snapshot()
    calls = tree(snap)
    assert len(calls) == 2 and all(v == RUN_BATCH_TREE for v in calls.values())
    ppi = [l.patches_per_image for l in spec.layers]
    c = snap["counters"]
    assert c["vt.indices"] == 2 * n * sum(ppi)
    assert c["vt.upload_bytes"] == 2 * 4 * n * sum(ppi)
    assert c["vt.launches"] == 2
    assert c["vt.job_steps"] == 2 * yardstick.config_steps(ppi, n) * len(allocs)


@pytest.fixture(scope="module")
def vgg_pipe():
    TFU.clear_fused_caches()
    pipe = TFU.get_fused_pipeline("vgg11", DEFAULT_ARRAY, (3, 4), sample_patches=16, device="cpu")
    yield pipe
    TFU.clear_fused_caches()
    TS.clear_caches()


def test_fabric_percentiles_spans_and_counts(vgg_pipe):
    pols = ["baseline", "weight_based", "perf_layerwise", "blockwise"]
    a_idx = np.array([0, 1, 1, 0], dtype=np.int32)
    res = vgg_pipe(a_idx, pols, [vgg_pipe.spec.min_pes() * 2] * len(pols))
    times = np.cumsum(np.random.default_rng(1).exponential(3e3, (len(pols), 3)), axis=1)
    args = (a_idx, res["dups_lb"], res["layerwise"], res["zskip"], times)
    off = vgg_pipe.fabric_percentiles(*args, seed=5)
    with cpu_profile():
        on = vgg_pipe.fabric_percentiles(*args, seed=5)
    np.testing.assert_array_equal(off, on)
    snap = TM.PROFILER_TELEMETRY.snapshot()
    assert list(tree(snap).values()) == [[
        ("vt.draw", "dse.fused.fabric"), ("vt.pack_indices", "vt.upload"), ("vt.upload", "dse.fused.fabric"),
        ("vt.prepare", "dse.fused.fabric"), ("vt.wait", "dse.fused.fabric"),
        ("vt.percentiles", "dse.fused.fabric"), ("dse.fused.fabric", None)]]
    ppi = [l.patches_per_image for l in vgg_pipe.spec.layers]
    c = snap["counters"]
    assert c["vt.indices"] == 3 * sum(ppi)
    assert c["vt.job_steps"] == yardstick.config_steps(ppi, 3) * len(pols)


def test_fused_sweep_spans(vgg_pipe):
    """The sweep's own spans around its stages, one call each, with the K2
    engine (its plain version here): two launches, one a policy family."""
    pts = design_grid(networks=("vgg11",), policies=("weight_based", "blockwise"), pe_multipliers=(2.0,),
                      arrays=(DEFAULT_ARRAY.variant(adc_bits=3), DEFAULT_ARRAY.variant(adc_bits=4)))
    kw = dict(sample_patches=16, fabric=FabricEval(load_frac=0.5, n_requests=2, seed=1), engine="kernel",
              device="cpu")
    off = TFU.run_fused_sweep(pts, **kw)
    with cpu_profile():
        on = TFU.run_fused_sweep(pts, **kw)
    for col in ("total_cycles", "images_per_sec", "arrays_used", "p50_cycles", "p99_cycles"):
        np.testing.assert_array_equal(getattr(off, col), getattr(on, col))
    snap = TM.PROFILER_TELEMETRY.snapshot()
    (spans,) = tree(snap).values()
    top = [name for name, parent in spans if parent == "dse.fused.sweep"]
    assert top == ["dse.fused.points", "dse.fused.alloc_eval", "dse.fused.arrivals", "dse.fused.fabric"]
    assert [p for name, p in spans if name in ("k2.launch", "dse.fused.copy_out")] == ["dse.fused.alloc_eval"] * 4
    assert snap["counters"]["k2.launches"] == 2
    assert spans[-1] == ("dse.fused.sweep", None)

"""Each per-layer metric reader on a synthetic trace."""

import pytest

from cimbench import harness
from cimbench.tests.tiny import ROOT
from cimbench.trace import Trace

# two calls of 100 us each, 50 us apart; device work inside them
CALLS = [(0.0, 100.0), (150.0, 250.0)]
DEV = [
    ("void vtime_scan_kernel<16, false>(Args)", 10.0, 60.0),
    ("fused_alloc_eval_kernel(Args)", 55.0, 70.0),  # overlaps VT by 5
    ("Memcpy DtoH (Device -> Pinned)", 90.0, 95.0),
    ("void vtime_scan_kernel<16, false>(Args)", 160.0, 220.0),
    ("Memcpy HtoD (Pinned -> Device)", 300.0, 310.0),  # after the window
]


def trace(family, **info):
    return Trace(family, CALLS, DEV, info)


def read(name, tr):
    return harness.load_metric(ROOT, name)(tr)


def test_busy_idle_and_host_exposed():
    tr = trace("query", vt_bound_ns=20_000.0)
    assert tr.window == (0.0, 250.0)
    assert tr.busy_us() == 60.0 + 5.0 + 60.0
    assert read("device_idle_share.query", tr) == pytest.approx(1 - 125 / 250)
    assert read("host_exposed_ms.query", tr) == pytest.approx(((100 - 65) + (100 - 60)) / 2 * 1e-3)
    assert read("host_exposed_ms.sweep", tr) is None  # another family's reader finds nothing
    gaps = tr.idle_gaps()
    # 95 to 160 (mostly between the calls), then 220 to 250, 70 to 90, 0 to 10 inside them
    assert [g[0].split(":")[0] for g in gaps] == ["between calls"] + ["cimbench.call"] * 3
    assert [g[1] for g in gaps] == pytest.approx([65e-6, 30e-6, 20e-6, 10e-6])
    assert tr.device_ops()[0][0].startswith("void vtime_scan_kernel")


def test_vt_and_k2():
    tr = trace("query", vt_bound_ns=20_000.0)
    assert read("vt_device_ms.query", tr) == pytest.approx(110 / 2 * 1e-3)
    assert read("vt_roofline.query", tr) == pytest.approx(100 * 2 * 20_000 / 110_000)
    sw = trace("sweep", vt_steps=1000, configs=4)
    assert read("k2_device_ms.sweep", sw) == pytest.approx(15 / 2 * 1e-3)
    assert read("vt_device_ms.sweep", sw) == pytest.approx(110 / 2 * 1e-3)
    assert read("vt_steps_per_s.sweep", sw) == pytest.approx(2 * 1000 / 110e-6)
    assert read("vt_roofline.query", sw) is None


def test_no_vt_launch_reads_nothing():
    tr = Trace("query", CALLS, [("Memcpy HtoD", 10.0, 20.0)], {"vt_bound_ns": 1.0})
    assert read("vt_roofline.query", tr) is None
    assert read("vt_device_ms.query", tr) is None

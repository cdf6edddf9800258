"""The readers of the program's spans on a synthetic trace and a synthetic
span list: self time a call, nothing for another family or an empty
recorder, the offset fit, and the device-idle time under no span."""

import pytest

from cimbench import harness, spans
from cimbench.tests.tiny import ROOT
from cimbench.trace import Trace

# two calls of 100 us, 50 us apart; device work inside them
CALLS = [(0.0, 100.0), (150.0, 250.0)]
DEV = [("void vtime_scan_kernel<16, false>(Args)", 10.0, 60.0), ("Memcpy HtoD", 55.0, 70.0),
       ("Memcpy DtoH", 90.0, 95.0), ("void vtime_scan_kernel<16, false>(Args)", 160.0, 220.0)]
BASE_NS = 1_760_000_000_000_000_000  # the spans' clock: Unix-epoch ns
SHIFT_US = 5000.0  # the spans' clock runs this far ahead of the profiler's


def span(sid, name, t0, t1, parent, call):
    """A span at profiler times [t0, t1] us, stamped on the spans' clock."""
    ns = lambda t: BASE_NS + int(round((t + SHIFT_US) * 1e3))  # noqa: E731
    return {"name": name, "start": ns(t0), "end": ns(t1), "id": sid, "parent": parent, "call": call, "attrs": {}}


def query_spans():
    """Two run_batch calls: a draw, an upload with its pack, a prepare, a
    plan with its kernel_plan, a launch, a wait and the percentiles."""
    out, sid = [], 0
    for call, (c0, _) in enumerate(CALLS):
        top = sid
        kids = [("vt.draw", 2, 10), ("vt.upload", 12, 30), ("vt.prepare", 30, 40), ("vt.plan", 40, 48),
                ("vt.launch", 48, 50), ("vt.wait", 50, 70), ("vt.percentiles", 72, 88)]
        for name, a, b in kids:
            sid += 1
            out.append(span(sid, name, c0 + a, c0 + b, top, call))
            if name == "vt.upload":
                sid += 1
                out.append(span(sid, "vt.pack_indices", c0 + 13, c0 + 20, sid - 1, call))
            if name == "vt.plan":
                sid += 1
                out.append(span(sid, "vt.kernel_plan", c0 + 44, c0 + 47, sid - 1, call))
        out.append(span(top, "vt.run_batch", c0 + 1, c0 + 99, None, call))
        sid += 1
    return out


@pytest.fixture
def recorded(monkeypatch):
    box = {"spans": query_spans()}
    monkeypatch.setattr(spans, "recorded", lambda: box["spans"])
    return box


def read(name, tr):
    return harness.load_metric(ROOT, name)(tr)


def test_self_time_a_call(recorded):
    tr = Trace("query", CALLS, DEV)
    assert read("vt_draw_ms.query", tr) == pytest.approx(8e-3)
    # the upload with its child: 18 us a call, of which the child 7
    assert read("vt_upload_ms.query", tr) == pytest.approx(18e-3)
    assert spans.self_ms(tr, recorded["spans"], ("vt.upload",)) == pytest.approx(11e-3)
    assert spans.self_ms(tr, recorded["spans"], ("vt.plan",)) == pytest.approx(5e-3)
    assert read("vt_prep_ms.query", tr) == pytest.approx((10 + 8 + 2) * 1e-3)
    assert read("vt_percentiles_ms.query", tr) == pytest.approx(16e-3)
    # the top-level span's self time: 98 us less its children's 82
    assert spans.self_ms(tr, recorded["spans"], ("vt.run_batch",)) == pytest.approx(16e-3)


def test_nothing_to_read(recorded):
    tr = Trace("query", CALLS, DEV)
    assert read("vt_draw_ms.sweep", tr) is None  # another family's cells
    assert read("alloc_eval_ms.query", tr) is None  # no such span recorded
    assert read("host_unattributed_ms.sweep", tr) is None
    recorded["spans"] = None  # a program without the recorder, or nothing recorded
    assert read("vt_draw_ms.query", tr) is None and read("host_unattributed_ms.query", tr) is None
    recorded["spans"] = query_spans()[:-1]  # one top-level span fewer than the calls
    assert read("vt_draw_ms.query", tr) is None and read("host_unattributed_ms.query", tr) is None


def test_the_port_recorder(monkeypatch):
    """The spans come from the port's profiler-attached recorder, which
    holds nothing until a profiler records."""
    from repro_torch.fabric import telemetry

    monkeypatch.setattr(telemetry, "PROFILER_TELEMETRY", telemetry.Telemetry())
    tr = Trace("query", CALLS, DEV)
    assert spans.recorded() is None and read("vt_draw_ms.query", tr) is None
    for s in query_spans():
        telemetry.PROFILER_TELEMETRY.spans.append(telemetry.Span(
            s["name"], s["start"], s["end"], s["id"], s["parent"], s["call"], s["attrs"]))
    assert read("vt_draw_ms.query", tr) == pytest.approx(8e-3)


def test_offset_fit(recorded):
    """The top-level spans lie 1 us inside their calls at both ends, so the
    offset is known to 2 us, and its middle maps every span to the time it
    was stamped at on the profiler's clock, whatever the shift between the
    two clocks."""
    tr = Trace("query", CALLS, DEV)
    for shift_ns in (0, 7_000_000, -123_456_789):
        moved = [dict(s, start=s["start"] + shift_ns, end=s["end"] + shift_ns) for s in recorded["spans"]]
        off, width = spans.fit_offset(tr, moved)
        assert width == pytest.approx(2.0)
        base = min(s["start"] for s in moved if s["parent"] is None)
        draw = [s for s in moved if s["name"] == "vt.draw"][1]
        assert (draw["start"] - base) / 1e3 + off == pytest.approx(152.0)
        assert (draw["end"] - base) / 1e3 + off == pytest.approx(160.0)
    long = [dict(s, end=s["start"] + 200_000) if s["parent"] is None else s for s in recorded["spans"]]
    assert spans.fit_offset(tr, long) is None  # a top-level span longer than its call: no offset fits
    # top-level spans 700 us inside calls of 1,500: 1,402 us wide, over MAX_WIDTH_US
    far = [span(0, "vt.run_batch", 700, 798, None, 0), span(1, "vt.run_batch", 3000, 3098, None, 1)]
    assert spans.fit_offset(Trace("query", [(0.0, 1500.0), (2300.0, 3800.0)], DEV), far) is None
    assert spans.fit_offset(Trace("query", CALLS[:1], DEV), recorded["spans"]) is None  # counts differ


def test_host_unattributed(recorded):
    """Idle inside call 1: [0, 10], [70, 90], [95, 100]; its spans cover
    [2, 10] and [72, 88] of it: 35 - 24 = 11 us under no inner span. Call
    2: [150, 160] and [220, 250] idle; covered [152, 160] and [222, 238]:
    40 - 24 = 16."""
    tr = Trace("query", CALLS, DEV)
    assert read("host_unattributed_ms.query", tr) == pytest.approx((11 + 16) / 2 * 1e-3)
    assert read("host_exposed_ms.query", tr) == pytest.approx((35 + 40) / 2 * 1e-3)
    # a shifted clock moves nothing: the fit takes the shift out
    shifted = [dict(s, start=s["start"] + 7_000_000, end=s["end"] + 7_000_000) for s in recorded["spans"]]
    assert spans.unattributed_ms(tr, shifted) == pytest.approx((11 + 16) / 2 * 1e-3)

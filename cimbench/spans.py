"""The program's own spans in a traced window, and what the per-layer
metrics of single phases read from them.

The port records spans while a profiler records
(``repro_torch.fabric.telemetry.PROFILER_TELEMETRY``), so after the window
its recorder holds the spans of the window's calls. A span is a dict of the
recorder's ``snapshot()``: name, start and end in Unix-epoch nanoseconds,
id, parent (None for a top-level call into the program) and call (the id
of its top-level span). A program without that recorder, or one that
recorded nothing, gives every reader nothing to read, and the readers
return None.

Two readings: a phase's self time per call (a span's duration less what
its child spans cover, summed over the window, over the calls), and the
device-idle time inside calls that lies under no program span but the
top-level one. The second maps the spans onto the profiler's clock by one
offset, fitted from the calls: the i-th top-level span lies inside the
i-th harness call.
"""

from __future__ import annotations

__all__ = ["MAX_WIDTH_US", "recorded", "window", "self_ms", "phase_ms", "fit_offset", "unattributed_ms"]

# The widest offset interval a fit accepts: a span then lies at most half
# of it off. The harness's own work inside each call span, before and after
# the program's call (the call's seeds and arguments, its record, the
# synchronize), leaves 175 to 293 us of slack on an H100's host at 51 s
# windows, the sweep's 26 calls the widest.
MAX_WIDTH_US = 1000.0


def recorded():
    """The spans the port's profiler-attached recorder holds (its snapshot),
    or None where the program has no such recorder or it holds none."""
    try:
        from repro_torch.fabric import telemetry
    except ImportError:
        return None
    rec = getattr(telemetry, "PROFILER_TELEMETRY", None)
    spans = rec.snapshot()["spans"] if rec is not None else []
    return spans or None


def window(trace, family, spans=None):
    """The spans of the window in the cells of ``family`` (``spans``, or the
    recorder's), or None: another family's cells, nothing recorded, or not
    one top-level span a harness call."""
    if trace.family != family:
        return None
    spans = recorded() if spans is None else spans
    if not spans or sum(s["parent"] is None for s in spans) != len(trace.calls):
        return None
    return spans


def _covered(intervals, lo, hi) -> float:
    """Length of [lo, hi] that the union of ``intervals`` covers."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def self_ms(trace, spans, names) -> float:
    """Self time a call of the spans named ``names``, ms."""
    kids = {}
    for s in spans:
        if s["parent"] is not None:
            kids.setdefault(s["parent"], []).append((s["start"], s["end"]))
    ns = sum((s["end"] - s["start"]) - _covered(kids.get(s["id"], ()), s["start"], s["end"])
             for s in spans if s["name"] in names)
    return ns / len(trace.calls) * 1e-6


def phase_ms(trace, family, names, spans=None):
    """``self_ms`` of ``names`` in the cells of ``family``, or None where
    ``window`` finds nothing or no span of ``names`` was recorded."""
    spans = window(trace, family, spans)
    if spans is None or not any(s["name"] in names for s in spans):
        return None
    return self_ms(trace, spans, names)


def fit_offset(trace, spans):
    """(offset, width), us: a top-level span at ``t`` ns lies at ``(t -
    base) / 1000 + offset`` on the profiler's clock, ``base`` the first
    top-level span's start. The offset is the middle of the interval in
    which every top-level span lies inside its harness call; None where the
    counts differ, the interval is empty or it is wider than
    ``MAX_WIDTH_US``."""
    roots = sorted((s for s in spans if s["parent"] is None), key=lambda s: s["start"])
    if not roots or len(roots) != len(trace.calls):
        return None
    base = roots[0]["start"]
    lo = max(c0 - (s["start"] - base) / 1e3 for (c0, _), s in zip(trace.calls, roots))
    hi = min(c1 - (s["end"] - base) / 1e3 for (_, c1), s in zip(trace.calls, roots))
    if hi < lo or hi - lo > MAX_WIDTH_US:
        return None
    return 0.5 * (lo + hi), hi - lo


def unattributed_ms(trace, spans) -> float | None:
    """Device-idle time inside the calls under no program span but the
    top-level one, ms a call (None where ``fit_offset`` fails)."""
    fit = fit_offset(trace, spans)
    if fit is None:
        return None
    off = fit[0]
    base = min(s["start"] for s in spans if s["parent"] is None)
    inner = {}
    for s in spans:
        if s["parent"] is not None:
            inner.setdefault(s["call"], []).append(((s["start"] - base) / 1e3 + off, (s["end"] - base) / 1e3 + off))
    roots = sorted((s for s in spans if s["parent"] is None), key=lambda s: s["start"])
    total = 0.0
    for (c0, c1), r in zip(trace.calls, roots):
        idle = (c1 - c0) - trace.busy_us(c0, c1)
        end = c0
        for a, b in sorted(inner.get(r["call"], ())):  # the union of the call's inner spans, clipped to it
            a, b = max(a, end), min(b, c1)
            if b > a:
                idle -= (b - a) - trace.busy_us(a, b)
                end = b
        total += idle
    return total / len(trace.calls) * 1e-3

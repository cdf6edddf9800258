"""Telemetry recorder: counters / gauges / histograms / spans.

A copy of the reference's ``fabric/telemetry.py`` (numpy only).  Producers
(the DSE caches, the fused sweep's chunking gauges) talk to one small
interface, ``count`` / ``gauge`` / ``observe`` / ``span`` / ``timed``, and
consumers read a JSON-friendly ``snapshot()``.

Off by default: the process-global recorder is ``NULL_TELEMETRY``, whose
methods are empty no-ops, so call sites stay unconditional.  Spans are wall
clock (``time.perf_counter``) on the host; nothing here reads the device.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "Span",
    "Telemetry",
    "NULL_TELEMETRY",
    "get_telemetry",
    "set_telemetry",
    "telemetry_session",
]


@dataclass(frozen=True)
class Span:
    """One named interval, in seconds (wall clock) or any caller unit."""

    name: str
    start: float
    end: float
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


class Telemetry:
    """Accumulating recorder.  All methods are O(1) appends/adds; nothing
    here is thread-safe (the simulators are single-threaded) and nothing
    samples host state behind the caller's back."""

    enabled = True

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, list] = {}
        self.spans: list[Span] = []

    # ------------------------------------------------------------- recording
    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def gauge_max(self, name: str, value: float) -> None:
        """Monotone-max gauge: keeps the high-water mark across updates
        (peak RSS, peak in-flight) instead of the last write."""
        cur = self.gauges.get(name)
        v = float(value)
        self.gauges[name] = v if cur is None or v > cur else cur

    def observe(self, name: str, value: float) -> None:
        self.histograms.setdefault(name, []).append(float(value))

    def span(self, name: str, start: float, end: float, **attrs) -> None:
        self.spans.append(Span(name, float(start), float(end), attrs))

    @contextmanager
    def timed(self, name: str, **attrs):
        """Record a wall-clock span (and an ``<name>.s`` histogram sample)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.span(name, t0, t1, **attrs)
            self.observe(f"{name}.s", t1 - t0)

    # --------------------------------------------------------------- reading
    def hist_stats(self, name: str) -> dict:
        v = np.asarray(self.histograms.get(name, ()), dtype=np.float64)
        if v.size == 0:
            return {"count": 0}
        return {
            "count": int(v.size),
            "mean": float(v.mean()),
            "min": float(v.min()),
            "p50": float(np.percentile(v, 50.0)),
            "p99": float(np.percentile(v, 99.0)),
            "max": float(v.max()),
        }

    def snapshot(self) -> dict:
        """JSON-serializable view of everything recorded so far."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: self.hist_stats(k) for k in self.histograms},
            "spans": [
                {"name": s.name, "start": s.start, "end": s.end, **s.attrs}
                for s in self.spans
            ],
        }

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()
        self.spans.clear()


class _NullTelemetry(Telemetry):
    """The compiled-out recorder: every method is a no-op, so call sites can
    stay unconditional without paying for dict updates."""

    enabled = False

    def count(self, name, value=1.0):
        pass

    def gauge(self, name, value):
        pass

    def gauge_max(self, name, value):
        pass

    def observe(self, name, value):
        pass

    def span(self, name, start, end, **attrs):
        pass

    @contextmanager
    def timed(self, name, **attrs):
        yield


NULL_TELEMETRY = _NullTelemetry()
_GLOBAL: Telemetry = NULL_TELEMETRY


def get_telemetry() -> Telemetry:
    """The process-global recorder (``NULL_TELEMETRY`` unless a session is
    active).  Library code calls this at use time, never at import time, so
    enabling telemetry mid-process takes effect everywhere."""
    return _GLOBAL


def set_telemetry(t: Telemetry | None) -> Telemetry:
    """Install ``t`` as the global recorder (None -> NULL) and return it."""
    global _GLOBAL
    _GLOBAL = NULL_TELEMETRY if t is None else t
    return _GLOBAL


@contextmanager
def telemetry_session():
    """Scoped recorder: installs a fresh ``Telemetry`` globally, yields it,
    and restores the previous recorder on exit."""
    prev = _GLOBAL
    t = set_telemetry(Telemetry())
    try:
        yield t
    finally:
        set_telemetry(prev)

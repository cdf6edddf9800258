"""Telemetry recorder: counters / gauges / histograms / spans.

Producers (the DSE caches, the fused sweep's chunking gauges, VT's host
path and the fused sweep's stages) talk to one small interface, ``count`` /
``gauge`` / ``observe`` / ``span``, and consumers read a JSON-friendly
``snapshot()``.

Recording is off by default: ``get_telemetry()`` returns ``NULL_TELEMETRY``,
whose methods are empty no-ops, so call sites stay unconditional.  It is on
inside a ``telemetry_session`` (a fresh recorder), and, with no session,
whenever a ``torch.profiler`` window records: ``get_telemetry()`` then
returns the process-wide ``PROFILER_TELEMETRY``, which keeps what it
recorded until ``reset()``.  So an operator gets the program's spans by
running it under ``torch.profiler`` and reading
``PROFILER_TELEMETRY.snapshot()`` afterwards, with no flag.

A span records its name, its start and end in Unix-epoch nanoseconds
(``time.time_ns()``: the profiler converts its host and device events to
that clock, so one constant offset maps the spans onto its trace), its own
id, its parent's id (None at the top level) and the id of the top-level
call it belongs to.  A span opened with ``host=True`` holds host work that
launches nothing on the device and waits for nothing there; while a
profiler records, it is mirrored as ``record_function(name)``, so an
exported trace shows it on the host thread.  A span around a launch, a copy
or a readback is never mirrored: the profiler stretches a mirrored
annotation over the device work it encloses, on the device's timeline.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled

__all__ = [
    "Span",
    "Telemetry",
    "NULL_TELEMETRY",
    "PROFILER_TELEMETRY",
    "get_telemetry",
    "set_telemetry",
    "spanned",
    "telemetry_session",
]


@dataclass(frozen=True)
class Span:
    """One named interval of host time, in Unix-epoch nanoseconds."""

    name: str
    start: int
    end: int
    id: int
    parent: int | None  # the enclosing span's id; None for a top-level call
    call: int  # the id of the top-level call the span belongs to
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> int:
        return self.end - self.start


class _OpenSpan:
    """A span being recorded: entering it returns its attribute dict, which
    the body may fill in; leaving it appends the ``Span``."""

    __slots__ = ("tel", "name", "attrs", "mirror", "start", "id", "parent", "call")

    def __init__(self, tel: "Telemetry", name: str, host: bool, attrs: dict):
        self.tel, self.name, self.attrs = tel, name, attrs
        self.mirror = torch.autograd.profiler.record_function(name) if host and _profiler_enabled() else None

    def __enter__(self) -> dict:
        tel = self.tel
        self.id = tel._next_id
        tel._next_id += 1
        if tel._open:
            top = tel._open[-1]
            self.parent, self.call = top.id, top.call
        else:
            self.parent, self.call = None, tel._next_call
            tel._next_call += 1
        tel._open.append(self)
        if self.mirror is not None:
            self.mirror.__enter__()
        self.start = time.time_ns()
        return self.attrs

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        tel = self.tel
        tel._open.pop()
        tel.spans.append(Span(self.name, self.start, end, self.id, self.parent, self.call, self.attrs))


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
        self._open: list[_OpenSpan] = []
        self._next_id = 0
        self._next_call = 0

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

    def span(self, name: str, host: bool = False, **attrs):
        """A context manager recording a span around its body, child of the
        span open around it; ``host=True`` mirrors it to a recording
        profiler (host work only, see the module's docstring)."""
        return _OpenSpan(self, name, host, attrs)

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
                {"name": s.name, "start": s.start, "end": s.end, "id": s.id, "parent": s.parent,
                 "call": s.call, "attrs": dict(s.attrs)}
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

    def span(self, name, host=False, **attrs):
        return _NULL_SPAN


_NULL_SPAN = nullcontext()  # enters to None: no attributes to fill in
NULL_TELEMETRY = _NullTelemetry()
PROFILER_TELEMETRY = Telemetry()
_GLOBAL: Telemetry = NULL_TELEMETRY


def get_telemetry() -> Telemetry:
    """The recorder in force: a session's, else ``PROFILER_TELEMETRY`` while
    a ``torch.profiler`` window records, else ``NULL_TELEMETRY``.  Library
    code calls this at use time, never at import time, so enabling
    telemetry mid-process takes effect everywhere."""
    if _GLOBAL is not NULL_TELEMETRY:
        return _GLOBAL
    return PROFILER_TELEMETRY if _profiler_enabled() else NULL_TELEMETRY


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


def spanned(name: str, host: bool = False):
    """Decorator: each call of the function runs inside a span ``name`` of
    the recorder in force."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with get_telemetry().span(name, host):
                return fn(*args, **kwargs)

        return inner

    return wrap

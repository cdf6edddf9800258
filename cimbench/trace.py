"""The traced run: the window under ``torch.profiler`` (CPU and CUDA
activities), a span of the harness's own around every call into the
program, and the reduction of the trace to what the per-layer metrics
read: device activity by kernel name and by call, the device's busy time,
and its idle gaps by the span that was open."""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

__all__ = ["CALL_SPAN", "Trace", "traced"]

CALL_SPAN = "cimbench.call"


@dataclass
class Trace:
    """One traced window, times in microseconds of the profiler's clock.
    ``family`` names the cell's kind of call (sweep, query, replay);
    ``info`` is what the driver knows of its calls (configs, requests,
    bounds); ``calls`` are the harness's call spans, ``device`` every
    device activity (kernels, copies, sets) as (name, start, end)."""

    family: str
    calls: list
    device: list
    info: dict = field(default_factory=dict)

    @property
    def window(self) -> tuple[float, float]:
        return self.calls[0][0], self.calls[-1][1]

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) * 1e-6

    def merged(self) -> list:
        """Device activity as disjoint sorted (start, end) intervals."""
        if "_merged" not in self.__dict__:
            out = []
            for s, e in sorted((s, e) for _, s, e in self.device):
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            self.__dict__["_merged"] = out
            self.__dict__["_starts"] = [s for s, _ in out]
        return self.__dict__["_merged"]

    def busy_us(self, lo=None, hi=None) -> float:
        """Time inside [lo, hi] (the window by default) in which anything
        ran on the device."""
        a, b = self.window
        lo, hi = (a if lo is None else lo), (b if hi is None else hi)
        m = self.merged()
        k = max(0, bisect.bisect_right(self.__dict__["_starts"], lo) - 1)
        total = 0.0
        while k < len(m) and m[k][0] < hi:
            total += max(0.0, min(m[k][1], hi) - max(m[k][0], lo))
            k += 1
        return total

    def kernel_us(self, pattern: str) -> float:
        """Device time of the kernels whose name holds ``pattern``, inside
        the window."""
        a, b = self.window
        return sum(min(e, b) - max(s, a) for n, s, e in self.device if pattern in n and e > a and s < b)

    def launches(self, pattern: str) -> int:
        a, b = self.window
        return sum(1 for n, s, e in self.device if pattern in n and e > a and s < b)

    def host_exposed_us(self) -> float:
        """Summed over calls: each call's time with no device activity."""
        return sum((e - s) - self.busy_us(s, e) for s, e in self.calls)

    def device_ops(self, k: int = 10):
        a, b = self.window
        by = {}
        for n, s, e in self.device:
            if e > a and s < b:
                by[n] = by.get(n, 0.0) + (min(e, b) - max(s, a)) * 1e-6
        return sorted(([n, t] for n, t in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The longest stretches of the window with no device activity,
        each named by the harness span open at its middle."""
        a, b = self.window
        gaps, t = [], a
        for s, e in self.merged():
            if e <= a or s >= b:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b > t:
            gaps.append((t, b))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        starts = [s for s, _ in self.calls]
        out = []
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid) - 1
            inside = i >= 0 and self.calls[i][1] >= mid
            out.append([f"{CALL_SPAN}: host work inside a call" if inside else "between calls", (g1 - g0) * 1e-6])
        return out


@contextlib.contextmanager
def traced(on: bool):
    """Yields (span, finish): ``span()`` is a context manager around one
    call; ``finish(family, info)`` returns the ``Trace`` (None when off)."""
    if not on:
        def finish(family, info):
            return None
        yield contextlib.nullcontext, finish
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    done = []

    def span():
        return record_function(CALL_SPAN)

    def finish(family, info):
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        done.append(True)
        cuda = torch.autograd.DeviceType.CUDA
        calls, dev = [], []
        for e in prof.events():
            if e.device_type == cuda:
                if e.name != CALL_SPAN:  # the span's own annotation on the device's timeline
                    dev.append((e.name, e.time_range.start, e.time_range.end))
            elif e.name == CALL_SPAN:
                calls.append((e.time_range.start, e.time_range.end))
        calls.sort()
        if not calls:
            raise RuntimeError("profiler: no call spans in the traced window")
        if not dev:
            raise RuntimeError("profiler: no device activity in the traced window")
        return Trace(family, calls, dev, info)

    try:
        yield span, finish
    finally:
        if not done:
            prof.__exit__(None, None, None)

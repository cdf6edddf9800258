"""VT's share of its bound, %: the launch's bound (``cimbench.yardstick``:
the longest config's critical path at the frozen step price, or its bytes
at the memory's rate, whichever is longer; the driver's ``vt_bound_ns``)
over VT's device time, over every launch of the window."""

KERNEL = "vtime_scan_kernel"


def read(trace, family):
    n = trace.launches(KERNEL)
    if trace.family != family or n == 0 or "vt_bound_ns" not in trace.info:
        return None
    return 100.0 * trace.info["vt_bound_ns"] * n / (trace.kernel_us(KERNEL) * 1e3)

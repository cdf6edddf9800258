"""VT's device time (``vtime_scan_kernel``), ms a call, in the cells of
``family``."""

KERNEL = "vtime_scan_kernel"


def read(trace, family):
    if trace.family != family or trace.launches(KERNEL) == 0:
        return None
    return trace.kernel_us(KERNEL) / len(trace.calls) * 1e-3

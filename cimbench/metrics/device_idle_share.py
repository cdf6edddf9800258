"""The share of the traced window in which nothing ran on the device, in
the cells of ``family``."""


def read(trace, family):
    if trace.family != family:
        return None
    a, b = trace.window
    return 1.0 - trace.busy_us() / (b - a)

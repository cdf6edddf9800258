"""VT's work rate: the job steps the call's inputs need (the driver's
``vt_steps``: every config's requests x jobs a request,
``cimbench.yardstick.config_steps``) over VT's device seconds."""

KERNEL = "vtime_scan_kernel"


def read(trace, family):
    if trace.family != family or trace.launches(KERNEL) == 0 or "vt_steps" not in trace.info:
        return None
    return trace.info["vt_steps"] * len(trace.calls) / (trace.kernel_us(KERNEL) * 1e-6)

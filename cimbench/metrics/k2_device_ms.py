"""K2's device time (``fused_alloc_eval_kernel``), ms a call, in the cells
of ``family``."""

KERNEL = "fused_alloc_eval_kernel"


def read(trace, family):
    if trace.family != family or trace.launches(KERNEL) == 0:
        return None
    return trace.kernel_us(KERNEL) / len(trace.calls) * 1e-3

"""The latency percentiles on the host (the program's span
``vt.percentiles``), ms a call, in the cells of ``family``."""

from cimbench import spans


def read(trace, family):
    return spans.phase_ms(trace, family, ("vt.percentiles",))

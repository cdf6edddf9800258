"""Device-idle time inside the calls that lies under no span of the
program but the call's top-level one, ms a call: the part of
``host_exposed_ms`` the program's spans leave unexplained, in the cells of
``family``. The spans are placed on the profiler's clock by one offset
fitted from the calls (``cimbench.spans.fit_offset``)."""

from cimbench import spans


def read(trace, family):
    got = spans.window(trace, family)
    return None if got is None else spans.unattributed_ms(trace, got)

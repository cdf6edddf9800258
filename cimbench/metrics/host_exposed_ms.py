"""Each call's wall time with no device activity, ms a call (the host's
part of the call that nothing on the card hides), in the cells of
``family``."""


def read(trace, family):
    if trace.family != family:
        return None
    return trace.host_exposed_us() / len(trace.calls) * 1e-3

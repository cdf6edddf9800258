"""The service-index draw (the program's span ``vt.draw``, in
``sample_service_indices``), ms a call, in the cells of ``family``."""

from cimbench import spans


def read(trace, family):
    return spans.phase_ms(trace, family, ("vt.draw",))

"""The indices' upload (the program's span ``vt.upload``, in
``upload_indices``, with its child ``vt.pack_indices``: concatenate, cast
to int32, pin, and the copy's enqueue), ms a call, in the cells of
``family``."""

from cimbench import spans


def read(trace, family):
    return spans.phase_ms(trace, family, ("vt.upload", "vt.pack_indices"))

"""VT's wrapper before the kernel runs (the program's spans
``vt.prepare``, its input checks and their readback; ``vt.plan`` with its
child ``vt.kernel_plan``, the lanes' readback, the plan and the flat
buffers; ``vt.launch``, the launch's enqueue), ms a call, in the cells of
``family``."""

from cimbench import spans


def read(trace, family):
    return spans.phase_ms(trace, family, ("vt.prepare", "vt.plan", "vt.kernel_plan", "vt.launch"))

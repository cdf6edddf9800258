"""The fused sweep's analytic stage (the program's span
``dse.fused.alloc_eval``, ``FusedPipeline.__call__``, with its children
``k2.launch`` and ``dse.fused.copy_out``), ms a call, in the cells of
``family``."""

from cimbench import spans


def read(trace, family):
    return spans.phase_ms(trace, family, ("dse.fused.alloc_eval", "k2.launch", "dse.fused.copy_out"))

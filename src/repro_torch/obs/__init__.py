"""Observability exporters for the fabric telemetry layer (ported from the
reference ``obs``): Chrome/Perfetto ``trace_event`` timelines from an
instrumented event-engine run (``trace``), the Fig-9-style utilization
table (``report``) and the allocator's decision log (``audit``).  Nothing
here touches the simulation hot paths; exporters read the ``stats`` /
``record_starts`` artifacts after a run."""

from .audit import AllocationAudit, AuditEntry
from .report import UtilizationReport, utilization_report
from .trace import build_trace, validate_trace, write_trace

__all__ = [
    "AllocationAudit",
    "AuditEntry",
    "UtilizationReport",
    "utilization_report",
    "build_trace",
    "validate_trace",
    "write_trace",
]

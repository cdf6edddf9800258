"""Allocation audit log: why each replica was granted.

The greedy allocators (``core.alloc.greedy.greedy_allocate`` /
``greedy_allocate_placed``) take an optional ``audit=AllocationAudit()``
and append one entry per grant — the unit chosen, what its expected latency
was before and after, what the grant cost, what remained — plus a final
entry for the paper's stopping rule when it fires.  The log is the
explanation artifact: "replica 37 went to block 12 because it was the
slowest affordable unit at 1.9e5 cycles".  ``audit=None`` (the default)
leaves the allocators' loops untouched.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["AuditEntry", "AllocationAudit"]


@dataclass(frozen=True)
class AuditEntry:
    step: int  # grant index (0-based); stop entries reuse the next index
    kind: str  # "grant" | "stop"
    unit: int  # unit granted (grant) or the unaffordable slowest unit (stop)
    cost: float  # arrays consumed by this grant / needed by the blocked unit
    remaining: float  # budget left AFTER the grant (stop: at the stop)
    latency_before: float = 0.0  # unit's expected latency driving the choice
    latency_after: float = 0.0  # after the grant (base / new replica count)
    chip: int | None = None  # placed greedy: chip the replica landed on
    reason: str = ""  # stop entries: "budget" | "capacity"


class AllocationAudit:
    """Accumulates ``AuditEntry`` records from one allocator call."""

    def __init__(self):
        self.entries: list[AuditEntry] = []

    def grant(
        self,
        unit: int,
        cost: float,
        latency_before: float,
        latency_after: float,
        remaining: float,
        chip: int | None = None,
    ) -> None:
        self.entries.append(
            AuditEntry(
                step=len(self.entries),
                kind="grant",
                unit=int(unit),
                cost=float(cost),
                remaining=float(remaining),
                latency_before=float(latency_before),
                latency_after=float(latency_after),
                chip=None if chip is None else int(chip),
            )
        )

    def stop(self, reason: str, unit: int, cost: float, remaining: float) -> None:
        self.entries.append(
            AuditEntry(
                step=len(self.entries),
                kind="stop",
                unit=int(unit),
                cost=float(cost),
                remaining=float(remaining),
                reason=reason,
            )
        )

    # --------------------------------------------------------------- reading
    @property
    def grants(self) -> list[AuditEntry]:
        return [e for e in self.entries if e.kind == "grant"]

    @property
    def stop_reason(self) -> str | None:
        for e in reversed(self.entries):
            if e.kind == "stop":
                return e.reason
        return None

    def summary(self) -> dict:
        g = self.grants
        spent = sum(e.cost for e in g)
        per_unit: dict[int, int] = {}
        for e in g:
            per_unit[e.unit] = per_unit.get(e.unit, 0) + 1
        return {
            "grants": len(g),
            "spent": spent,
            "stop_reason": self.stop_reason,
            "grants_per_unit": per_unit,
        }

    def to_json(self) -> list[dict]:
        out = []
        for e in self.entries:
            d = {
                "step": e.step,
                "kind": e.kind,
                "unit": e.unit,
                "cost": e.cost,
                "remaining": e.remaining,
            }
            if e.kind == "grant":
                d["latency_before"] = e.latency_before
                d["latency_after"] = e.latency_after
                if e.chip is not None:
                    d["chip"] = e.chip
            else:
                d["reason"] = e.reason
            out.append(d)
        return out

    def __len__(self) -> int:
        return len(self.entries)

"""Three-term roofline of one step (reference: ``src/repro/core/roofline.py``).

  compute    = flops            / (chips * peak_flops)
  memory     = bytes            / (chips * hbm_bw)
  collective = collective_bytes / (chips * link_bw)

The counts come from ``core.hlo_analysis.analyze_step``, one rank's step
traced under ``FakeTensorMode`` (the reference parses the per-device HLO);
they are per chip, and ``analyze`` multiplies them by ``chips`` as the
reference does, so each term divides by one chip's rate.

Hardware model: one NVIDIA H100 SXM, from NVIDIA's data sheet (spec-sheet
figures, not measurements): 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s of HBM3, NVLink 4 at 900 GB/s both ways, 450 GB/s a direction,
the link rate a collective byte is priced at.  These are the constants
``chip_smoke.py`` prices its kernel bounds with.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["HW", "CollectiveStats", "Roofline", "analyze", "collective_stats"]

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores, a chip
HBM_BW = 3.35e12  # bytes/s a chip
LINK_BW = 450e9  # bytes/s a direction, NVLink 4


@dataclass(frozen=True)
class HW:
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())


def collective_stats(cost) -> CollectiveStats:
    """Operand bytes and counts of each collective of a step, by the
    reference's op names (all-reduce, all-gather, reduce-scatter,
    all-to-all, collective-permute), from an ``HloCost``."""
    return CollectiveStats(dict(cost.coll_by_op), dict(cost.coll_count))


@dataclass(frozen=True)
class Roofline:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int
    model_flops: float = 0.0
    hw: HW = field(default_factory=HW)

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.hw.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / (self.chips * self.hw.hbm_bw)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * self.hw.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The roofline step time: the largest term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_fraction(self) -> float:
        """Model FLOPs over counted FLOPs: remat, padding and redundancy."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The share of peak the step reaches if it runs at the roofline:
        useful model FLOPs / (chips * peak * step time)."""
        t = self.step_time_s
        if not t:
            return 0.0
        return self.model_flops / (self.chips * self.hw.peak_flops * t)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flop_fraction": self.useful_flop_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(cost, chips: int, model_flops: float = 0.0, hw: HW = HW()) -> Roofline:
    """The roofline of a step from one rank's ``HloCost`` (per chip):
    whole-program totals are the per-chip counts times ``chips``."""
    return Roofline(
        flops=cost.flops * chips,
        bytes_accessed=cost.hbm_bytes * chips,
        collective_bytes=cost.collective_bytes * chips,
        chips=chips,
        model_flops=model_flops,
        hw=hw,
    )

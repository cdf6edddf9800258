"""Utilization report: the paper's Fig-9-style analysis as a standard table.

The paper's argument is that synchronization barriers strand array cycles;
this report shows exactly where each layer's capacity went on a real
(simulated) serving run, from an instrumented ``FabricSim(stats=True)``
result:

  * ``duty_cycle`` — true compute array-cycles / capacity (the paper's
    utilization);
  * ``barrier_frac`` — capacity occupied but wasted inside the layer's
    gather/accumulate barrier (arrays holding their result while the
    slowest block of the same duplicate finishes; layer-wise dataflow only
    — block-wise dataflow decouples the blocks, which is the paper's fix);
  * ``reprogram_frac`` — capacity frozen while drift re-allocation rewrites
    conductances (``drift.py`` stalls);
  * ``starved_frac`` — capacity idle with no job available: waiting on
    upstream stages, pipeline warmup/drain, or replica over-provisioning.

The four fractions plus duty cycle account for all capacity:
``duty + barrier + reprogram + starved = 1`` (pools are work-conserving).
Queue wait (jobs waiting for a free replica) is reported per job — it costs
requests latency, not arrays capacity.

Ported from the reference ``obs/report.py`` (numpy on the host, verbatim).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["UtilizationReport", "utilization_report"]


@dataclass(frozen=True)
class UtilizationReport:
    policy: str
    clock_hz: float
    n_requests: int
    makespan_cycles: float
    arrays: np.ndarray  # (L,) arrays allocated per layer
    duty_cycle: np.ndarray  # (L,) true busy / capacity
    barrier_frac: np.ndarray  # (L,) intra-layer barrier waste / capacity
    reprogram_frac: np.ndarray  # (L,) reprogramming freeze / capacity
    starved_frac: np.ndarray  # (L,) idle (upstream wait, warmup/drain)
    imbalance: np.ndarray  # (L,) max/mean busy over replica lanes
    queue_wait_per_job: np.ndarray  # (L,) cycles a job waits for a replica
    jobs: np.ndarray  # (L,) jobs dispatched
    residence_mean: np.ndarray  # (L,) mean request residence in the stage

    @property
    def mean_duty_cycle(self) -> float:
        return float(self.duty_cycle.mean()) if self.duty_cycle.size else 0.0

    def to_json(self) -> dict:
        return {
            "policy": self.policy,
            "clock_hz": self.clock_hz,
            "n_requests": self.n_requests,
            "makespan_cycles": self.makespan_cycles,
            "mean_duty_cycle": self.mean_duty_cycle,
            "layers": [
                {
                    "layer": int(i),
                    "arrays": float(self.arrays[i]),
                    "duty_cycle": float(self.duty_cycle[i]),
                    "barrier_frac": float(self.barrier_frac[i]),
                    "reprogram_frac": float(self.reprogram_frac[i]),
                    "starved_frac": float(self.starved_frac[i]),
                    "imbalance": float(self.imbalance[i]),
                    "queue_wait_per_job": float(self.queue_wait_per_job[i]),
                    "jobs": int(self.jobs[i]),
                    "residence_mean": float(self.residence_mean[i]),
                }
                for i in range(self.duty_cycle.size)
            ],
        }

    def format(self) -> str:
        """Fixed-width text table (one row per layer + a mean row)."""
        hdr = (
            f"{'layer':>5} {'arrays':>7} {'duty%':>7} {'barrier%':>9} "
            f"{'reprog%':>8} {'starved%':>9} {'imbal':>6} {'wait/job':>10} "
            f"{'jobs':>9}"
        )
        lines = [f"policy={self.policy}  requests={self.n_requests}  "
                 f"makespan={self.makespan_cycles:.3e} cycles", hdr]
        for i in range(self.duty_cycle.size):
            lines.append(
                f"{i:>5} {self.arrays[i]:>7.0f} {100*self.duty_cycle[i]:>7.2f} "
                f"{100*self.barrier_frac[i]:>9.2f} "
                f"{100*self.reprogram_frac[i]:>8.2f} "
                f"{100*self.starved_frac[i]:>9.2f} {self.imbalance[i]:>6.3f} "
                f"{self.queue_wait_per_job[i]:>10.1f} {self.jobs[i]:>9d}"
            )
        lines.append(f"{'mean':>5} {'':>7} {100*self.mean_duty_cycle:>7.2f}")
        return "\n".join(lines)


def utilization_report(result) -> UtilizationReport:
    """Build the report from a ``FabricSim(stats=True)`` ``FabricResult``."""
    st = result.stats
    if st is None:
        raise ValueError(
            "utilization_report needs FabricResult.stats — run the fabric "
            "with FabricSim(..., stats=True)"
        )
    span = result.makespan
    cap = (
        result.layer_capacity
        if result.layer_capacity is not None
        else result.layer_arrays * span
    )
    cap = np.maximum(np.asarray(cap, dtype=np.float64), 1e-300)
    occupied = (
        st.layer_occupied
        if st.layer_occupied is not None
        else result.layer_busy
    )
    duty = result.layer_busy / cap
    barrier = np.maximum((occupied - result.layer_busy) / cap, 0.0)
    reprog = st.layer_reprogram / cap
    starved = np.maximum(1.0 - occupied / cap - reprog, 0.0)
    jobs = st.layer_jobs.astype(np.int64)
    wait_per_job = st.layer_queue_wait / np.maximum(jobs, 1)
    residence = (st.stage_exit - st.stage_entry).mean(axis=0)
    return UtilizationReport(
        policy=result.policy,
        clock_hz=result.clock_hz,
        n_requests=int(result.completions.size),
        makespan_cycles=span,
        arrays=np.asarray(result.layer_arrays, dtype=np.float64),
        duty_cycle=duty,
        barrier_frac=barrier,
        reprogram_frac=reprog,
        starved_frac=starved,
        imbalance=st.replica_imbalance(),
        queue_wait_per_job=wait_per_job,
        jobs=jobs,
        residence_mean=residence,
    )

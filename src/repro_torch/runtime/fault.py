"""Fault-tolerant training runner (reference: ``src/repro/runtime/fault.py``).

Production behaviours, exercised at host scale by the tests and on the card
at SMOKE by ``chip_smoke.py``:
  * checkpoint every ``ckpt_every`` steps (``checkpoint.store``, the
    reference's format); on ANY step failure, restore the latest checkpoint
    and replay (the data pipeline is deterministic in step, so the replay
    repeats the run: bit for bit on the card under
    ``torch.use_deterministic_algorithms``),
  * bounded retries per step, then re-raise (a real launcher would
    reschedule the job on fresh hosts),
  * straggler detection: per-step wall times feed an EWMA; steps slower than
    ``straggler_factor`` x the EWMA fire a callback.  Synchronized steps run
    at the speed of the slowest participant, the paper's observation applied
    to the training loop.

The step function may update its parameters and optimizer state in place
(the port's train step does); a restore then copies the checkpoint into
them in place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..checkpoint.store import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["RunnerConfig", "StepStats", "TrainRunner", "FaultInjector"]


@dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_last: int = 3
    max_retries_per_step: int = 3
    straggler_factor: float = 2.5
    ewma_alpha: float = 0.2


@dataclass
class StepStats:
    step: int
    seconds: float
    retried: int
    straggler: bool
    metrics: dict = field(default_factory=dict)


class FaultInjector:
    """Deterministic failure schedule for tests: raises on listed steps
    (once each)."""

    def __init__(
        self,
        fail_at: dict[int, int] | None = None,
        slow_at: dict[int, float] | None = None,
        sleep: Callable[[float], None] | None = None,
    ):
        self.fail_budget = dict(fail_at or {})
        self.slow_at = dict(slow_at or {})
        self._sleep = sleep

    def __call__(self, step: int) -> None:
        if self.slow_at.get(step):
            # default late-bound so tests may monkeypatch time.sleep; a fake
            # clock's `advance` can be injected instead for determinism
            (self._sleep or time.sleep)(self.slow_at[step])
        if self.fail_budget.get(step, 0) > 0:
            self.fail_budget[step] -= 1
            raise RuntimeError(f"injected failure at step {step}")

    @classmethod
    def from_trace(
        cls,
        trace,
        cycles_per_step: float,
        *,
        slow_at: dict[int, float] | None = None,
        sleep: Callable[[float], None] | None = None,
    ) -> "FaultInjector":
        """Drive the training-side injector from a fabric failure trace.

        ``trace`` is a ``fabric.failures.FailureTrace``; each array failure
        lands on training step ``floor(time / cycles_per_step)``, so the
        training runner and the fabric engines exercise one seeded failure
        schedule.
        """
        # local import: runtime stays importable without the fabric package
        from ..fabric.failures import failure_step_schedule

        return cls(
            fail_at=failure_step_schedule(trace, cycles_per_step),
            slow_at=slow_at,
            sleep=sleep,
        )


class TrainRunner:
    def __init__(
        self,
        cfg: RunnerConfig,
        step_fn: Callable[[Any, Any, dict], tuple[Any, Any, dict]],
        batch_fn: Callable[[int], dict],
        *,
        fingerprint: str = "",
        on_straggler: Callable[[StepStats], None] | None = None,
        fault_hook: Callable[[int], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.fingerprint = fingerprint
        self.on_straggler = on_straggler
        self.fault_hook = fault_hook
        self.clock = clock
        self.history: list[StepStats] = []
        self.restores = 0
        self._ewma: float | None = None
        self._settled = 0  # steps already folded into the EWMA

    # ------------------------------------------------------------- lifecycle
    def _save(self, step, params, opt_state):
        save_checkpoint(
            self.cfg.ckpt_dir,
            step,
            {"params": params, "opt": opt_state},
            config_fingerprint=self.fingerprint,
            keep_last=self.cfg.keep_last,
        )

    def _restore(self, params_like, opt_like):
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return 0, None
        tree, _ = restore_checkpoint(
            self.cfg.ckpt_dir,
            {"params": params_like, "opt": opt_like},
            config_fingerprint=self.fingerprint,
        )
        return step, tree

    # ------------------------------------------------------------------ run
    def run(self, params, opt_state, n_steps: int, start_step: int = 0):
        """Run to `n_steps`, surviving injected/real step failures."""
        step = start_step
        while step < n_steps:
            retries = 0
            while True:
                t0 = self.clock()
                try:
                    if self.fault_hook:
                        self.fault_hook(step)
                    batch = self.batch_fn(step)
                    params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                    metrics = {
                        k: float(v) for k, v in metrics.items()
                    }
                    break
                except Exception:
                    retries += 1
                    if retries > self.cfg.max_retries_per_step:
                        raise
                    # restore-and-replay from last checkpoint
                    restored_step, tree = self._restore(params, opt_state)
                    self.restores += 1
                    if tree is not None:
                        params, opt_state = tree["params"], tree["opt"]
                        step = restored_step
            dt = self.clock() - t0
            # warm-up guard: the EWMA is meaningless until at least two steps
            # have settled into it, so no straggler verdicts before then
            straggler = (
                self._settled >= 2
                and self._ewma is not None
                and dt > self.cfg.straggler_factor * self._ewma
            )
            self._ewma = (
                dt
                if self._ewma is None
                else (1 - self.cfg.ewma_alpha) * self._ewma + self.cfg.ewma_alpha * dt
            )
            self._settled += 1
            stats = StepStats(step, dt, retries, straggler, metrics)
            self.history.append(stats)
            if straggler and self.on_straggler:
                self.on_straggler(stats)
            step += 1
            if step % self.cfg.ckpt_every == 0 or step == n_steps:
                self._save(step, params, opt_state)
        return params, opt_state

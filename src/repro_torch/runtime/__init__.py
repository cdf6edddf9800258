from .fault import FaultInjector, RunnerConfig, StepStats, TrainRunner

__all__ = ["FaultInjector", "RunnerConfig", "StepStats", "TrainRunner"]

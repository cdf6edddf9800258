from .pipeline import DataConfig, SyntheticLM, batch_for_step

__all__ = ["DataConfig", "SyntheticLM", "batch_for_step"]

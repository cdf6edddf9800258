"""Runnable flows of the port (``python -m repro_torch.examples.<name>``),
counterparts of the reference's ``examples/`` scripts."""

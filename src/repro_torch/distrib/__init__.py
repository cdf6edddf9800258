"""Distribution over a ``DeviceMesh`` (reference: ``src/repro/distrib``):
the sharding rules (``sharding``), ``shard_map`` and its collectives
(``compat``), the current mesh (``context``), the GPipe schedule
(``pipeline``), and ``sharding.shard_map_batch``, which splits a batched
evaluation's config axis over the local devices."""

from .pipeline import bubble_fraction, make_pipeline_fn, report_stage_plan, stack_stages
from .sharding import (
    batch_axes,
    cache_specs,
    data_specs,
    local_eval_devices,
    named,
    opt_specs,
    param_specs,
    shard_map_batch,
    tp_size,
)

__all__ = [
    "bubble_fraction",
    "make_pipeline_fn",
    "report_stage_plan",
    "stack_stages",
    "batch_axes",
    "cache_specs",
    "data_specs",
    "local_eval_devices",
    "named",
    "opt_specs",
    "param_specs",
    "shard_map_batch",
    "tp_size",
]

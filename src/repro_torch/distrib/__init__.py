"""Device-parallel helpers.  Ported so far: ``sharding.shard_map_batch``,
which splits a batched evaluation's config axis over the local devices.
The LM side's sharding rules, pipeline and context parallelism are still to
come (ROADMAP.md §1)."""

from .sharding import local_eval_devices, shard_map_batch

__all__ = ["local_eval_devices", "shard_map_batch"]

"""Fabric runtime.  Only ``telemetry`` is ported so far (the fused sweep's
gauges and the sweep caches use it); the event engine, the virtual-time
scan, metrics, drift and tenancy are still to port (ROADMAP.md §1)."""

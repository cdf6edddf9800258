"""The current mesh (reference: ``src/repro/distrib/context.py``).

Model code (``gqa_fwd``, ``moe_fwd``, ``_constrain_heads``) reads the mesh
from here to pick its distributed path without threading it through every
call.  The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
dimension names are the reference's axis names; ``launch.specs.build_cell``
and the launchers set it, and without one every layer takes its local path.
"""

from __future__ import annotations

from contextlib import contextmanager

from torch.distributed.device_mesh import DeviceMesh

__all__ = ["get_mesh", "set_mesh", "use_mesh"]

_CURRENT: list[DeviceMesh | None] = [None]


def set_mesh(mesh: DeviceMesh | None) -> None:
    _CURRENT[0] = mesh


def get_mesh() -> DeviceMesh | None:
    return _CURRENT[0]


@contextmanager
def use_mesh(mesh: DeviceMesh | None):
    prev = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield mesh
    finally:
        _CURRENT[0] = prev

"""Meshes (reference: ``src/repro/launch/mesh.py``).

Functions, not module-level constants: importing this module starts no
process group.  A ``DeviceMesh`` needs one already initialised, of exactly
the mesh's size:

  * under ``torchrun`` (``torch.distributed.init_process_group`` with NCCL
    across the cards, gloo on the host);
  * in the dry run (``launch.dryrun``), the ``fake`` backend of
    ``torch.testing._internal.distributed.fake_pg``, one rank standing for
    every chip;
  * on one card, a one-rank NCCL group (``init_process_group`` with a
    ``FileStore`` or ``HashStore``, no network).

``make_production_mesh`` is the reference's (16, 16) ("data", "model") pod,
or (2, 16, 16) with "pod" in front; ``make_cpu_mesh`` the (1, 1) mesh of one
host rank; ``make_device_mesh`` any shape on any device type.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_cpu_mesh", "make_device_mesh", "make_production_mesh"]


def make_device_mesh(shape: tuple, axes: tuple, device: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the current process group,
    on ``device``'s type ("cuda" or "cpu").  The group must have
    prod(shape) ranks."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
    want = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != want or not dist.is_initialized():
        none = "" if dist.is_initialized() else " (no process group initialised: torchrun, or init_process_group)"
        raise RuntimeError(f"a {shape} mesh needs a process group of {want} ranks, found world size {world}{none}")
    dev = device if isinstance(device, str) else device.type
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """16 x 16 = 256 chips a pod; (2, 16, 16) = 512 across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_device_mesh(shape, axes, device)


def make_cpu_mesh() -> DeviceMesh:
    """The (1, 1) ("data", "model") mesh over the one host rank."""
    return make_device_mesh((1, 1), ("data", "model"), "cpu")

"""Checkpoint store in the reference's on-disk format (reference:
``src/repro/checkpoint/store.py``), so that a checkpoint that either package
wrote restores in the other.

  * ``step_%08d`` directories, written to a temporary directory, the
    manifest fsynced, then renamed: a crash mid-save never corrupts the
    latest checkpoint;
  * ``manifest.json``: step, time, mesh shape, config fingerprint, array
    count and total bytes; a restore refuses another fingerprint;
  * ``arrays.npz`` keyed by the reference's ``/``-joined pytree paths, in
    its layout: ``params/layers/attn/wq`` stacked on a leading layer axis,
    ``opt/m/...``, ``opt/v/...``, ``opt/step``;
  * ``keep_last`` garbage collection.

A tree is nested dicts whose leaves are numpy arrays, numpy scalars or
tensors; an ``nn.Module`` stands for its named parameters, and a name
``layers.<i>.<rest>`` (a module's, or the key of a dict keyed like its
parameters, as the optimizer's moments are) is layer i of the stacked
``layers/<rest>``, and likewise ``enc_layers.<i>.<rest>`` and
``dec_layers.<i>.<rest>`` of the enc-dec model (``convert.lm_param_path``,
the mapping of ``convert.lm_params_from_numpy``,
``convert.encdec_params_from_numpy`` and their inverse), so an LM's or a
Whisper checkpoint written by either package restores in the other.  A restore copies into
the tensors of ``like`` in place (the model's parameters, the optimizer's
state); a tensor of ``like`` on the meta device, or a module whose
parameters are, is made on ``device`` (the card by default; it raises
without one); any other leaf comes back as a numpy array of its dtype.  A
DTensor (a model placed on a mesh) is saved whole and restored into its
placement, each rank keeping its shard.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from .. import resolve_device
from ..convert import lm_param_path

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_steps"]

_MANIFEST = "manifest.json"
_PAYLOAD = "arrays.npz"


def _children(node):
    return node.named_parameters() if isinstance(node, nn.Module) else node.items()


def _join(prefix: str, path: str) -> str:
    return f"{prefix}/{path}" if prefix else path


def _entries(tree: Any, prefix: str = "", index: int | None = None):
    """(key, layer index or None, leaf) for every leaf of ``tree``."""
    if isinstance(tree, (dict, nn.Module)):
        for name, child in _children(tree):
            path, i = lm_param_path(str(name))
            yield from _entries(child, _join(prefix, path), index if i is None else i)
    else:
        yield prefix, index, tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()  # a placed tensor is saved whole
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    """The reference's flat path-keyed arrays, layers stacked."""
    out, stacked = {}, {}
    for key, i, leaf in _entries(tree):
        if i is None:
            out[key] = _numpy(leaf)
        else:
            stacked.setdefault(key, {})[i] = _numpy(leaf)
    for key, parts in stacked.items():
        if sorted(parts) != list(range(len(parts))):
            raise ValueError(f"{key}: layers {sorted(parts)} are not 0..{len(parts) - 1}")
        out[key] = np.stack([parts[i] for i in range(len(parts))])
    return dict(sorted(out.items()))


def save_checkpoint(
    root: str,
    step: int,
    tree: Any,
    *,
    mesh_shape: tuple | None = None,
    config_fingerprint: str = "",
    keep_last: int = 3,
) -> str:
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=root)
    try:
        arrays = _flatten(tree)
        np.savez(os.path.join(tmp, _PAYLOAD), **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "mesh_shape": list(mesh_shape) if mesh_shape else None,
            "config_fingerprint": config_fingerprint,
            "n_arrays": len(arrays),
            "total_bytes": int(sum(a.nbytes for a in arrays.values())),
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(root, keep_last)
    return final


def _gc(root: str, keep_last: int) -> None:
    steps = list_steps(root)
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)


def list_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


class _Payload:
    """The checkpoint's arrays, each read from the archive once."""

    def __init__(self, npz):
        self.npz, self.cache = npz, {}

    def read(self, key: str, index: int | None, like) -> np.ndarray:
        if key not in self.cache:
            if key not in self.npz:
                raise KeyError(f"checkpoint missing {key}")
            self.cache[key] = self.npz[key]
        arr = self.cache[key] if index is None else self.cache[key][index]
        want = tuple(like.shape) if hasattr(like, "shape") else np.shape(like)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: shape {arr.shape} != expected {want}")
        return arr


def _placed_like(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``src`` placed as ``dst`` is when ``dst`` is a DTensor (each rank
    keeps its shard of the whole array it read)."""
    if isinstance(dst, DTensor):
        return distribute_tensor(src.to(dst.device_mesh.device_type), dst.device_mesh, dst.placements)
    return src


def _restore(node, payload: _Payload, device, prefix: str = "", index: int | None = None):
    if isinstance(node, nn.Module):
        if any(p.is_meta for p in node.parameters()):
            node.to_empty(device=resolve_device(device))
        with torch.no_grad():
            for name, p in node.named_parameters():
                path, i = lm_param_path(name)
                p.copy_(_placed_like(torch.from_numpy(payload.read(_join(prefix, path), i, p)), p))
        return node
    if isinstance(node, dict):
        out = {}
        for name, child in node.items():
            path, i = lm_param_path(str(name))
            out[name] = _restore(child, payload, device, _join(prefix, path), index if i is None else i)
        return out
    arr = payload.read(prefix, index, node)
    if isinstance(node, torch.Tensor):
        if node.is_meta:
            return torch.from_numpy(np.array(arr)).to(device=resolve_device(device), dtype=node.dtype)
        with torch.no_grad():
            node.copy_(_placed_like(torch.from_numpy(np.array(arr)), node))
        return node
    return np.asarray(arr).astype(getattr(node, "dtype", np.asarray(node).dtype))


def restore_checkpoint(
    root: str,
    like: Any,
    step: int | None = None,
    *,
    config_fingerprint: str = "",
    device: str | torch.device = "cuda",
) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (module docstring): returns
    (the restored tree, the manifest).  The fingerprint must match when both
    are set."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if (config_fingerprint and manifest["config_fingerprint"]
            and manifest["config_fingerprint"] != config_fingerprint):
        raise ValueError(
            f"checkpoint config fingerprint {manifest['config_fingerprint']!r} "
            f"!= requested {config_fingerprint!r}"
        )
    with np.load(os.path.join(path, _PAYLOAD)) as npz:
        tree = _restore(like, _Payload(npz), device)
    return tree, manifest

"""Carries the reference's inputs and captures across as numpy.

``jax.random`` and ``torch.Generator`` give different numbers from one seed,
so to compute the same thing in both packages a caller makes the inputs
once and hands them over:

  * ``capture_inputs_from_numpy`` — NHWC images and per-layer (rows, cout)
    weights for ``capture_activations(..., images=, weights=)``;
  * ``capture_from_numpy`` — an ``ActivationCapture`` rebuilt from any
    object with the reference capture's fields (numpy ``rowbits`` and
    ``sampled_q`` per layer), for ``derive_profile``;
  * ``lm_params_from_numpy`` — an ``LM`` module holding the reference's
    parameter pytree; ``lm_params_to_numpy`` its inverse, the reference's
    pytree (stacked layers) of a module or of a dict keyed like its
    parameters (the optimizer's moments); ``lm_param_path`` maps one
    parameter name to the reference's ``/``-joined path and layer index,
    the keys of the reference's checkpoints;
  * ``encdec_params_from_numpy`` / ``encdec_params_to_numpy`` — the same for
    the enc-dec model (``models.encdec.EncDec``), whose reference tree
    stacks ``enc_layers`` on ``n_encoder_layers`` and ``dec_layers`` on
    ``n_layers``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.cim.network import NetworkSpec
from .core.cim.profile import ActivationCapture, LayerCapture

__all__ = [
    "capture_from_numpy",
    "capture_inputs_from_numpy",
    "encdec_params_from_numpy",
    "encdec_params_to_numpy",
    "lm_param_path",
    "lm_params_from_numpy",
    "lm_params_to_numpy",
]


def capture_inputs_from_numpy(
    images, weights, spec: NetworkSpec, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """(images (N, H, W, C) float32, weights) on ``device``, checked
    against ``spec``: C is the first layer's ``cin`` and layer i's weight is
    (rows_i, cout_i)."""
    dev = resolve_device(device)
    images = np.array(images, dtype=np.float32)
    cin = spec.layers[0].cin
    if images.ndim != 4 or images.shape[1] != images.shape[2] or images.shape[3] != cin:
        raise ValueError(f"images must be (N, H, H, {cin}), got {images.shape}")
    if len(weights) != len(spec.layers):
        raise ValueError(f"{len(weights)} weights for {len(spec.layers)} layers")
    ws = []
    for w, layer in zip(weights, spec.layers):
        w = np.array(w, dtype=np.float32)
        if w.shape != (layer.rows, layer.cout):
            raise ValueError(
                f"{layer.name}: weight {w.shape} != ({layer.rows}, {layer.cout})"
            )
        ws.append(torch.from_numpy(w).to(dev))
    return torch.from_numpy(images).to(dev), tuple(ws)


def capture_from_numpy(capture, device: str | torch.device = "cuda") -> ActivationCapture:
    """An ``ActivationCapture`` on ``device`` with the fields of ``capture``
    (``network``, ``n_images``, ``sample_patches``, ``seed`` and per layer
    ``name``, ``rowbits``, ``sampled_q``, ``n_patches``,
    ``patches_per_image``)."""
    dev = resolve_device(device)
    layers = []
    for lc in capture.layers:
        q = np.asarray(lc.sampled_q)
        if q.dtype != np.uint8 or q.ndim != 2:
            raise ValueError(f"{lc.name}: sampled_q must be 2-D uint8, got {q.dtype} {q.shape}")
        layers.append(
            LayerCapture(
                name=lc.name,
                rowbits=torch.tensor(np.asarray(lc.rowbits, dtype=np.int64), device=dev),
                sampled_q=torch.tensor(q, device=dev),
                n_patches=int(lc.n_patches),
                patches_per_image=int(lc.patches_per_image),
            )
        )
    return ActivationCapture(
        capture.network,
        int(capture.n_images),
        int(capture.sample_patches),
        int(capture.seed),
        tuple(layers),
    )


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _load_numpy(model, tree, depth: dict):
    """Load the reference's pytree ``tree`` into ``model``: a top-level key
    of ``depth`` carries a leading layer axis of that length, which becomes
    the module list of that name; every other parameter is its own path.
    Every parameter must be present with its shape; values are stored as
    float32."""
    want = model.state_dict()
    got = {}
    for name, arr in _flatten(tree):
        arr = np.asarray(arr, dtype=np.float32)
        head, _, rest = name.partition(".")
        if head in depth and rest:
            if arr.shape[0] != depth[head]:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != {depth[head]} {head}")
            for i in range(depth[head]):
                got[f"{head}.{i}.{rest}"] = arr[i]
        else:
            got[name] = arr
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, unexpected {extra}")
    for name, arr in got.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(want[name].shape)}")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in got.items()})
    return model


def lm_params_from_numpy(tree, cfg, device: str | torch.device = "cuda"):
    """An ``models.lm.LM`` for ``cfg`` on ``device`` holding the reference's
    parameter pytree ``tree`` (nested dicts of arrays, as
    ``repro.models.lm.init_params`` returns them, converted with
    ``np.asarray``): ``tree["layers"]`` carries a leading layer axis, which
    becomes the module list (the MoE family's expert banks too, e.g.
    ``layers.moe.experts.w_up`` of shape (L, n_phys, d, ff)).  Every
    parameter must be present with its shape; values are stored as
    float32."""
    from .models.lm import LM

    return _load_numpy(LM(cfg, None, resolve_device(device)), tree, {"layers": cfg.n_layers})


def encdec_params_from_numpy(tree, cfg, device: str | torch.device = "cuda"):
    """A ``models.encdec.EncDec`` for ``cfg`` on ``device`` holding the
    reference's enc-dec parameter pytree (``repro.models.encdec.
    init_encdec_params``, converted with ``np.asarray``): ``enc_layers``
    stacked on ``n_encoder_layers``, ``dec_layers`` on ``n_layers``."""
    from .models.encdec import EncDec

    model = EncDec(cfg, None, resolve_device(device))
    return _load_numpy(model, tree, {"enc_layers": cfg.n_encoder_layers, "dec_layers": cfg.n_layers})


_STACKED = ("layers", "enc_layers", "dec_layers")


def lm_param_path(name: str) -> tuple[str, int | None]:
    """(the reference's ``/``-joined pytree path, layer index or None) of the
    port's parameter ``name``: ``<stack>.<i>.<rest>`` is layer i of the
    reference's stacked ``<stack>/<rest>`` for the stacks ``layers`` (the
    LM) and ``enc_layers`` and ``dec_layers`` (the enc-dec model), any other
    name its own path."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in _STACKED and parts[1].isdigit():
        return "/".join([parts[0], *parts[2:]]), int(parts[1])
    return "/".join(parts), None


def lm_params_to_numpy(params) -> dict:
    """Inverse of ``lm_params_from_numpy`` and ``encdec_params_from_numpy``:
    the reference's parameter pytree (nested dicts of numpy arrays, each
    stack of ``lm_param_path`` on a leading axis) of an ``LM`` or ``EncDec``
    module or of a dict of tensors keyed like its parameters."""
    from torch import nn

    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    flat: dict = {}
    for name, t in items:
        path, i = lm_param_path(name)
        arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        if i is None:
            flat[path] = arr
        else:
            flat.setdefault(path, {})[i] = arr
    tree: dict = {}
    for path, val in flat.items():
        if isinstance(val, dict):
            if sorted(val) != list(range(len(val))):
                raise ValueError(f"{path}: layers {sorted(val)} are not 0..{len(val) - 1}")
            val = np.stack([val[i] for i in range(len(val))])
        *head, leaf = path.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = val
    return tree


encdec_params_to_numpy = lm_params_to_numpy  # one mapping for both models' names

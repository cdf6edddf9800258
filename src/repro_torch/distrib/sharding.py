"""Sharding rules, and splitting a batched evaluation over the local
devices (reference: ``src/repro/distrib/sharding.py``).

``shard_map_batch`` and ``local_eval_devices`` port the reference's
``shard_map_batch`` and ``local_eval_mesh``, which ``shard_map`` a vmapped
kernel over a 1-D mesh of the host's devices.  Here the mesh is a list of
torch devices, and each device evaluates a contiguous slice of the config
axis.  On a host with one card the list has one entry and sharded
evaluation is the plain path.

The spec half is the reference's rules over a ``DeviceMesh`` (or a
``compat.MeshShape``) with axes ``("data", "model")`` or ``("pod", "data",
"model")``: batch over the DP axes ``("pod", "data")``, weights over
``"model"`` (TP / EP):

  * vocab dims -> 'model' (embed / lm_head); attention q dims -> 'model';
    kv dims -> 'model' only when the kv heads divide the TP degree;
  * MLP ff dims -> 'model' column-, then row-parallel;
  * MoE expert slots -> the EP axes of ``moe_ep_axes``, else each expert's
    ff dim (2-D over ('data', 'model') with ``serve_ff_2d``);
  * Mamba2 head dims -> 'model'; norms, routers, small projections and the
    MoE's shared expert replicated; a dim a spec's axes do not divide is
    left unsharded.

The reference keys its rules on pytree paths (``_leaf_rule``).  The port's
parameters are named ``layers.<i>.attn.wq`` where the reference stacks
``layers/attn/wq`` on a leading layer axis; ``convert.lm_param_path`` maps
one to the other, and a spec here is the reference's without its leading
``None`` for the stack.  ``param_specs`` and ``opt_specs`` return
``{parameter name: P}`` (``opt_specs`` under ``"m"`` and ``"v"``, and
``P()`` for ``"step"``); ``cache_specs`` mirrors the cache dict (its stacked
tensors keep the stack dim, as the reference's do, and the host-int
``len`` has no spec); ``named`` turns specs into DTensor placements and
``distribute`` places a model's parameters.

ZeRO-1 (``opt_specs``) puts the DP axes on the first dim they divide.  The
reference's first dim of a stacked moment is its layer axis; the port has
no layer axis, so where the reference would shard that, the port shards
the first per-layer dim the DP axes divide instead (the same bytes a
device whenever one divides).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..models.config import ModelConfig
from .compat import P, axes_of, mesh_sizes, placements

__all__ = [
    "batch_axes",
    "cache_specs",
    "data_specs",
    "distribute",
    "local_eval_devices",
    "moe_ep_axes",
    "named",
    "opt_specs",
    "param_specs",
    "shard_map_batch",
    "tp_size",
]


def local_eval_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """Every local device of ``device``'s kind: all visible CUDA devices
    for a card, the one host device for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    return [dev]


def shard_map_batch(fn, *, devices=None):
    """Shard a batched-leading-axis function over ``devices``.

    ``fn`` maps tensors with a shared leading config dimension C to a
    tensor (or a tuple of tensors) with the same leading
    dimension, and works on whatever device its inputs lie on (the
    evaluators read the device of their first argument).  The wrapper pads C
    up to a multiple of the device count by repeating row 0 (rows are
    independent, so padding is wasted work, never a wrong answer), hands
    device k its contiguous slice, and gathers every output leaf on the
    first device with the padding removed.  ``devices`` defaults to
    ``local_eval_devices`` of the first argument's device; with one device
    the wrapper calls ``fn`` on the arguments as they are."""

    def wrapped(*args):
        args = tuple(torch.as_tensor(a) for a in args)
        devs = list(devices) if devices is not None else local_eval_devices(args[0].device)
        if len(devs) <= 1:
            return fn(*args)
        C = args[0].shape[0]
        pad = (-C) % len(devs)
        if pad:
            args = tuple(torch.cat([a, a[:1].expand(pad, *a.shape[1:])]) for a in args)
        per = (C + pad) // len(devs)
        outs = []
        for k, dev in enumerate(devs):
            part = tuple(a[k * per : (k + 1) * per].to(dev, non_blocking=True) for a in args)
            outs.append(fn(*part))
        first = devs[0]

        def gather(parts):
            return torch.cat([x.to(first) for x in parts])[:C]

        if isinstance(outs[0], tuple):
            return tuple(gather([o[i] for o in outs]) for i in range(len(outs[0])))
        return gather(outs)

    return wrapped


# ---------------------------------------------------------------- spec rules


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_size(mesh) -> int:
    return mesh_sizes(mesh)["model"]


def _dp_size(mesh) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def moe_ep_axes(cfg: ModelConfig, mesh, seq_len: int = 0) -> tuple[str, ...]:
    """Mesh axes the physical expert slots shard over: the widest EP group
    the slot count divides, ('data', 'model'), then 'model', then 'data';
    () for TP inside each expert.  Expert replication (the paper's
    block-wise duplication) pads the slot count, so it can reach full 2-D
    EP."""
    m = cfg.moe
    if not m.n_experts:
        return ()
    repl = m.replication or tuple([1] * m.n_experts)
    n_phys = int(sum(repl))
    sizes = mesh_sizes(mesh)
    tp = sizes["model"]
    dn = sizes.get("data", 1)
    if n_phys % (dn * tp) == 0:
        return ("data", "model")
    if n_phys % tp == 0:
        return ("model",)
    if n_phys % dn == 0:
        return ("data",)
    return ()


def _leaf_rule(parts: list[str], ndim: int, cfg: ModelConfig, mesh) -> tuple:
    """Spec entries for the unstacked dims of a parameter (the reference's
    ``_leaf_rule``, rule for rule)."""
    tp = tp_size(mesh)
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    nh, nkv, hd = cfg.attn_dims()
    kv_shardable = nkv and (nkv * hd) % tp == 0 and nkv % tp == 0
    ssm_heads = cfg.ssm.n_heads(cfg.d_model) if cfg.family in ("ssm", "hybrid") else 0
    ssm_shardable = ssm_heads and ssm_heads % tp == 0

    if name == "embed":
        return ("model", None)
    if name == "lm_head":
        return (None, "model")
    if name == "scale" or ndim == 1 and name in ("conv_x_b", "gate_norm"):
        if name == "scale" and parent == "gate_norm" and ssm_shardable:
            return ("model",)
        return (None,)
    if parent in ("attn", "cross"):
        if name == "wq":
            return (None, "model")
        if name in ("wk", "wv"):
            return (None, "model") if kv_shardable else (None, None)
        if name == "wo":
            return ("model", None)
        if name == "bq":
            return ("model",)
        if name in ("bk", "bv"):
            return ("model",) if kv_shardable else (None,)
        if name in ("wuq", "wuk", "wuv"):
            return (None, "model")
        if name in ("wdq", "wdkv", "wkr"):
            return (None, None)
    if parent == "experts":
        ep = moe_ep_axes(cfg, mesh)
        if ep:
            return (ep if len(ep) > 1 else ep[0],) + (None,) * (ndim - 1)
        ff = ("data", "model") if cfg.moe.serve_ff_2d and "data" in mesh.mesh_dim_names else "model"
        if name in ("w_up", "w_gate"):
            return (None, None, ff)
        return (None, ff, None)
    if name == "router":
        return (None, None)
    if "shared" in parts:
        return (None,) * ndim
    if name in ("w_up", "w_gate"):
        return (None, "model")
    if name == "w_down":
        return ("model", None)
    if name in ("wz", "wx"):
        return (None, "model") if ssm_shardable else (None, None)
    if name in ("wB", "wC", "wdt"):
        if name == "wdt" and ssm_shardable:
            return (None, "model")
        return (None, None)
    if name == "conv_x_w":
        return (None, "model") if ssm_shardable else (None, None)
    if name in ("conv_B_w", "conv_C_w"):
        return (None, None)
    if name in ("conv_x_b",):
        return ("model",) if ssm_shardable else (None,)
    if name in ("conv_B_b", "conv_C_b"):
        return (None,)
    if name in ("A_log", "D", "dt_bias"):
        return ("model",) if ssm_shardable else (None,)
    if name == "out_proj":
        return ("model", None) if ssm_shardable else (None, None)
    return (None,) * ndim


def _divides(entries, shape, mesh) -> P:
    """``entries`` with every entry whose axes do not divide its dim
    dropped, padded with ``None`` to the tensor's rank."""
    sizes = mesh_sizes(mesh)
    entries = tuple(entries)[: len(shape)]
    entries = entries + (None,) * (len(shape) - len(entries))
    return P(*(e if e is None or shape[i] % math.prod(sizes[a] for a in axes_of(e)) == 0 else None
               for i, e in enumerate(entries)))


def _parts(name: str) -> list[str]:
    from ..convert import lm_param_path

    return lm_param_path(name)[0].split("/")


def param_specs(cfg: ModelConfig, params, mesh) -> dict[str, P]:
    """{parameter name: P} for a model (an ``nn.Module`` or a dict of
    tensors keyed like its parameters)."""
    from ..optim.adamw import named

    return {name: _divides(_leaf_rule(_parts(name), t.dim(), cfg, mesh), tuple(t.shape), mesh)
            for name, t in named(params).items()}


def opt_specs(cfg: ModelConfig, opt_state: dict, mesh) -> dict:
    """The AdamW state's specs: ``m`` and ``v`` as the parameters, plus
    ZeRO-1, the DP axes on the first dim they divide that carries no axis
    yet (module docstring); ``step`` replicated."""
    dp = batch_axes(mesh)
    dp_n = _dp_size(mesh)

    def rule(name, t):
        shape = tuple(t.shape)
        entries = tuple(_leaf_rule(_parts(name), t.dim(), cfg, mesh))[: len(shape)]
        full = list(entries + (None,) * (len(shape) - len(entries)))
        used = {a for e in full for a in axes_of(e)}
        if dp and not used.intersection(dp):
            for i, n in enumerate(shape):
                if full[i] is None and n % dp_n == 0 and n >= dp_n:
                    full[i] = dp
                    break
        return _divides(full, shape, mesh)

    out = {k: {name: rule(name, t) for name, t in opt_state[k].items()} for k in ("m", "v")}
    out["step"] = P()
    return out


_STACKED_CACHE = ("layers", "shared_sites")


def cache_specs(cfg: ModelConfig, cache: dict, mesh) -> dict:
    """Decode-state specs: batch over the DP axes, heads over 'model'; k / v
    whose kv heads do not divide the TP degree shard their sequence dim
    instead (sequence-parallel KV, ``_decode_attn_seq_sharded``)."""
    dp = batch_axes(mesh)
    dp_n = _dp_size(mesh)
    tp = tp_size(mesh)
    _, nkv, _ = cfg.attn_dims()
    kv_ok = nkv and nkv % tp == 0
    ssm_heads = cfg.ssm.n_heads(cfg.d_model) if cfg.family in ("ssm", "hybrid") else 0
    ssm_ok = ssm_heads and ssm_heads % tp == 0

    def rule(group, name, t):
        depth = 1 if group in _STACKED_CACHE else 0
        shape = tuple(t.shape)[depth:]
        bspec = dp if (dp and shape and shape[0] % dp_n == 0) else None
        lead = (None,) * depth
        if name in ("k", "v"):
            full = lead + ((bspec, None, "model", None) if kv_ok else (bspec, "model", None, None))
        elif name == "ckv":
            full = lead + (bspec, None, None)
        elif name == "k_rope":
            full = lead + (bspec, None, None, None)
        elif name == "ssm":
            full = lead + (bspec, "model" if ssm_ok else None, None, None)
        elif name == "conv_x":
            full = lead + (bspec, None, "model" if ssm_ok else None)
        elif name in ("conv_B", "conv_C"):
            full = lead + (bspec, None, None)
        else:
            full = lead + (bspec,) + (None,) * (len(shape) - 1)
        return _divides(full, tuple(t.shape), mesh)

    return {group: {name: rule(group, name, t) for name, t in sub.items() if isinstance(t, torch.Tensor)}
            for group, sub in cache.items()}


def data_specs(mesh, batch: int) -> P:
    """Token batch: the leading dim over every DP axis, when they divide it."""
    dp = batch_axes(mesh)
    if dp and batch % _dp_size(mesh) == 0:
        return P(dp)
    return P()


def named(mesh, tree_of_specs: Any) -> Any:
    """Specs -> DTensor placements (``compat.placements``), tree for tree."""
    if isinstance(tree_of_specs, P):
        return placements(tree_of_specs, mesh)
    return {k: named(mesh, v) for k, v in tree_of_specs.items()}


def _placed(t: torch.Tensor, spec: P, mesh):
    """``t`` (the same full tensor on every rank) as a DTensor placed by
    ``spec``: this rank's shard is a view of ``t`` when the mesh's axes
    divide its dims (a copy only where a view would not be contiguous), as
    ``distribute_tensor`` would place it."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pls = placements(spec, mesh)
    sizes = mesh_sizes(mesh)
    local = t.detach()
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, pls)):
        if pl.is_shard():
            n = sizes[name]
            if local.shape[pl.dim] % n:
                return distribute_tensor(t.detach(), mesh, pls)
            step = local.shape[pl.dim] // n
            local = local.narrow(pl.dim, mesh.get_local_rank(name) * step, step)
    return DTensor.from_local(local.contiguous(), mesh, pls, run_check=False, shape=t.shape, stride=t.stride())


def distribute(tree, specs: dict, mesh):
    """Place ``tree`` on ``mesh`` by ``specs``: every rank holds the same
    full tensors and keeps its shards (``_placed``).  A module has each
    parameter replaced by a DTensor parameter (``requires_grad`` kept) and
    is returned; a dict (a cache, a batch, an optimizer state) is returned
    as a new dict with each tensor that has a spec placed and anything else
    as it was."""
    from torch import nn

    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            setattr(mod, leaf, nn.Parameter(_placed(p, specs[name], mesh), requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) if k in specs else v for k, v in tree.items()}
    return _placed(tree, specs, mesh)

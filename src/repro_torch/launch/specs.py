"""Per-cell inputs and placements for the dry run and the launchers
(reference: ``src/repro/launch/specs.py``).

``build_cell(arch, shape, mesh)`` resolves one (architecture x input shape)
cell into the step to run, its arguments and their placements, and the
cell's useful model FLOPs for the roofline.  Where the reference makes
abstract arrays (``jax.ShapeDtypeStruct``), the arguments here are fake
tensors (``FakeTensorMode``: shapes and types, no storage), each a DTensor
over ``mesh`` placed by ``distrib.sharding``'s specs, whose local tensor is
this rank's shard: parameters (bf16 for the serving cells, as the
reference's ``:96-103``), the AdamW state for training (``opt_specs``), the
token batch (``data_specs``) and, for decode, a full cache (``cache_specs``;
its length set to the sequence less one, so a decode step attends over the
whole cache, as the reference's masked cache computes it).  Tokens are
int32, as the reference's.  Run the cell's ``fn(*args)`` under
``cell.fake_mode`` and ``distrib.compat.auto_region()``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from ..configs import SHAPE_SPECS, get_config
from ..distrib.compat import P, axes_of, mesh_sizes, placements
from ..distrib.sharding import cache_specs, data_specs, opt_specs, param_specs
from ..models import encdec, lm
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig
from ..train.step import (
    make_decode_step,
    make_encdec_decode_step,
    make_encdec_prefill_step,
    make_encdec_train_step,
    make_prefill_step,
    make_train_step,
)

__all__ = ["Cell", "build_cell"]


@dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    fn: Callable
    args: tuple  # fake DTensors (and host ints), this rank's shards
    in_shardings: tuple  # DTensor placements, tree for tree with args
    out_shardings: Any
    model_flops: float
    kind: str
    fake_mode: FakeTensorMode


def _fake(mode: FakeTensorMode, mesh, shape, dtype, spec: P) -> DTensor:
    """A fake DTensor of global ``shape`` placed by ``spec``: its local
    tensor is this rank's shard."""
    sizes = mesh_sizes(mesh)
    local = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in axes_of(entry))
        local[d] = -(-local[d] // n)
    with mode:
        t = torch.empty(local, dtype=dtype)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t, mesh, placements(spec, mesh), run_check=False, shape=tuple(shape),
                              stride=tuple(reversed(stride)))


def _place_model(model: nn.Module, mode, mesh, specs: dict, dtype=None):
    """Each parameter of a meta ``model`` replaced by a fake DTensor of its
    shape (in ``dtype`` when it is float32 and one is given)."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        dt = dtype if (dtype is not None and p.dtype == torch.float32) else p.dtype
        setattr(mod, leaf, nn.Parameter(_fake(mode, mesh, tuple(p.shape), dt, specs[name]), requires_grad=False))
    return model


def _tokens(mode, mesh, b: int, s: int, spec: P) -> DTensor:
    return _fake(mode, mesh, (b, s), torch.int32, spec)


def build_cell(arch: str, shape: str, mesh, opt: AdamWConfig | None = None, smoke: bool = False,
               overrides: dict | None = None) -> Cell:
    from ..distrib.context import set_mesh

    set_mesh(mesh)  # the mesh paths of moe_fwd, gqa_fwd, _constrain_heads
    cfg = get_config(arch, smoke=smoke)
    if overrides:
        cfg = cfg.with_(**overrides)
    spec = SHAPE_SPECS[shape]
    B, S, kind = spec["global_batch"], spec["seq_len"], spec["kind"]
    if smoke:
        B, S = 2, 32
    opt = opt or AdamWConfig()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    enc = cfg.family == "encdec"
    model = encdec.EncDec(cfg, None, "meta") if enc else lm.LM(cfg, None, "meta")
    p_spec = param_specs(cfg, model, mesh)
    serving = kind in ("prefill", "decode")
    p_shapes = {k: (tuple(p.shape), p.dtype) for k, p in model.named_parameters()}
    params = _place_model(model, mode, mesh, p_spec, torch.bfloat16 if serving else None)
    p_pl = {k: list(v.placements) for k, v in params.named_parameters()}
    dspec = data_specs(mesh, B)
    n_active = cfg.active_param_count()
    act = getattr(torch, cfg.dtype)

    def frames():
        return _fake(mode, mesh, (B, cfg.encoder_seq, cfg.d_model), act, dspec)

    if kind == "train":
        shapes = {k: torch.empty(s, dtype=torch.float32, device="meta") for k, (s, _) in p_shapes.items()}
        o_spec = opt_specs(cfg, {"m": shapes, "v": shapes}, mesh)
        with mode:
            step0 = torch.zeros((), dtype=torch.int32)
        opt_state = {k: {n: _fake(mode, mesh, s, torch.float32, o_spec[k][n]) for n, (s, _) in p_shapes.items()}
                     for k in ("m", "v")}
        opt_state["step"] = step0
        batch = {"tokens": _tokens(mode, mesh, B, S, dspec), "targets": _tokens(mode, mesh, B, S, dspec)}
        if enc:
            batch["frames"] = frames()
            fn = make_encdec_train_step(cfg, opt)
        else:
            fn = make_train_step(cfg, opt)
        o_pl = {k: {n: list(t.placements) for n, t in opt_state[k].items()} for k in ("m", "v")}
        args = (params, opt_state, batch)
        in_sh = (p_pl, o_pl, {k: list(v.placements) for k, v in batch.items()})
        return Cell(arch, shape, cfg, fn, args, in_sh, (p_pl, o_pl, None), 6.0 * n_active * B * S, kind, mode)

    if kind == "prefill":
        toks = _tokens(mode, mesh, B, S, dspec)
        if enc:
            fn, args = make_encdec_prefill_step(cfg), (params, frames(), toks)
        else:
            fn, args = make_prefill_step(cfg), (params, toks)
        in_sh = (p_pl,) + tuple(list(a.placements) for a in args[1:])
        return Cell(arch, shape, cfg, fn, args, in_sh, None, 2.0 * n_active * B * S, kind, mode)

    # decode: one new token against a cache of length S, full but the last
    meta_cache = (encdec.init_decoder_cache(cfg, B, S, act, "meta") if enc
                  else lm.init_cache(cfg, B, S, act, "meta"))
    c_spec = cache_specs(cfg, meta_cache, mesh)
    cache = {g: {n: (_fake(mode, mesh, tuple(t.shape), t.dtype, c_spec[g][n]) if isinstance(t, torch.Tensor)
                     else S - 1)
                 for n, t in sub.items()}
             for g, sub in meta_cache.items()}
    c_pl = {g: {n: list(t.placements) for n, t in sub.items() if isinstance(t, DTensor)} for g, sub in cache.items()}
    toks = _tokens(mode, mesh, B, 1, dspec)
    if enc:
        fn, args = make_encdec_decode_step(cfg), (params, cache, frames(), toks)
        in_sh = (p_pl, c_pl, list(args[2].placements), list(toks.placements))
    else:
        fn, args = make_decode_step(cfg), (params, cache, toks)
        in_sh = (p_pl, c_pl, list(toks.placements))
    return Cell(arch, shape, cfg, fn, args, in_sh, (None, c_pl), 2.0 * n_active * B, "decode", mode)

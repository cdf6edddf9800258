"""Training and serving steps (reference: ``src/repro/train/step.py``).

``make_train_step(cfg, opt)``         (params, opt_state, batch)         -> (params, opt_state, metrics)
``make_prefill_step(cfg)``            (params, tokens)                   -> last-position logits
``make_decode_step(cfg)``             (params, cache, tokens)            -> (next token, cache)
``make_encdec_train_step(cfg, opt)``  (params, opt_state, batch)         -> (params, opt_state, metrics)
``make_encdec_prefill_step(cfg)``     (params, frames, tokens)           -> last-position logits
``make_encdec_decode_step(cfg)``      (params, cache, enc_out, tokens)   -> (next token, cache)

PyTorch runs eagerly, so these return plain functions where the reference
returns functions to ``jit``.  A train step is its loss (``lm.loss_fn``, or
``encdec.encdec_loss_fn`` on a batch's ``frames``, ``tokens`` and
``targets``; remat as the model says, K3 / K4 / K5 through their autograd
Functions), ``backward`` and ``adamw_update``: it turns on
``requires_grad`` for its model's parameters while it runs, updates them
and the optimizer state in place, and frees each ``.grad`` after the
update, so serving the same module builds no graph.  A parameter that gets
no gradient is an error, not a zero.

``make_compressed_train_step(cfg, opt, mesh)`` is the reference's
hierarchical reduction: ``(params, opt_state, ef, batch) -> (params,
opt_state, ef, metrics)`` through ``distrib.compat.shard_map`` with the
``pod`` axis manual and ``data`` / ``model`` automatic (DTensors over that
sub-mesh).  Each pod takes the loss of its rows of the batch under
``use_mesh(None)`` and its gradients (reduced in full precision within the
pod by DTensor), adds the error feedback, reduces each gradient across the
pods by ``optim.compress.compressed_psum`` (the int8 ring over the pod
group) and applies AdamW in place.  The int8 scale is per reference leaf:
the layers of a stack (``layers.<i>.<rest>``, the reference's stacked
``layers/<rest>``) are quantised together, one scale and one payload; the loss in the metrics is averaged
over the pods.  The parameters and the optimizer state stay the given
tensors (updated in place), the moments come back replicated over
``pod`` (the reference's out spec ``P()``), and the new error feedback is
returned.  Plain moments or error feedback beside DTensor parameters are
placed as the parameters first.
"""

from __future__ import annotations

import torch

from ..models import encdec, lm
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_update, named

__all__ = [
    "make_compressed_train_step",
    "make_decode_step",
    "make_encdec_decode_step",
    "make_encdec_prefill_step",
    "make_encdec_train_step",
    "make_prefill_step",
    "make_train_step",
]


def _train_step(opt: AdamWConfig, loss_of):
    """One AdamW step on ``loss_of(params, batch)``: metrics ``loss``,
    ``grad_norm`` and ``lr`` are device scalars (nothing is read back)."""

    def train_step(params, opt_state, batch):
        ps = named(params)
        for p in ps.values():
            p.requires_grad_(True)
        try:
            loss = loss_of(params, batch)
            loss.backward()
            grads = {k: p.grad for k, p in ps.items()}
            missing = [k for k, g in grads.items() if g is None]
            if missing:
                raise RuntimeError(f"no gradient reached {missing}")
            params, opt_state, metrics = adamw_update(opt, grads, params, opt_state)
        finally:
            for p in ps.values():
                p.grad = None
                p.requires_grad_(False)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_train_step(cfg: ModelConfig, opt: AdamWConfig):
    """One AdamW step on ``lm.loss_fn`` of ``batch["tokens"]`` and
    ``batch["targets"]``."""
    return _train_step(opt, lambda params, b: lm.loss_fn(params, cfg, b["tokens"], b["targets"]))


class _Swapped:
    """Parameters of ``module`` replaced by ``tensors`` (each made a leaf
    that requires a gradient, sharing its storage) while inside."""

    def __init__(self, module, tensors: dict):
        self.module, self.tensors = module, tensors

    def __enter__(self) -> dict:
        from torch import nn

        self.saved, leaves = {}, {}
        for name, t in self.tensors.items():
            owner, _, leaf = name.rpartition(".")
            mod = self.module.get_submodule(owner) if owner else self.module
            self.saved[name] = (mod, leaf, getattr(mod, leaf))
            leaves[name] = nn.Parameter(t.detach(), requires_grad=True)
            setattr(mod, leaf, leaves[name])
        return leaves

    def __exit__(self, *exc):
        for mod, leaf, old in self.saved.values():
            setattr(mod, leaf, old)
        return False


def _placed_like(tensors: dict, params: dict) -> dict:
    """Plain tensors of a moment or error-feedback dict placed as their
    parameters are (a DTensor parameter's plain state is the whole tensor,
    the same on every rank); placed ones as they are."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(t, p):
        if isinstance(p, DTensor) and not isinstance(t, DTensor):
            return distribute_tensor(t, p.device_mesh, p.placements)
        return t

    return {k: place(t, params[k]) for k, t in tensors.items()}


def _stacks(tensors: dict) -> list[list[str]]:
    """The names of ``tensors`` grouped by the reference's leaf
    (``convert.lm_param_path``): each stack's layers in order, every other
    name alone."""
    from ..convert import lm_param_path

    groups: dict = {}
    for name in tensors:
        path, layer = lm_param_path(name)
        groups.setdefault(path, []).append((-1 if layer is None else layer, name))
    return [[name for _, name in sorted(group)] for group in groups.values()]


def make_compressed_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh):
    """The pod-compressed step (module docstring) over ``mesh``, which has
    a ``pod`` axis."""
    from ..distrib import compat
    from ..distrib.compat import P
    from ..distrib.context import use_mesh
    from ..optim.compress import apply_error_feedback, compressed_psum

    n_pods = compat.mesh_sizes(mesh)["pod"]

    def local_step(params, ps, m, v, step, ef, batch):
        with compat.auto_region():
            with _Swapped(params, ps) as leaves:
                # inside the pod-manual region the context mesh's paths must
                # not name 'pod': data / model still propagate as DTensors
                with use_mesh(None):
                    loss = lm.loss_fn(params, cfg, batch["tokens"], batch["targets"])
                loss.backward()
                grads = {}
                for k, leaf in leaves.items():
                    if leaf.grad is None:
                        raise RuntimeError(f"no gradient reached {k}")
                    g = leaf.grad
                    grads[k] = g.redistribute(g.device_mesh, leaf.placements) if hasattr(g, "placements") else g
            carried = apply_error_feedback(grads, ef)
            group = mesh.get_group("pod")
            reduced, errs = {}, {}
            for names in _stacks(carried):
                # a stack's layers are one reference leaf: one scale, one payload
                r, e = compressed_psum(torch.stack([carried[k] for k in names]), group)
                for k, rk, ek in zip(names, r.unbind(0), e.unbind(0)):
                    reduced[k], errs[k] = rk, ek
            state = {"m": m, "v": v, "step": step}
            _, state, metrics = adamw_update(opt, reduced, ps, state)
            local_loss = loss.detach()
            local_loss = local_loss.to_local() if hasattr(local_loss, "to_local") else local_loss
            metrics = {k: x.to_local() if hasattr(x, "to_local") else x for k, x in metrics.items()}
            metrics["loss"] = compat.psum(local_loss, "pod") / n_pods
        return state["m"], state["v"], state["step"], errs, metrics

    def step(params, opt_state, ef, batch):
        ps = named(params)
        opt_state["m"], opt_state["v"], ef = (_placed_like(t, ps) for t in (opt_state["m"], opt_state["v"], ef))
        run = compat.shard_map(
            lambda pl, m, v, st, e, b: local_step(params, pl, m, v, st, e, b),
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(), P("pod")),
            out_specs=(P(), P(), P(), P(), P()),
            axis_names=frozenset({"pod"}),
        )
        m, v, new_step, new_ef, metrics = run(ps, opt_state["m"], opt_state["v"], opt_state["step"], ef, batch)
        # moments ZeRO-sharded over 'pod' went in gathered: they come back
        # replicated over it, as the reference's out spec P() returns them
        opt_state.update(m=m, v=v, step=new_step.to_local())
        return params, opt_state, new_ef, {k: x.to_local() for k, x in metrics.items()}

    return step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax of the last position's logits; DTensor logits gathered
    along the vocab first (a (b, vocab) row a rank)."""
    last = logits[:, -1, :]
    if hasattr(last, "placements"):
        from torch.distributed.tensor import Replicate

        last = last.redistribute(last.device_mesh, [pl if pl.is_shard(0) else Replicate() for pl in last.placements])
    return torch.argmax(last, dim=-1)


def make_encdec_train_step(cfg: ModelConfig, opt: AdamWConfig):
    """One AdamW step on ``encdec.encdec_loss_fn`` of ``batch["frames"]``,
    ``batch["tokens"]`` and ``batch["targets"]``."""
    return _train_step(opt, lambda params, b: encdec.encdec_loss_fn(params, cfg, b["frames"], b["tokens"],
                                                                    b["targets"]))


def make_encdec_prefill_step(cfg: ModelConfig):
    """Encode the frames, then decode the prompt without a cache: the last
    position's logits."""

    def prefill_step(params, frames, tokens):
        enc = encdec.encode(params, cfg, frames)
        logits, _ = encdec.decode(params, cfg, tokens, enc)
        return logits[:, -1, :]

    return prefill_step


def make_encdec_decode_step(cfg: ModelConfig):
    """One new token against the decoder's cache (written in place) and the
    encoder's output: ``(params, cache, enc_out, tokens (b, 1)) -> (next
    token (b,), cache)``, the greedy argmax of the last logits."""

    def decode_step(params, cache, enc_out, tokens):
        logits, cache = encdec.decode(params, cfg, tokens, enc_out, cache=cache)
        return _greedy(logits), cache

    return decode_step


def make_prefill_step(cfg: ModelConfig):
    """Prefill without a cache: the full prompt's last-position logits."""

    def prefill_step(params, tokens):
        logits, _ = lm.forward(params, cfg, tokens)
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """One new token against a preallocated KV/SSM cache (written in
    place): ``(params, cache, tokens (b, 1)) -> (next token (b,), cache)``,
    the next token the greedy argmax of the last logits."""

    def decode_step(params, cache, tokens):
        logits, cache = lm.forward(params, cfg, tokens, cache=cache)
        return _greedy(logits), cache

    return decode_step

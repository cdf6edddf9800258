"""Partition specs and ``shard_map`` over a ``DeviceMesh``.

The counterpart of the reference's ``src/repro/distrib/compat.py``, which
papers over two spellings of ``jax.shard_map``.  PyTorch has no
``shard_map``; this module gives the port the same construct over
``torch.distributed``:

  ``jax.sharding.PartitionSpec``  -> ``P``: one entry per tensor dim, each
                                     ``None``, an axis name or a tuple of
                                     names (a 1-tuple is its name)
  ``NamedSharding(mesh, spec)``   -> ``placements(spec, mesh)``: a DTensor
                                     placement (``Shard(d)`` / ``Replicate``)
                                     for each mesh dim
  ``shard_map``                   -> ``shard_map(f, mesh=, in_specs=,
                                     out_specs=, axis_names=)``
  ``jax.lax.axis_index`` / ``psum`` / ``pmax`` / ``ppermute`` /
  ``all_to_all``                  -> the same names here, over the process
                                     group of the named axes

``shard_map`` runs ``f`` once per rank on local tensors.  An input DTensor
is redistributed to its spec on the manual axes (those of ``axis_names``,
every axis by default) and handed over as its local shard; a plain tensor
counts as replicated and is sliced.  The axes ``axis_names`` leaves out stay
automatic: inputs go in as DTensors over the sub-mesh of those axes, with
the placements they had there, and DTensor propagates through ``f`` as
GSPMD does in the reference (automatic axes of one rank shard nothing, and
values go in local there).  Outputs come back as DTensors over the whole
mesh: the manual axes from ``out_specs``, the automatic ones from what ``f``
returned (a plain tensor is replicated over them).  A replicated out spec
takes each rank's own value, unchecked, as the reference's
``check_vma=False`` does.

Inside ``f`` the collectives name axes, as the reference's do: ``psum``
(an ``all_reduce``; its gradient passes through, the output being
replicated), ``pmax``, ``ppermute`` (``batch_isend_irecv``, differentiable:
the gradient goes back along the reversed permutation) and ``all_to_all``
(``all_to_all_single``, tiled).  Several axes together use the flattened
sub-mesh's group.  Multi-axis entries must follow the mesh's order of
axes: DTensor shards one tensor dim over several mesh dims major to minor
in mesh order, as JAX does for an entry in that order.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

__all__ = [
    "MeshShape",
    "P",
    "all_to_all",
    "auto_region",
    "axis_index",
    "axis_size",
    "axes_of",
    "mesh_sizes",
    "placements",
    "pmax",
    "ppermute",
    "psum",
    "shard_map",
    "spec_of",
]


class P(tuple):
    """A partition spec: one entry per leading tensor dim (missing trailing
    dims are unsharded).  An entry is ``None``, an axis name or a tuple of
    names; a 1-tuple is stored as its name and an empty one as ``None``, so
    ``P(("data",)) == P("data")``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


class MeshShape:
    """Axis names and sizes without devices or a process group: what the
    spec rules (``distrib.sharding``) read, for meshes this host cannot
    build.  A ``DeviceMesh`` has the same two attributes."""

    def __init__(self, shape: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(int(v) for v in shape.values())

    def size(self) -> int:
        return math.prod(self.shape)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or ``MeshShape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axes_of(entry) -> tuple:
    """The axis names of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    axis that entry d names, ``Replicate()`` elsewhere."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in axes_of(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} must list axes in the mesh's order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {names[i]!r} named twice in {spec!r}")
            out[i] = Shard(dim)
    return out


def spec_of(pls, mesh, ndim: int) -> P:
    """The spec of DTensor placements ``pls`` on ``mesh`` (the inverse of
    ``placements``); a ``Partial`` placement has no spec."""
    entries = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, pls):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
        elif isinstance(pl, Partial):
            raise ValueError(f"a Partial placement on {name!r} has no spec")
    return P(*entries)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


# ---------------------------------------------------------------- regions

_REGION: list = []  # (mesh, manual axes) of the shard_map regions entered


def _region():
    if not _REGION:
        raise RuntimeError("a collective over named axes runs only inside compat.shard_map")
    return _REGION[-1][0]


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(axes) -> int:
    sizes = mesh_sizes(_region())
    return math.prod(sizes[a] for a in _axes(axes))


def axis_index(axes) -> int:
    """This rank's index along ``axes`` (row-major over several)."""
    mesh = _region()
    sizes = mesh_sizes(mesh)
    idx = 0
    for a in _axes(axes):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def _group(axes):
    mesh = _region()
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    # flattening computes on the mesh's own tensor: outside any fake or
    # counting mode the caller runs under
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return mesh[axes]._flatten("_".join(axes)).get_group()


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None  # the sum is replicated: each rank's gradient is its own


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum over the ranks of ``axes`` (``jax.lax.psum``)."""
    if axis_size(axes) == 1:
        return x
    return _PSum.apply(x, _group(axes))


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    """Max over the ranks of ``axes`` (``jax.lax.pmax``; no gradient)."""
    if axis_size(axes) == 1:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=_group(axes))
    return y


def _permute(x: torch.Tensor, group, me: int, perm) -> torch.Tensor:
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, perm):
        ctx.group, ctx.me, ctx.perm = group, me, perm
        return _permute(x, group, me, perm)

    @staticmethod
    def backward(ctx, g):
        # the backward runs outside the region: the group was kept
        return _permute(g, ctx.group, ctx.me, [(d, s) for s, d in ctx.perm]), None, None, None


def ppermute(x: torch.Tensor, axes, perm) -> torch.Tensor:
    """Send to ``dst`` from ``src`` for each pair of ``perm`` along ``axes``
    (``jax.lax.ppermute``); a rank nothing is sent to gets zeros."""
    return _PPermute.apply(x, _group(axes), axis_index(axes), tuple(perm))


def _all_to_all(x: torch.Tensor, group, n: int, split_axis: int, concat_axis: int) -> torch.Tensor:
    chunks = torch.movedim(x, split_axis, 0).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    parts = torch.movedim(out, 0, split_axis).chunk(n, dim=split_axis)
    return torch.cat(parts, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, concat_axis, split_axis)  # the transpose swaps the axes
        return _all_to_all(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, axes, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``x`` cut into n pieces along
    ``split_axis``, piece j to rank j, the pieces received joined along
    ``concat_axis`` in rank order.  Differentiable: the gradient takes the
    transposed exchange."""
    n = axis_size(axes)
    if n == 1:
        return x
    return _AllToAll.apply(x, _group(axes), n, split_axis, concat_axis)


# ---------------------------------------------------------------- shard_map


def _map(spec, tree, fn):
    """``fn(spec, leaf)`` over ``tree``: a ``P`` applies to every leaf below
    it; tuples, lists and dicts of specs follow the tree."""
    if isinstance(spec, P):
        if isinstance(tree, dict):
            return {k: _map(spec, v, fn) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_map(spec, v, fn) for v in tree)
        return fn(spec, tree)
    if isinstance(spec, dict):
        return {k: _map(spec[k], v, fn) for k, v in tree.items()}
    if isinstance(spec, (list, tuple)):
        if len(spec) != len(tree):
            raise ValueError(f"{len(spec)} specs for {len(tree)} values")
        return type(tree)(_map(s, v, fn) for s, v in zip(spec, tree))
    raise TypeError(f"not a spec: {spec!r}")


def shard_map(f, *, mesh, in_specs, out_specs, axis_names=None):
    """``f`` run per rank over ``mesh`` (module docstring)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    manual = names if axis_names is None else tuple(a for a in names if a in axis_names)
    # automatic axes of one rank shard nothing: their values go in as the
    # local tensors they are
    auto = tuple(a for a in names if a not in manual and sizes[a] > 1)
    sub = mesh[auto] if auto else None

    def manual_target(spec, x):
        """Placements for ``x`` on the whole mesh: ``spec`` on the manual
        axes, ``x``'s own on the automatic ones."""
        want = placements(spec, mesh)
        for a in (a for entry in spec for a in axes_of(entry)):
            if a not in manual:
                raise ValueError(f"spec {spec!r} names {a!r}, which is not a manual axis of this shard_map")
        if isinstance(x, DTensor):
            for i, a in enumerate(names):
                if a not in manual and a in auto:
                    want[i] = x.placements[i]
        return want

    def split_shape(shape, spec):
        out = list(shape)
        for d, entry in enumerate(spec):
            n = math.prod(sizes[a] for a in axes_of(entry) if a in manual)
            if out[d] % n:
                raise ValueError(f"dim {d} of size {out[d]} does not divide into {n} shards ({spec!r})")
            out[d] //= n
        return tuple(out)

    def to_local(spec, x):
        if not isinstance(x, torch.Tensor):
            return x
        if isinstance(x, DTensor):
            y = x.redistribute(mesh, manual_target(spec, x))
            # the gradient of an input replicated over a manual axis is the
            # sum of the ranks' gradients (JAX's transpose of an unmapped input)
            grad_pls = [Partial() if (a in manual and isinstance(pl, Replicate)) else pl
                        for a, pl in zip(names, y.placements)]
            local = y.to_local(grad_placements=grad_pls)
            if not auto:
                return local
            shape = split_shape(x.shape, spec)
            pls = [y.placements[names.index(a)] for a in auto]
            return DTensor.from_local(local.contiguous(), sub, pls, run_check=False, shape=shape,
                                      stride=_contiguous_stride(shape))
        manual_target(spec, x)
        for d, entry in enumerate(spec):
            axes = tuple(a for a in axes_of(entry) if a in manual)
            if axes:
                n = math.prod(sizes[a] for a in axes)
                idx = 0
                for a in axes:
                    idx = idx * sizes[a] + mesh.get_local_rank(a)
                step = x.shape[d] // n
                x = x.narrow(d, idx * step, step)
        return x

    def from_local(spec, y):
        if not isinstance(y, torch.Tensor):
            return y
        pls = placements(spec, mesh)
        if isinstance(y, DTensor):
            for a, pl in zip(auto, y.placements):
                pls[names.index(a)] = pl
            local_shape, local = tuple(y.shape), y.to_local()
        else:
            local_shape, local = tuple(y.shape), y
        local = local.contiguous()  # the stride given below is the contiguous one
        shape = list(local_shape)
        for d, entry in enumerate(spec):
            shape[d] *= math.prod(sizes[a] for a in axes_of(entry) if a in manual)
        return DTensor.from_local(local, mesh, pls, run_check=False, shape=tuple(shape),
                                  stride=_contiguous_stride(shape))

    def wrapped(*args):
        local_args = _map(tuple(in_specs), args, to_local)
        _REGION.append((mesh, manual))
        try:
            out = f(*local_args)
        finally:
            _REGION.pop()
        return _map(out_specs, out, from_local)

    return wrapped


@contextlib.contextmanager
def auto_region():
    """DTensor's implicit replication: plain tensors met beside DTensors
    (constants, positions, masks) count as replicated, as JAX treats an
    unsharded array beside sharded ones.  The port's mesh paths run under
    it."""
    with implicit_replication():
        yield

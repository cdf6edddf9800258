"""Pipeline parallelism: the GPipe microbatch schedule over a 'pipe' mesh
axis (reference: ``src/repro/distrib/pipeline.py``).

The paper's layer pipelining maps here directly: stages are the array
groups, microbatches the images streaming through, and the fill / drain
bubble (P-1)/(M+P-1) the pipeline's synchronisation cost.  Stage bounds
come from ``core.alloc.pipeline_stages.partition_stages`` (the paper's
performance-based allocation, ``report_stage_plan``).

Mechanics, as the reference's ``shard_map`` over 'pipe' runs them: every
rank of the 'pipe' group holds its stage's slice of the stacked layer
parameters and runs the reference's tick loop, n_micro + P - 1 ticks of
the Python loop: stage 0 takes the next microbatch, every stage applies
its layers to what it holds, the result is masked to zero outside the
stage's active ticks, and moves one hop right (``compat.ppermute``:
``batch_isend_irecv``, the gradient sent back along the reversed hop); the
last stage banks its results, which return through a masked ``psum``.  The
backward is autograd's through that schedule, as the reference's is AD's:
the reversed permutes are the fill-drain backward pipeline.  The masks are
``torch.where``s, as the reference's ``jnp.where``s, so every tick's permute
is on every rank's backward path and the ranks' sends and receives pair
up.

``stage_fn(stage_params, x)`` must keep x's shape; embedding and head run
outside the pipelined region.  Stage parameters are a dict of tensors
stacked (n_stages, per_stage, ...).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.alloc.pipeline_stages import partition_stages
from . import compat
from .compat import P

__all__ = ["bubble_fraction", "make_pipeline_fn", "report_stage_plan", "stack_stages"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule (the pipelining barrier cost)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def stack_stages(layer_params: dict, costs: np.ndarray, n_stages: int):
    """Slice stacked layer tensors (L, ...) into (n_stages, L/P, ...), in
    the original order (layers are sequential, so stages are contiguous
    ranges; the SPMD schedule needs equal layers a stage).  Returns (stages,
    each stage's summed cost)."""
    L = next(iter(layer_params.values())).shape[0]
    if L % n_stages != 0:
        raise ValueError(f"L={L} must divide n_stages={n_stages} for SPMD PP")
    per = L // n_stages
    stages = {k: a.reshape((n_stages, per) + tuple(a.shape[1:])) for k, a in layer_params.items()}
    loads = np.asarray(costs, dtype=np.float64).reshape(n_stages, per).sum(axis=1)
    return stages, loads


def report_stage_plan(costs: np.ndarray, n_stages: int) -> dict:
    """The SPMD equal split against the optimal contiguous (cost-balanced,
    possibly ragged) partition of the paper's algorithm."""
    costs = np.asarray(costs, dtype=np.float64)
    per = -(-costs.size // n_stages)
    equal = [(i * per, min((i + 1) * per, costs.size)) for i in range(n_stages)]
    ragged = partition_stages(costs, n_stages)

    def bn(st):
        return max(costs[a:b].sum() for a, b in st if b > a)

    return {
        "equal_bottleneck": bn(equal),
        "ragged_bottleneck": bn(ragged),
        "ragged_gain": bn(equal) / bn(ragged),
        "ragged_bounds": ragged,
    }


def make_pipeline_fn(stage_fn: Callable, mesh, n_micro: int):
    """``pipelined(stage_params, xs)`` with ``xs`` (n_micro, mb, ...),
    replicated, and ``stage_params`` stacked (n_stages, ...) over 'pipe';
    returns the outputs (n_micro, mb, ...) as a DTensor replicated over
    the mesh."""
    n_stages = compat.mesh_sizes(mesh)["pipe"]
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]

    def local(stage_params, xs):
        stage_params = {k: a[0] for k, a in stage_params.items()}
        stage = compat.axis_index("pipe")
        dev = xs.device
        first = torch.tensor(stage == 0, device=dev)
        last = torch.tensor(stage == n_stages - 1, device=dev)
        n_t = n_micro + n_stages - 1
        zero = torch.zeros_like(xs[0])
        received = zero
        out_buf = [zero] * n_micro
        for t in range(n_t):
            x_t = xs[t] if t < n_micro else zero
            x_in = torch.where(first, x_t, received)
            y = stage_fn(stage_params, x_in)
            mb_idx = t - stage  # the microbatch this stage works on
            active = torch.tensor(0 <= mb_idx < n_micro, device=dev)
            y = torch.where(active, y, 0.0)
            received = compat.ppermute(y, "pipe", fwd_perm) if n_stages > 1 else zero
            slot = min(max(t - (n_stages - 1), 0), n_micro - 1)
            out_buf[slot] = torch.where(active & last, y, out_buf[slot])
        # only the last stage holds real outputs; spread by a masked psum
        mine = torch.where(last, torch.stack(out_buf), 0.0)
        return compat.psum(mine, "pipe")

    return compat.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("pipe"), P()),
        out_specs=P(),
        axis_names=frozenset({"pipe"}),
    )

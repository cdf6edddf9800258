"""Static cost of one rank's step (reference: ``src/repro/core/hlo_analysis.py``).

The reference parses the post-SPMD HLO text of a compiled step.  The port
has no HLO: ``analyze_step`` runs the step once under a dispatch mode
(with ``FakeTensorMode`` around it, so that nothing is computed or
allocated), one rank of a fake process group standing for every chip, and
counts each aten op as the card would run it on that rank:

  * flops — ``torch.utils.flop_counter``'s formula for each op, on the
    local tensors (a DTensor op returns ``NotImplemented`` to the mode, so
    the mode sees the local ops DTensor turns it into: per-rank counts, as
    the reference's per-device HLO gives);
  * hbm_bytes — input plus output bytes of every aten op that is not a
    view or a collective.  Nothing is fused, so this is an upper bound of
    the HBM traffic the reference's count of fused HLO instructions gives;
  * collective_bytes — the operand bytes of every collective (the c10d
    functional ops DTensor issues and the c10d ops of ``compat``'s
    collectives), by the reference's op names; a send of
    ``batch_isend_irecv`` counts as a collective-permute.

Python loops are unrolled in the trace, so every layer and every tick is
counted once per execution: ``n_while`` is 0 and ``trip_counts`` empty.
``peak_bytes`` is the largest sum of the live outputs of non-view,
non-mutating ops seen during the step (each tracked until it is freed),
beside the step's arguments.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["HloCost", "analyze_step"]


@dataclass(frozen=True)
class HloCost:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    coll_by_op: dict
    coll_count: dict
    n_while: int
    trip_counts: tuple
    peak_bytes: float = 0.0


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _collective(name: str) -> str | None:
    """The reference's name for a collective op, or None."""
    if "wait_tensor" in name or "recv" in name or "barrier" in name:
        return None
    for key, op in (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                    ("all_gather", "all-gather"), ("allgather", "all-gather"),
                    ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
                    ("alltoall", "all-to-all"), ("send", "collective-permute"), ("broadcast", "broadcast")):
        if key in name:
            return op
    return None


def _operand(name: str, args) -> list:
    """The tensors a collective sends: the input, not the output buffer."""
    if "_base_" in name or "into_tensor_coalesced_" in name:  # (output, input, ...)
        return _tensors(args[1])
    return _tensors(args[0])


class _CostMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.propagating = 0  # inside DTensor's propagation of global shapes
        self.flops = 0.0
        self.hbm = 0.0
        self.coll_bytes: dict = {}
        self.coll_count: dict = {}
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def _track(self, out):
        for t in _tensors(out):
            key = id(t)
            if key in self._seen:
                continue
            n = _bytes(t)
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run: its local ops come back here
        out = func(*args, **kwargs)
        if self.propagating:
            return out  # DTensor's propagation of global shapes, not the rank's work
        name = func._overloadpacket.__name__ if hasattr(func, "_overloadpacket") else str(func)
        qual = str(func)
        coll = _collective(qual)
        if coll is not None:
            n = sum(_bytes(t) for t in _operand(qual, args))
            self.coll_bytes[coll] = self.coll_bytes.get(coll, 0) + n
            self.coll_count[coll] = self.coll_count.get(coll, 0) + 1
            return out
        if "c10d" in qual or func.is_view or name in ("detach", "lift_fresh"):
            return out
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.hbm += sum(_bytes(t) for t in _tensors((args, kwargs))) + sum(_bytes(t) for t in _tensors(out))
        if not func._schema.is_mutable:
            self._track(out)
        return out


@contextlib.contextmanager
def _propagation_marked(mode: _CostMode):
    """While DTensor derives an op's output metadata it runs the op on fake
    tensors of the global shapes; mark that call so the mode skips it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *args, **kwargs):
        mode.propagating += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            mode.propagating -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def analyze_step(fn, *args, **kwargs):
    """(fn's result, ``HloCost`` of one rank's run of ``fn(*args,
    **kwargs)``); run it inside the ``FakeTensorMode`` its arguments were
    made in.  DTensor runs each op once on fake tensors of the global shapes
    to propagate its metadata (``ShardingPropagator``), which no rank
    computes: those calls are not counted."""
    mode = _CostMode()
    with _propagation_marked(mode), mode:
        out = fn(*args, **kwargs)
    cost = HloCost(
        flops=float(mode.flops),
        hbm_bytes=float(mode.hbm),
        collective_bytes=float(sum(mode.coll_bytes.values())),
        coll_by_op=dict(mode.coll_bytes),
        coll_count=dict(mode.coll_count),
        n_while=0,
        trip_counts=(),
        peak_bytes=float(mode.peak),
    )
    return out, cost

"""Splitting a batched evaluation over the local devices.

Ported from the reference ``distrib/sharding.py``'s ``shard_map_batch`` and
``local_eval_mesh``, which ``shard_map`` a vmapped kernel over a 1-D mesh of
the host's devices.  Here the mesh is a list of torch devices, and each
device evaluates a contiguous slice of the config axis.  On a host with one
card the list has one entry and sharded evaluation is the plain path.
"""

from __future__ import annotations

import torch

__all__ = ["local_eval_devices", "shard_map_batch"]


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

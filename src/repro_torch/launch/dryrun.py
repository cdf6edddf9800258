"""Production-mesh dry run: one rank's step of every (architecture x input
shape x mesh) cell, traced without a card, and its roofline terms
(reference: ``src/repro/launch/dryrun.py``).

Where the reference lowers and compiles each cell for 512 host devices,
this runs one rank of a ``fake`` process group of ``chips`` ranks (the
backend of ``torch.testing._internal.distributed.fake_pg``, which ships
with PyTorch; ``chip_smoke.py`` runs two cells on the card's installation,
so its presence there is checked each run).  The mesh is the production
one (``launch.mesh``), the cell's arguments are fake tensors placed by the
specs (``launch.specs``), and the step runs under ``FakeTensorMode`` on
host-device fake tensors: the kernel wrappers take their plain versions, so
nothing can launch, and the count (``core.hlo_analysis.analyze_step``) is
the arithmetic the reference's HLO holds.  This shows without hardware that
the placements are coherent: a placement DTensor cannot propagate, a
collective the mesh lacks or a shape that does not divide fails here.

The JSON record keeps the reference's keys; ``memory`` gives one rank's
argument and output bytes (its shards), ``peak_bytes`` the arguments plus
the largest sum of live op outputs during the step, and ``temp_bytes`` the
peak less the arguments; ``lower_s`` / ``compile_s`` become ``trace_s``.
Its roofline is priced on one H100's data sheet (``core.roofline``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out dr.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import ARCH_IDS, SHAPES, cell_is_defined
from ..core import roofline as rl
from ..core.hlo_analysis import analyze_step
from ..distrib.compat import auto_region
from ..distrib.context import set_mesh
from .mesh import make_production_mesh
from .specs import build_cell

__all__ = ["fake_group", "main", "run_cell", "shard_bytes"]


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` process group of ``world`` ranks, this process rank 0,
    destroyed on exit.  Refuses to replace a group already running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the dry run needs its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shard_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (a module's
    parameters, dicts, tuples)."""
    def tensors(x):
        if isinstance(x, torch.nn.Module):
            return list(x.parameters())
        if isinstance(x, (dict, list, tuple)):
            return [t for v in (x.values() if isinstance(x, dict) else x) for t in tensors(v)]
        return [x]

    total = 0
    for t in tensors(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if isinstance(t, DTensor) else t
            total += local.numel() * local.element_size()
    return total


def run_cell(arch: str, shape: str, *, multi_pod: bool = False, verbose: bool = True,
             overrides: dict | None = None) -> dict:
    ok, reason = cell_is_defined(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod, "status": "skipped", "reason": reason}
    chips = 512 if multi_pod else 256
    with fake_group(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        t0 = time.perf_counter()
        try:
            cell = build_cell(arch, shape, mesh, overrides=overrides)
            with cell.fake_mode, auto_region():
                out, cost = analyze_step(cell.fn, *cell.args)
        finally:
            set_mesh(None)
        t_trace = time.perf_counter() - t0
        arg_bytes = shard_bytes(cell.args)
        out_bytes = shard_bytes(out)
    roof = rl.analyze(cost, chips=chips, model_flops=cell.model_flops)
    st = rl.collective_stats(cost)
    rec = {
        "arch": arch,
        "shape": shape,
        "multi_pod": multi_pod,
        "chips": chips,
        "status": "ok",
        "kind": cell.kind,
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": int(cost.peak_bytes),
            "peak_bytes": arg_bytes + int(cost.peak_bytes),
        },
        "roofline": roof.as_dict(),
        "collectives": {"bytes": st.bytes_by_op, "count": st.count_by_op},
    }
    if verbose:
        bpd = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
        print(
            f"[{arch} x {shape} x {'multi' if multi_pod else 'single'}-pod] OK  "
            f"trace={t_trace:.1f}s  bytes/dev={bpd / 1e9:.2f}GB  "
            f"flops={roof.flops:.3e}  coll={roof.collective_bytes:.3e}B  "
            f"bottleneck={roof.bottleneck}  roofline_frac={roof.roofline_fraction:.3f}",
            flush=True,
        )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=SHAPES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"], default="off")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]
    cells = [(a, s) for a in ARCH_IDS for s in SHAPES] if args.all else [(args.arch, args.shape)]
    records, failures = [], 0
    for arch, shape in cells:
        for mp in pods:
            try:
                rec = run_cell(arch, shape, multi_pod=mp)
            except Exception as e:  # noqa: BLE001 — one cell's failure is reported, the rest run
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "multi_pod": mp, "status": "failed",
                       "error": f"{type(e).__name__}: {e}"}
                failures += 1
                print(f"[{arch} x {shape} x mp={mp}] FAILED: {e}", flush=True)
            records.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {len(records)} records -> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

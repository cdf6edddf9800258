"""End-to-end trainer: the fault-tolerant runner over the train step, with
checkpoints in the reference's format (reference:
``src/repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --steps 20 --smoke [--device cpu] [--ckpt DIR] [--resume]

It runs on the card unless ``--device cpu`` is given, and raises without
one.  The flags are the reference's, plus ``--device``; ``--arch`` defaults
to glm4-9b.  Parameters are random, from a ``torch.Generator`` seeded with
0; the data is ``SyntheticLM`` (seed 0), AdamW with warmup 5 and the run's
step count as its total.  The enc-dec arch is refused as the reference
refuses it (``python -m repro_torch.examples.whisper_train`` trains it).
The last line is the reference's JSON summary.

Without ``--production-mesh`` the step runs on one device, with no mesh.
With it, the reference's program: the (16, 16) ("data", "model") mesh
(``launch.mesh.make_production_mesh``), the parameters placed by
``param_specs``, the AdamW state by ``opt_specs`` (ZeRO-1) and each batch
by ``data_specs`` as DTensors (the reference's jit in / out shardings), the
step under ``distrib.compat.auto_region``.  It needs 256 ranks, one a card:

  torchrun --nnodes 16 --nproc-per-node 16 ... -m repro_torch.launch.train \
      --arch glm4-9b --production-mesh

(``torchrun`` sets the rendezvous; each rank joins an NCCL group, or gloo
with ``--device cpu``, and takes the card of its local rank).  In one
process without ``torchrun`` it raises from ``make_production_mesh``,
naming the world size it found.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from .. import resolve_device
from ..configs import ARCH_IDS, get_config
from ..data.pipeline import DataConfig, SyntheticLM
from ..models import lm
from ..optim.adamw import AdamWConfig, adamw_init
from ..runtime.fault import RunnerConfig, TrainRunner
from ..train.step import make_train_step

__all__ = ["fingerprint", "main"]


def fingerprint(cfg) -> str:
    return f"{cfg.name}/L{cfg.n_layers}/d{cfg.d_model}/v{cfg.vocab}"


def _production_mesh(dev: torch.device):
    """The (16, 16) mesh over the ranks ``torchrun`` started (joining their
    group first: NCCL on cards, gloo on the host); raises, naming the world
    size, in a group of another size or without one."""
    import torch.distributed as dist

    from .mesh import make_production_mesh

    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_production_mesh(device=dev.type)


def _placed(cfg, mesh, params, opt_state, step_fn, batch_fn, batch: int):
    """The reference's in / out shardings as DTensor placements: the
    parameters by ``param_specs``, the AdamW state by ``opt_specs``, each
    batch by ``data_specs``; the step under ``auto_region``."""
    from ..distrib import compat
    from ..distrib.context import set_mesh
    from ..distrib.sharding import data_specs, distribute, opt_specs, param_specs

    set_mesh(mesh)
    o_spec = opt_specs(cfg, opt_state, mesh)
    params = distribute(params, param_specs(cfg, params, mesh), mesh)
    opt_state = {"m": distribute(opt_state["m"], o_spec["m"], mesh),
                 "v": distribute(opt_state["v"], o_spec["v"], mesh), "step": opt_state["step"]}
    dspec = data_specs(mesh, batch)

    def step(p, o, b):
        with compat.auto_region():
            return step_fn(p, o, b)

    return params, opt_state, step, lambda s: distribute(batch_fn(s), {"tokens": dspec, "targets": dspec}, mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="glm4-9b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        raise SystemExit("use python -m repro_torch.examples.whisper_train for the enc-dec arch")
    dev = resolve_device(args.device)
    mesh = _production_mesh(dev) if args.production_mesh else None
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    opt = AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps)
    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = adamw_init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch), device=dev)
    step_fn, batch_fn = make_train_step(cfg, opt), data.batch
    if mesh is not None:
        params, opt_state, step_fn, batch_fn = _placed(cfg, mesh, params, opt_state, step_fn, batch_fn, args.batch)
    runner = TrainRunner(
        RunnerConfig(ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every),
        step_fn,
        batch_fn,
        fingerprint=fingerprint(cfg),
    )
    start = 0
    if args.resume:
        restored_step, tree = runner._restore(params, opt_state)
        if tree is not None:
            params, opt_state = tree["params"], tree["opt"]
            start = restored_step
            print(f"resumed from step {start}")
    t0 = time.time()
    params, opt_state = runner.run(params, opt_state, args.steps, start)
    dt = time.time() - t0

    losses = [h.metrics.get("loss", float("nan")) for h in runner.history]
    print(
        json.dumps(
            {
                "arch": cfg.name,
                "steps": len(runner.history),
                "first_loss": losses[0] if losses else None,
                "last_loss": losses[-1] if losses else None,
                "wall_s": round(dt, 1),
                "restores": runner.restores,
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

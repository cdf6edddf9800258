"""Enc-dec (Whisper-family) training example: stub audio frontend, synthetic
paired (frames -> tokens) data, a few fault-tolerant steps (reference:
``examples/whisper_train.py``).

  PYTHONPATH=src python -m repro_torch.examples.whisper_train --steps 10 [--ckpt DIR] [--device cpu]

The SMOKE config, AdamW (lr 1e-3, warmup 2), ``make_encdec_train_step``
under ``TrainRunner`` with a checkpoint every 5 steps; it prints the first
and last loss as one JSON line and fails if the loss did not fall.  It runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..models import encdec
from ..optim.adamw import AdamWConfig, adamw_init
from ..runtime.fault import RunnerConfig, TrainRunner
from ..train.step import make_encdec_train_step


def synth_batch(cfg, step, batch=2, seq=24, device="cuda"):
    """Frames carry a per-example bias; targets encode that bias — a
    learnable audio->token mapping.  The reference's numbers (numpy
    ``default_rng(step)``), as tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(step)
    cls = rng.integers(0, 8, size=(batch,))
    frames = rng.normal(0, 1, size=(batch, cfg.encoder_seq, cfg.d_model)) * 0.1
    frames += cls[:, None, None] * 0.3
    toks = np.stack([np.full((seq + 1,), 5 + c, dtype=np.int64) for c in cls])
    return {
        "frames": torch.tensor(frames, dtype=torch.float32, device=dev),
        "tokens": torch.tensor(toks[:, :-1], device=dev),
        "targets": torch.tensor(toks[:, 1:], device=dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_whisper"))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("whisper-medium", smoke=True)
    dev = resolve_device(args.device)
    params = encdec.init_encdec_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=args.steps)
    opt_state = adamw_init(params)
    runner = TrainRunner(
        RunnerConfig(ckpt_dir=args.ckpt, ckpt_every=5),
        make_encdec_train_step(cfg, opt),
        lambda s: synth_batch(cfg, s, device=dev),
        fingerprint="whisper-smoke",
    )
    runner.run(params, opt_state, args.steps)
    losses = [h.metrics["loss"] for h in runner.history]
    print(json.dumps({"first": round(losses[0], 3), "last": round(losses[-1], 3)}))
    if not losses[-1] < losses[0]:
        raise SystemExit("enc-dec did not learn the synthetic mapping")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Batched serving loop: prefill a batch of prompts with the cache, then
decode greedily against it (reference: ``src/repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --batch 4 --prompt-len 32 --gen 16 [--smoke] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises without
one.  ``--arch`` defaults to glm4-9b, as the reference's does.  Families
``dense``, ``moe`` (DeepSeek-V2 with MLA, Grok-1 with GQA), ``ssm`` and
``hybrid`` are ported; the enc-dec arch is refused here as the reference
refuses it (it runs through ``models.encdec`` and
``repro_torch.examples.whisper_train``).  One device, so there is no mesh: the MoE runs the reference's
local path.

``setup``, ``prefill`` and ``decode`` are the loop's three stages, for
callers that time them.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import resolve_device
from ..configs import ARCH_IDS, get_config
from ..models import lm
from ..models.config import ModelConfig
from ..train.step import make_decode_step

__all__ = ["decode", "main", "prefill", "setup"]


def setup(cfg: ModelConfig, batch: int, prompt_len: int, gen: int, device="cuda", seed: int = 0):
    """(params, cache, prompts): random parameters and prompts from one
    ``torch.Generator`` seeded with ``seed`` on ``device``, and an empty
    cache for ``prompt_len + gen`` positions."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(cfg, generator=g, device=dev)
    cache = lm.init_cache(cfg, batch, prompt_len + gen, device=dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g, device=dev)
    return params, cache, prompts


def prefill(params, cfg: ModelConfig, prompts, cache):
    """One forward of the whole prompt with the cache -> (first generated
    token (b,), logits (b, s, vocab), cache)."""
    logits, cache = lm.forward(params, cfg, prompts, cache=cache)
    return torch.argmax(logits[:, -1, :], dim=-1), logits, cache


def decode(params, cfg: ModelConfig, cache, tok, steps: int):
    """``steps`` greedy decode steps from token ``tok`` (b,) -> the tokens
    (b, steps) and the cache."""
    decode_step = make_decode_step(cfg)
    out = []
    for _ in range(steps):
        tok, cache = decode_step(params, cache, tok[:, None])
        out.append(tok)
    toks = torch.stack(out, dim=1) if out else tok.new_zeros((tok.shape[0], 0))
    return toks, cache


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="glm4-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        raise SystemExit("the enc-dec arch is served through repro_torch.models.encdec (encode, decode) and trained by "
                         "python -m repro_torch.examples.whisper_train")
    dev = resolve_device(args.device)
    with torch.inference_mode():
        params, cache, prompts = setup(cfg, args.batch, args.prompt_len, args.gen, dev)
        _sync(dev)
        t0 = time.time()
        tok, _, cache = prefill(params, cfg, prompts, cache)
        _sync(dev)
        prefill_s = time.time() - t0

        t0 = time.time()
        rest, cache = decode(params, cfg, cache, tok, args.gen - 1)
        _sync(dev)
        decode_s = time.time() - t0
    gen = torch.cat([tok[:, None], rest], dim=1)
    print(
        json.dumps(
            {
                "arch": cfg.name,
                "batch": args.batch,
                "prefill_s": round(prefill_s, 3),
                "decode_tok_per_s": round(args.batch * (args.gen - 1) / max(decode_s, 1e-9), 1),
                "sample": gen[0, :8].tolist(),
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

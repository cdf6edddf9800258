#!/usr/bin/env python3
"""Decode with the RoPE frequencies kept on the card against decode with
them copied from the host at every call, in one process on one CUDA card.

    python3 chip_decode_rope.py

``models.layers.apply_rope`` keeps its frequencies on the device
(``_rope_freqs_on``, made once per device); before, it copied them from
pageable host memory at every call, which synchronises the stream twice a
layer.  For Zamba2-1.2B and the three dense models at full width, served as
``chip_smoke.py`` serves them (4 prompts of 1024 tokens, 31 greedy decode
steps), this times the decode by CUDA events in turns: kept, copied, kept,
copied, kept, copied, each after a prefill into a fresh cache.  The copy is
brought back by swapping ``_rope_freqs_on`` within this script; the package
has no switch.  Prints the card's name and power limit, then the ms and
tokens/s of every turn, then one JSON object with the same numbers.
"""

import json
import sys
import time
from pathlib import Path

from chip_smoke import DENSE, DENSE_ARCHS, ZAMBA, check, gpu_line

TURNS = ("card", "host") * 3


def decode_turns(arch, batch, prompt_len, gen):
    import torch

    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config(arch)
    dev = torch.device("cuda")
    params, _, prompts = serve.setup(cfg, batch, prompt_len, gen, device=dev, seed=0)
    kept = layers._rope_freqs_on
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ms = {"card": [], "host": []}
    with torch.inference_mode():
        for turn in ("card",) + TURNS:  # the first is a warm-up
            cache = lm.init_cache(cfg, batch, prompt_len + gen, device=dev)
            tok, _, cache = serve.prefill(params, cfg, prompts, cache)
            torch.cuda.synchronize()
            if turn == "host":
                layers._rope_freqs_on = lambda hd, theta, device: torch.tensor(
                    layers.rope_freqs(hd, theta), dtype=torch.float32, device=device)
            try:
                ev[0].record()
                rest, _ = serve.decode(params, cfg, cache, tok, gen - 1)
                ev[1].record()
                ev[1].synchronize()
            finally:
                layers._rope_freqs_on = kept
            check(tuple(rest.shape) == (batch, gen - 1), f"{arch}: tokens {tuple(rest.shape)}")
            ms[turn].append(ev[0].elapsed_time(ev[1]))
    for turn in ms:
        ms[turn] = ms[turn][1:] if turn == "card" else ms[turn]
    del params, cache
    torch.cuda.empty_cache()
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_rope: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    gpu = gpu_line()
    print(gpu)
    _build.build("zskip_matmul", "flash_attention", "ssd_chunk")
    out = {}
    for arch, dims in (("zamba2-1.2b", ZAMBA),) + tuple((a, DENSE) for a in DENSE_ARCHS):
        t0 = time.perf_counter()
        ms = decode_turns(arch, **dims)
        steps = dims["batch"] * (dims["gen"] - 1)
        out[arch] = {turn: [{"ms": x, "tok_per_s": steps / (x * 1e-3)} for x in xs] for turn, xs in ms.items()}
        for turn, xs in ms.items():
            print(f"{gpu}: {arch} decode {dims['gen'] - 1} steps x {dims['batch']}, RoPE frequencies "
                  f"{'kept on the card' if turn == 'card' else 'copied from the host at every call'}: "
                  + ", ".join(f"{x:.3f} ms = {steps / (x * 1e-3):.1f} tok/s" for x in xs))
        print(f"{arch}: {time.perf_counter() - t0:.1f} s with setup")
    print(json.dumps({"gpu": gpu, "decode": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

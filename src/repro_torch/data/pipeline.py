"""Deterministic synthetic token pipeline (reference:
``src/repro/data/pipeline.py``).

The tokens are made with numpy exactly as the reference makes them, so
they equal the reference's bit for bit for every (seed, step, shard):
Zipfian draws with repeating motifs (learnable structure), seeded by
``SeedSequence([seed, step, shard])`` so that a resumed run replays the
stream without stored cursor state.  A batch is ``{"tokens", "targets"}``,
int64 tensors on the pipeline's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from .. import resolve_device

__all__ = ["DataConfig", "SyntheticLM", "batch_for_step"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 16
    motif_count: int = 64


class SyntheticLM:
    """Zipfian tokens with injected repeating motifs, on ``device`` (the
    card by default; it raises without one)."""

    def __init__(self, cfg: DataConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        # frozen motif table: short phrases the model can memorize
        self.motifs = rng.integers(0, cfg.vocab, size=(cfg.motif_count, cfg.motif_len), dtype=np.int32)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self.probs = probs / probs.sum()

    def tokens(self, step: int, shard: int = 0, n_shards: int = 1) -> np.ndarray:
        """The (batch_local, seq + 1) int32 tokens of ``step``, deterministic
        in (seed, step, shard)."""
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global_batch {cfg.global_batch} does not split into {n_shards} shards")
        b_local = cfg.global_batch // n_shards
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, shard]))
        toks = rng.choice(cfg.vocab, size=(b_local, cfg.seq_len + 1), p=self.probs).astype(np.int32)
        # overwrite random spans with motifs (predictable continuations)
        n_spans = cfg.seq_len // (cfg.motif_len * 4)
        for i in range(b_local):
            for _ in range(max(n_spans, 1)):
                m = rng.integers(0, cfg.motif_count)
                pos = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len)
                toks[i, pos : pos + cfg.motif_len] = self.motifs[m]
        return toks

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """One batch for ``step``: tokens and next-token targets, (batch_local,
        seq) int64 on the device.  Resume = call with the resumed step."""
        toks = torch.from_numpy(self.tokens(step, shard, n_shards).astype(np.int64))
        return {"tokens": toks[:, :-1].to(self.device), "targets": toks[:, 1:].to(self.device)}

    def stream(self, start_step: int = 0, shard: int = 0, n_shards: int = 1) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step, shard, n_shards)
            step += 1


def batch_for_step(cfg: DataConfig, step: int, device: str | torch.device = "cuda") -> dict:
    """Convenience single-host accessor (examples / tests)."""
    return SyntheticLM(cfg, device).batch(step)

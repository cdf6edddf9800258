"""Inputs made from ``--seed``: derived seeds, and the calibration images
and conv weights, drawn on the device by a ``torch.Generator`` in a few
large calls and handed, the same, to the program and to the reference."""

from __future__ import annotations

import zlib

import numpy as np

__all__ = ["derive_seed", "make_inputs"]


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the purpose ``tags`` (strings or ints) under the
    run's ``seed`` (any nonnegative integer)."""
    words = [int(seed)] + [zlib.crc32(t.encode()) if isinstance(t, str) else int(t) % 2**32 for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_inputs(config: dict, n_images: int, seed: int, device):
    """(images (N, H, W, C) float32, [weights (rows, cout) float32]) on
    ``device``: smooth random fields (8x8 noise, bicubic to the input size)
    plus N(0, 0.08^2) noise, each image scaled to [0, 1]; Kaiming-normal
    weights N(0, 2 / rows), one draw for every layer."""
    import torch
    import torch.nn.functional as F

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, "inputs"))
    hw, ch = int(config["image_hw"]), int(config["channels"])
    coarse = torch.rand((n_images, ch, 8, 8), generator=gen, device=dev)
    smooth = F.interpolate(coarse, size=(hw, hw), mode="bicubic", align_corners=False)
    noisy = smooth + 0.08 * torch.randn((n_images, ch, hw, hw), generator=gen, device=dev)
    lo = noisy.amin(dim=(1, 2, 3), keepdim=True)
    hi = noisy.amax(dim=(1, 2, 3), keepdim=True)
    images = ((noisy - lo) / (hi - lo + 1e-9)).permute(0, 2, 3, 1).contiguous()
    shapes = [(int(l["kernel"]) ** 2 * int(l["cin"]), int(l["cout"])) for l in config["layers"]]
    flat = torch.randn(sum(r * c for r, c in shapes), generator=gen, device=dev, dtype=torch.float32)
    weights, off = [], 0
    for r, c in shapes:
        weights.append(flat[off : off + r * c].view(r, c) * float(np.sqrt(2.0 / r)))
        off += r * c
    return images, tuple(weights)

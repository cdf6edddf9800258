"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines ``FULL`` (the exact published config) and ``SMOKE`` (a
reduced same-family config for CPU tests).  The CIM workloads of the paper
itself (ResNet18 / VGG11) live in ``cim_resnet18.py`` / ``cim_vgg11.py``.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = (
    "nemotron-4-15b",
    "glm4-9b",
    "qwen1.5-110b",
    "qwen2.5-32b",
    "mamba2-370m",
    "deepseek-v2-236b",
    "grok-1-314b",
    "qwen2-vl-2b",
    "whisper-medium",
    "zamba2-1.2b",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

SHAPE_SPECS = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}


def _module(arch: str):
    return importlib.import_module(f".{arch.replace('-', '_').replace('.', '_')}", __package__)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = _module(arch)
    return mod.SMOKE if smoke else mod.FULL


def cell_is_defined(arch: str, shape: str) -> tuple[bool, str]:
    """Whether a (arch, shape) dry-run cell runs, and the skip reason if not."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention at 524k tokens — skipped per brief (sub-quadratic archs only)"
    return True, ""

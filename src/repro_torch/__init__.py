"""PyTorch and CUDA port of the CIM array-utilization stack.

The JAX package ``repro`` is the reference; this package runs the same
pipeline on an NVIDIA Hopper card: profile (``capture_activations`` ->
``derive_profile``), allocate (``allocate``, ``greedy_allocate_batch``) and
evaluate (``simulate``, ``BatchSimulator``, ``dse.run_batch``), and the
fused design-space sweep (``dse.run_fused_sweep`` -> ``dse.FusedPipeline``),
which derives every ADC variant's cycle banks from one capture and
allocates + evaluates every config.  Two CUDA C++ kernels carry it: K1, the
bit-plane popcount behind ``derive_profile`` and the sweep's cycle banks
(``kernels.bitplane_profile``), and K2, the fused greedy allocate + eval
behind ``FusedPipeline(engine="kernel")`` (``kernels.fused_alloc_eval``).

It imports torch and numpy only: never jax and nothing of ``repro``.

Entry points that make tensors from host inputs take ``device=`` and default
to ``"cuda"``; they raise when no card is present, so a run on the host asks
for ``device="cpu"`` explicitly.  Functions that take a capture or a profile
run on the device that its tensors lie on.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, raising when a CUDA device is asked for and
    none is present (there is no silent fallback to the host)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host"
        )
    return dev


# defined above the re-exports: the submodules import ``resolve_device``
from .core.cim import (  # noqa: E402
    DEFAULT_ARRAY,
    POLICIES,
    ActivationCapture,
    Allocation,
    ArrayConfig,
    BatchSimulator,
    NetworkProfile,
    allocate,
    capture_activations,
    derive_profile,
    profile_network,
    resnet18_imagenet,
    run_policy,
    simulate,
    vgg11_cifar10,
    vit_b16_imagenet,
)

__all__ = [
    "resolve_device",
    "DEFAULT_ARRAY",
    "POLICIES",
    "ActivationCapture",
    "Allocation",
    "ArrayConfig",
    "BatchSimulator",
    "NetworkProfile",
    "allocate",
    "capture_activations",
    "derive_profile",
    "profile_network",
    "resnet18_imagenet",
    "run_policy",
    "simulate",
    "vgg11_cifar10",
    "vit_b16_imagenet",
]

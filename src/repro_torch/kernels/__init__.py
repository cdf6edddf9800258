"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

K1 ``bitplane_profile``: CUDA C++ (``csrc/bitplane_profile.cu``).
K2 ``fused_alloc_eval``: CUDA C++ (``csrc/fused_alloc_eval.cu``).
Both are built with nvcc on first use (``_build``).  No kernel is built or
loaded at import.
"""

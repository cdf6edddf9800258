"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

K1 ``bitplane_profile``: CUDA C++ (``csrc/bitplane_profile.cu``), built
with nvcc on first use (``_build``).  No kernel is built or loaded at
import.
"""

"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

K1 ``bitplane_profile``: CUDA C++ (``csrc/bitplane_profile.cu``).
K2 ``fused_alloc_eval``: CUDA C++ (``csrc/fused_alloc_eval.cu``).
K3 ``zskip_matmul``: CUDA C++ (``csrc/zskip_matmul.cu``).
K4 ``flash_attention``: CUDA C++ (``csrc/flash_attention.cu``).
K5 ``ssd_scan``: CUDA C++ (``csrc/ssd_chunk.cu``).
VT ``vtime_scan``: CUDA C++ (``csrc/vtime_scan.cu``), the fabric's
virtual-time scan; no Pallas kernel of the reference, the counterpart of its
jitted ``lax.scan``.
The draw ``service_draw``: CUDA C++ (``csrc/service_draw.cu``), the fabric's
service-sample indices drawn on the card, numpy's stream bit for bit; no
Pallas kernel of the reference (it draws them with numpy on the host).
All are built with nvcc on first use (``_build``); ``ops`` wraps K3, K4 and
K5 for the models.  No kernel is built or loaded at import.
"""

"""The reference's oracles for every Pallas kernel, by its names
(reference: ``src/repro/kernels/ref.py``): each is the plain PyTorch version
the kernel's module keeps beside its CUDA kernel, the allclose target of
the tests.

  ``block_mask_ref``, ``zskip_matmul_ref`` -> ``kernels.zskip_matmul`` (K3)
  ``flash_attention_ref``                  -> ``kernels.flash_attention`` (K4)
  ``ssd_chunk_ref``                        -> ``kernels.ssd_scan`` (K5)
"""

from __future__ import annotations

from .flash_attention import flash_attention_ref
from .ssd_scan import ssd_chunk_ref
from .zskip_matmul import block_mask_ref, zskip_matmul_ref

__all__ = ["block_mask_ref", "flash_attention_ref", "ssd_chunk_ref", "zskip_matmul_ref"]

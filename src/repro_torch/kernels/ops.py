"""Public wrappers around the LM kernels, as the reference's
``kernels/ops.py`` has them.

``zskip_matmul_op`` is K3 with its block mask built on the device (any M
and N; K a multiple of the tile), ``flash_attention_op`` is K4 on the
model's (b, s, h, hd) layout with grouped kv heads (the reference folds the
heads into the batch axis; the kernel reads them by stride) and
``ssd_chunk_op`` is K5 over every cell in one launch.  There is no
interpret mode: on CPU tensors each runs its kernel's plain version, on
CUDA tensors it launches the kernel or raises.  ``zero_tiles`` counts the
tiles of an activation that K3 skips.
"""

from __future__ import annotations

from .flash_attention import flash_attention_op
from .ssd_scan import ssd_chunk as ssd_chunk_op
from .zskip_matmul import zero_tiles, zskip_matmul_op

__all__ = ["flash_attention_op", "ssd_chunk_op", "zero_tiles", "zskip_matmul_op"]

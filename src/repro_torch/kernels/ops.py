"""Public wrappers around the LM kernels, as the reference's
``kernels/ops.py`` has them.

``flash_attention_op`` is K4 on the model's (b, s, h, hd) layout (the
reference folds the heads into the batch axis; the kernel reads them by
stride) and ``ssd_chunk_op`` is K5 over every cell in one launch.  There is no interpret mode: on CPU tensors each
runs its kernel's plain version, on CUDA tensors it launches the kernel or
raises.  ``zskip_matmul_op`` comes with K3.
"""

from __future__ import annotations

from .flash_attention import flash_attention_op
from .ssd_scan import ssd_chunk as ssd_chunk_op

__all__ = ["flash_attention_op", "ssd_chunk_op"]

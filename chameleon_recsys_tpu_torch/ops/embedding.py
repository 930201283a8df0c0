"""Row gather from the small candidate-pool tables.

Port of ``chameleon_recsys_tpu/ops/embedding.py::pool_gather``.  The JAX
version gives the gather a one-hot-matmul VJP, a workaround for the TPU's slow
scatter; on the GPU a plain index (and, once training is ported, its
``index_add`` backward) is the direct form.
"""
from __future__ import annotations

import torch


def pool_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, C], idx [...] int -> [..., C]."""
    return table[idx]

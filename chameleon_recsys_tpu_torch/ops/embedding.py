"""Row gather from the small candidate-pool tables.

Port of ``chameleon_recsys_tpu/ops/embedding.py::pool_gather``.  The JAX
version gives the gather a one-hot-matmul VJP (a workaround for the TPU's slow
scatter) that sums each pool row's ~100 contributions in f32 and rounds once.
Here the backward is an ``index_add_`` into an f32 buffer, cast once to the
table's dtype: the same sum without the one-hot.  Plain ``table[idx]`` would
back off to an accumulating scatter in the table's dtype, which in bf16
rounds at every contribution.  On a card ``index_add_`` adds with atomics,
so the f32 sum's order, not its precision, varies between runs.
"""
from __future__ import annotations

import torch


class _PoolGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        width = g.shape[-1]
        acc = torch.zeros((ctx.rows, width), dtype=torch.float32, device=g.device)
        acc.index_add_(0, idx.reshape(-1), g.reshape(-1, width).float())
        return acc.to(g.dtype), None


def pool_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, C], idx [...] int -> [..., C]."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _PoolGather.apply(table, idx)
    return table[idx]

"""Dropout, the one primitive behind every dropout site of the port.

Flax's ``nn.Dropout`` as the JAX package calls it: ``keep = 1 - rate``, a
mask ~ Bernoulli(keep), ``select(mask, x / keep, 0)``.  The division runs in
``x``'s dtype with ``keep`` rounded to that dtype first, as JAX's weak-typed
scalar is (in bfloat16 ``x / 0.8`` and ``x / bf16(0.8)`` differ in about one
element of seven); ``F.dropout`` multiplies by ``1 / (1 - p)`` instead and
draws from the global generator, so neither it nor ``nn.GRU``'s own dropout
is used.  The mask is drawn from an explicit ``torch.Generator``.

``_draw_mask`` is the draw: tests replace it (``monkeypatch``) to inject the
masks another implementation drew, call by call.
"""
from __future__ import annotations

from typing import Optional

import torch


def _draw_mask(shape, keep: float, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    """A bool mask of ``shape``, each element kept with probability ``keep``."""
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(x: torch.Tensor, keep_prob: float,
            generator: Optional[torch.Generator] = None, shard=None,
            axis: int = 0) -> torch.Tensor:
    """``x`` with each element zeroed with probability ``1 - keep_prob`` and
    the rest divided by ``keep_prob``; the identity at ``keep_prob >= 1``.
    Under a mesh (``shard``, ``parallel/sharded.py``) ``x`` holds the rank's
    block of the global batch along ``axis``: the mask is drawn at the
    global shape, as one device draws it, and the rank keeps its block."""
    if keep_prob >= 1.0:
        return x
    keep = 1.0 - (1.0 - keep_prob)  # Flax's keep_prob from its rate
    if shard is None:
        mask = _draw_mask(x.shape, keep, generator, x.device)
    else:
        shape = list(x.shape)
        shape[axis] *= shard.plan.data_parallelism
        mask = shard.local_rows(_draw_mask(tuple(shape), keep, generator, x.device), axis)
    scale = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))

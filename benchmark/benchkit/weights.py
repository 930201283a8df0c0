"""Random weights from the seed, made on the device in one draw.

The parameter list comes from the configuration (``reference/nar.py``'s
``Model.param_shapes``, under the system's parameter names), so the system
and the reference are handed the same tensors.  Each leaf is a slice of one
normal draw scaled to its initialiser's standard deviation (He over fan-in,
Glorot over fan-in + fan-out, LeCun), or is constant (ones, zeros)."""
from __future__ import annotations

import math
from typing import Dict

import torch


def _std(kind: str, shape) -> float:
    if kind == "he":
        return math.sqrt(2.0 / shape[0])
    if kind == "he_rows":  # a torch Linear weight, [out, in]
        return math.sqrt(2.0 / shape[1])
    if kind == "lecun":
        return math.sqrt(1.0 / shape[0])
    if kind == "glorot":
        return math.sqrt(2.0 / (shape[0] + shape[1]))
    raise ValueError(kind)


def make_weights(model, seed: int, device) -> Dict[str, torch.Tensor]:
    """{parameter name: float32 tensor on ``device``} for ``model`` (a
    reference ``Model``) from ``seed``."""
    shapes = model.param_shapes()
    drawn = [(n, s, k) for n, s, k in shapes if k not in ("ones", "zeros")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, shape, kind in shapes:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = flat[pos:pos + n].view(shape).mul_(_std(kind, shape))
            pos += n
    return out

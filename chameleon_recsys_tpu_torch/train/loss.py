"""L2 regularisation of the NAR model.

Port of ``chameleon_recsys_tpu/models/nar.py::l2_regularization``:
lambda * sum ||w||^2 / 2 in f32 over the regularised parameters.  As in the
reference graph, biases carry no regulariser, and neither does anything of
the session RNN, its input projection included; Dense kernels, embeddings
and the scale/center vectors do.  In this package's parameter names the
excluded ones are every name with a part ``bias`` or ending in ``_bias``
(``session_FC1.bias``, ``PreCAR_bias``, ``matching_1_bias``, ...) and every
name under ``rnn.``.
"""
from __future__ import annotations

from typing import Container, Optional

import torch
from torch import nn


def is_regularized(name: str) -> bool:
    """Whether the parameter ``name`` (as ``named_parameters`` gives it)
    carries the L2 term."""
    parts = name.split(".")
    if parts[0] == "rnn":
        return False
    return not any(part == "bias" or part.endswith("_bias") for part in parts)


def l2_regularization(model: nn.Module, weight_decay: float,
                      names: Optional[Container[str]] = None) -> torch.Tensor:
    """weight_decay * sum over the regularised parameters (among ``names``,
    where given) of ||w||^2 / 2, f32."""
    terms = [
        p.float().square().sum() / 2.0
        for name, p in model.named_parameters()
        if is_regularized(name) and (names is None or name in names)
    ]
    if not terms:
        return torch.zeros(())
    return weight_decay * torch.stack(terms).sum()

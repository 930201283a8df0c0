"""Buffer-statistic normalization used by the dynamic item features.

Port of ``chameleon_recsys_tpu/ops/normalization.py``: stats are computed
with fixed shapes and an explicit validity mask (weighted moments with the
biased variance, masked min-max), then the z-normed values are min-max
rescaled.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-24


def log_base(x: torch.Tensor, base: float) -> torch.Tensor:
    return torch.log(x) / math.log(base)


def log1p_base(x: torch.Tensor, base: float) -> torch.Tensor:
    return log_base(x + 1.0, base)


def masked_moments(
    values: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean/variance over entries where mask is True (biased variance)."""
    w = mask.to(values.dtype)
    count = torch.clamp_min(w.sum(), 1.0)
    mean = (values * w).sum() / count
    var = (torch.square(values - mean) * w).sum() / count
    return mean, var


def masked_min_max(
    values: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    big = torch.finfo(values.dtype).max
    vmin = torch.where(mask, values, big).min()
    vmax = torch.where(mask, values, -big).max()
    return vmin, vmax


def min_max_normalization(
    tensor: torch.Tensor,
    stats_values: torch.Tensor,
    stats_mask: torch.Tensor,
    min_max_range: Tuple[float, float] = (-1.0, 1.0),
) -> torch.Tensor:
    min_value, max_value = masked_min_max(stats_values, stats_mask)
    scaled = (tensor - min_value + _EPS) / torch.clamp_min(
        max_value - min_value, 2 * _EPS
    )
    lo, hi = min_max_range
    return scaled * (hi - lo) + lo


def normalize_values(
    tensor_to_normalize: torch.Tensor,
    stats_values: torch.Tensor,
    stats_mask: torch.Tensor,
    min_max_scaling_after_znorm: bool = True,
    min_max_range: Tuple[float, float] = (-1.0, 1.0),
) -> torch.Tensor:
    """Standardize against masked stats, then min-max rescale."""
    mean, var = masked_moments(stats_values, stats_mask)
    stddev = torch.sqrt(var + _EPS)
    normed = (tensor_to_normalize - mean) / stddev
    if min_max_scaling_after_znorm:
        stats_normed = (stats_values - mean) / stddev
        normed = min_max_normalization(
            normed, stats_normed, stats_mask, min_max_range=min_max_range
        )
    return normed

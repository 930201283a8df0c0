"""Schema-driven feature towers (port of ``chameleon_recsys_tpu/models/towers.py``).

Categorical features with cardinality <= ``max_cardinality_for_ohe`` are
one-hot encoded, larger ones get a trainable embedding of
``floor(8 * cardinality**0.25)`` dims; numerical features pass through with a
channel axis.  All channels concatenate on the last axis.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
from torch import nn

from ..config import FeatureSpec, embedding_dim_for_cardinality


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ids clamped into range, as XLA clamps a gather."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


class FeatureTowers(nn.Module):
    def __init__(
        self,
        features: Sequence[FeatureSpec],
        max_cardinality_for_ohe: int = 10,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if not features:
            raise ValueError("FeatureTowers needs a non-empty schema")
        self.features = tuple(features)
        self.max_cardinality_for_ohe = max_cardinality_for_ohe
        self.dtype = dtype
        self.embeddings = nn.ModuleDict()
        self.output_dim = 0
        for spec in self.features:
            if spec.kind != "categorical":
                self.output_dim += 1
            elif spec.cardinality <= max_cardinality_for_ohe:
                self.output_dim += spec.cardinality
            else:
                dim = embedding_dim_for_cardinality(spec.cardinality)
                self.embeddings[f"{spec.name}_embedding"] = nn.Embedding(
                    spec.cardinality, dim
                )
                self.output_dim += dim

    def forward(self, inputs: Dict[str, torch.Tensor],
                lookup: Callable = gather_rows) -> torch.Tensor:
        """inputs[name] has shape [...]; returns [..., F] concatenated channels.
        ``lookup(table, ids)`` gathers an embedding's rows (a row-sharded
        table's lookup under a mesh, ``parallel/sharded.py``)."""
        channels = []
        for spec in self.features:
            x = inputs[spec.name]
            if spec.kind != "categorical":
                channels.append(x.to(self.dtype)[..., None])
            elif spec.cardinality <= self.max_cardinality_for_ohe:
                # out-of-range values give an all-zero row, as jax.nn.one_hot
                classes = torch.arange(spec.cardinality, device=x.device)
                channels.append((x[..., None] == classes).to(self.dtype))
            else:
                table = self.embeddings[f"{spec.name}_embedding"].weight
                channels.append(lookup(table, x).to(self.dtype))
        return torch.cat(channels, dim=-1)

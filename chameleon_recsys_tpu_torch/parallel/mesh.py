"""The (data x model) layout over a ``torch.distributed`` process group.

Port of ``chameleon_recsys_tpu/parallel/mesh.py``.  One process drives one
device; the world of W = dp x mp ranks is laid out as JAX lays its devices
out, ``np.asarray(devices).reshape(dp, mp)``: rank = data_index * mp +
model_index.  Sessions are data-parallel over ``data``; every large
``[rows, dim]`` table (the trainable item embedding, the frozen ACE matrix,
a large feature embedding, with their Adam moments) is row-sharded over
``model``, so that no device holds the whole catalog; the streaming state,
the RNN and MLP weights and the metrics are replicated.

The sharding rules are JAX's, structural by shape, and here return a plan per
leaf instead of a ``NamedSharding``: a ``RowShard`` (the rank's rows
``[m * R / mp, (m + 1) * R / mp)``) or ``None`` (the whole leaf).  For a
batch, the rank holds the contiguous rows of its data index in the global
batch.
"""
from __future__ import annotations

import os
from typing import Any, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist


class RowShard(NamedTuple):
    """A rank's rows ``[lo, hi)`` of a table of ``rows`` rows."""

    lo: int
    hi: int
    rows: int


class MeshPlan(NamedTuple):
    world: int
    rank: int
    data_parallelism: int
    model_parallelism: int
    data_group: Any  # the ranks that share this rank's model index
    model_group: Any  # the ranks that share this rank's data index
    device: torch.device
    backend: str

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallelism

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallelism

    @property
    def model_root(self) -> int:
        """The global rank of model index 0 in this rank's model group."""
        return self.data_index * self.model_parallelism


def default_device() -> torch.device:
    """``cuda:LOCAL_RANK`` (modulo the cards present) where there is a card,
    else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(
    data_parallelism: Optional[int] = None,
    model_parallelism: int = 1,
    device=None,
) -> MeshPlan:
    """The plan of this rank over the initialised process group (every rank
    calls it: it creates the data and model subgroups, collectively)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.distributed.initialize_multihost)")
    n = dist.get_world_size()
    if data_parallelism is None:
        data_parallelism = n // model_parallelism
    if data_parallelism * model_parallelism != n:
        raise ValueError(
            f"{data_parallelism}x{model_parallelism} mesh needs "
            f"{data_parallelism * model_parallelism} devices, got {n}"
        )
    rank, dp, mp = dist.get_rank(), data_parallelism, model_parallelism
    data_group = model_group = None
    # every rank creates every group, in the same order
    for m in range(mp):
        group = dist.new_group([d * mp + m for d in range(dp)])
        if rank % mp == m:
            data_group = group
    for d in range(dp):
        group = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            model_group = group
    return MeshPlan(n, rank, dp, mp, data_group, model_group,
                    torch.device(device) if device is not None else default_device(),
                    dist.get_backend())


def row_shardable(shape, model_par: int, min_rows: int) -> bool:
    return len(shape) == 2 and shape[0] >= min_rows and shape[0] % model_par == 0


def row_shard(plan: MeshPlan, rows: int) -> RowShard:
    n = rows // plan.model_parallelism
    return RowShard(plan.model_index * n, (plan.model_index + 1) * n, rows)


def params_sharding(plan: MeshPlan, params: Mapping[str, Any], min_rows: int = 4096):
    """{name: leaf (anything with ``.shape``; dim 0 = rows)} -> {name:
    ``RowShard`` or None}: row-shard every large [rows, dim] table over the
    model axis, replicate everything else.  Adam's moments mirror the
    parameters and take the same plan."""
    mp = plan.model_parallelism
    return {
        name: row_shard(plan, leaf.shape[0])
        if mp > 1 and row_shardable(tuple(leaf.shape), mp, min_rows)
        else None
        for name, leaf in params.items()
    }


def batch_sharding(plan: MeshPlan, batch: Mapping[str, Any]):
    """{name: slice of the global batch's rows this rank holds}: the
    contiguous block of its data index, for every leaf with a leading axis."""
    def rule(leaf):
        if len(leaf.shape) == 0:
            return None
        n = leaf.shape[0] // plan.data_parallelism
        return slice(plan.data_index * n, (plan.data_index + 1) * n)

    return {name: rule(leaf) for name, leaf in batch.items()}


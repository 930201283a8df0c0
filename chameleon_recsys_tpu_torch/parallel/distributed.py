"""The process group, the pod mesh and the collectives of the sharded steps.

Port of ``chameleon_recsys_tpu/parallel/distributed.py``.  The JAX package
runs ``jax.distributed`` over hosts, each feeding its devices; here each
device has its process, over ``torch.distributed`` (NCCL between cards, gloo
on the CPU), launched by ``torchrun`` or ``torch.multiprocessing.spawn``.
The temporal-hour boundary is a global synchronisation point: every rank
walks the same hours, and the streaming state's update consumes the whole
global batch's clicks (all-gathered over the data group), so it is the same
on every rank and nothing leaks between hours.

The sharded steps use three collectives, ``all_reduce`` (SUM),
``all_gather`` and ``broadcast``, which NCCL and gloo both take on CUDA
tensors; a data-parallel eval sends each batch's ranked lists to rank 0
with ``gather_object`` (host objects, pickled).  Each wrapper below counts
its calls and bytes (the tensor, or the pickle, it sends) by kind in
``counts``; a group of one rank makes no call and counts nothing.
"""
from __future__ import annotations

import logging
import pickle
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .mesh import MeshPlan, make_mesh

log = logging.getLogger("chameleon_recsys_tpu_torch.distributed")

KINDS = ("all_reduce", "all_gather", "broadcast", "gather")
counts: Dict[str, Dict[str, int]] = {k: {"calls": 0, "bytes": 0} for k in KINDS}


def reset_counts() -> None:
    for entry in counts.values():
        entry["calls"] = entry["bytes"] = 0


def snapshot_counts() -> Dict[str, Dict[str, int]]:
    return {k: dict(v) for k, v in counts.items()}


def _count(kind: str, tensor: torch.Tensor) -> None:
    counts[kind]["calls"] += 1
    counts[kind]["bytes"] += tensor.numel() * tensor.element_size()


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce(tensor: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM over ``group``."""
    if group_size(group) > 1:
        _count("all_reduce", tensor)
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``tensor`` (the same shape on each), in rank order."""
    if group_size(group) == 1:
        return [tensor]
    _count("all_gather", tensor)
    tensor = tensor.contiguous()
    out = [torch.empty_like(tensor) for _ in range(group_size(group))]
    dist.all_gather(out, tensor, group=group)
    return out


def gather_object(obj, dst: int, group) -> Optional[List]:
    """Every rank's picklable ``obj`` on the global rank ``dst`` (in
    ``group``), in rank order; None on the other ranks."""
    n = group_size(group)
    if n == 1:
        return [obj]
    counts["gather"]["calls"] += 1
    counts["gather"]["bytes"] += len(pickle.dumps(obj))
    out = [None] * n if dist.get_rank() == dst else None
    dist.gather_object(obj, out, dst=dst, group=group)
    return out


def broadcast(tensor: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place, from the global rank ``src`` of ``group``."""
    if group_size(group) > 1:
        _count("broadcast", tensor)
        dist.broadcast(tensor, src=src, group=group)
    return tensor


def barrier(plan: MeshPlan) -> None:
    """Return when every rank has reached this call (an all-reduce over the
    world, waited for)."""
    flag = torch.ones(1, device=plan.device)
    all_reduce(flag, None).item()


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group`` for this process.  With no
    arguments it reads ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``, as ``torchrun`` sets them); else it joins
    ``coordinator_address`` (``host:port`` or a ``tcp://`` URL) as
    ``process_id`` of ``num_processes``.  ``backend``: ``"nccl"`` for
    cards, ``"gloo"`` for the CPU (and for several ranks on one card, which
    NCCL refuses); by default NCCL where there is a card."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
    log.info("distributed initialised: rank %d/%d over %s", dist.get_rank(),
             dist.get_world_size(), backend)


def make_pod_mesh(model_parallelism: int = 1, device=None) -> MeshPlan:
    """The (data x model) mesh over every rank of the world."""
    return make_mesh(
        data_parallelism=dist.get_world_size() // model_parallelism,
        model_parallelism=model_parallelism,
        device=device,
    )


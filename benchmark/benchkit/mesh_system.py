"""The system's data-parallel train path, ``TemporalHarness(mesh_plan=...)``
over ``torch.distributed``, one process a rank: the process group joined
through ``parallel/distributed.py``, the (data x 1) plan of
``parallel/mesh.py`` and a harness whose train state is the benchmark's, as
``TemporalHarness.init_state`` makes it on a mesh.  The configuration's
``NARConfig`` takes ``train_compaction_groups`` = the data parallelism, as
the G1 trainer sets it for ``--data_parallelism``.  Beside ``system.py``,
the only module of the benchmark that imports the system's mesh."""
from __future__ import annotations

import torch

from chameleon_recsys_tpu_torch.config import RunConfig
from chameleon_recsys_tpu_torch.parallel import distributed
from chameleon_recsys_tpu_torch.parallel.mesh import make_mesh
from chameleon_recsys_tpu_torch.parallel.sharded import shard_nar_programs
from chameleon_recsys_tpu_torch.train import temporal
from chameleon_recsys_tpu_torch.train.steps import init_train_state

from . import system


def join(port: int, world: int, rank: int, backend: str, device, data_parallelism: int):
    """This rank's plan over the world at ``localhost:port``."""
    distributed.initialize_multihost(f"localhost:{port}", world, rank, backend=backend)
    return make_mesh(data_parallelism, 1, device=device)


def leave() -> None:
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def mesh_config(config: dict, plan) -> dict:
    """``config`` with ``train_compaction_groups`` = the data parallelism."""
    return dict(config, nar=dict(config["nar"],
                                 train_compaction_groups=plan.data_parallelism))


def make_harness(config: dict, corpus, weights, history, sampler_seed: int, plan,
                 model_dir: str):
    """A mesh ``TemporalHarness`` with no classical baselines on this rank:
    the benchmark's weights, the warmed stream, Adam, and the sampler's
    generator seeded from the run's seed (the same on every rank)."""
    config = mesh_config(config, plan)
    sessions, articles = system.schemas(config)
    harness = temporal.TemporalHarness(
        system.nar_config(config), RunConfig(model_dir=model_dir), sessions, articles,
        corpus.ace, corpus.metadata, benchmarks=(), mesh_plan=plan, device=plan.device)
    model = system.build_model(config, weights, plan.device)
    harness._sharded = shard_nar_programs(plan, model, corpus.ace, harness.mesh_min_rows)
    harness.ace_matrix = harness._sharded.local_ace(
        torch.from_numpy(corpus.ace).to(plan.device))
    generator = torch.Generator(device=plan.device).manual_seed(int(sampler_seed) % (2 ** 63))
    harness.state = init_train_state(
        model, system.warm_stream(config, *history, plan.device), generator)
    return harness


def flag(plan, value: int) -> int:
    """Rank 0's ``value`` on every rank, returned when every rank has it."""
    t = torch.full((1,), int(value), dtype=torch.int64, device=plan.device)
    return int(distributed.broadcast(t, 0, None).item())


def bits_apart(plan, tensors) -> int:
    """Bytes of ``tensors`` (the same names and shapes on every rank) that
    differ from rank 0's, summed over the ranks."""
    apart = torch.zeros(1, dtype=torch.int64, device=plan.device)
    for t in tensors:
        mine = t.detach().contiguous().view(-1).view(torch.uint8)
        theirs = distributed.broadcast(mine.clone(), 0, None)
        apart += (mine != theirs).sum()
    return int(distributed.all_reduce(apart, None).item())


def gather(plan, obj):
    """Every rank's picklable ``obj`` on rank 0, in rank order; None on the
    others."""
    return distributed.gather_object(obj, 0, None)

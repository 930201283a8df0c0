"""The spawned ranks of the port's multi-GPU tests
(``tests/test_torch_parallel_*.py``, ``tests/test_torch_cli_*.py``).

Each rank joins a gloo world on the CPU and runs one of the functions below;
this module imports torch and the port only, never JAX (the JAX side of each
comparison runs in the test process).  ``run_world`` spawns the ranks and
returns their results in rank order.
"""
import os
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD_TIMEOUT = 120  # seconds a spawned world may take


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_world(fn, world: int, *args, timeout: float = WORLD_TIMEOUT,
              backend: str = "gloo"):
    """``fn(rank, *args)`` on ``world`` spawned ranks of one process group
    over ``backend`` (``fn`` joins it through ``_entry``); the results by
    rank."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, rank, world, port, queue, args, backend))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=timeout) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    failed = {r: res for r, res in results.items() if isinstance(res, str)}
    assert not failed, "\n".join(f"rank {r}:\n{tb}" for r, tb in failed.items())
    return [results[r] for r in range(world)]


def _entry(fn, rank, world, port, queue, args, backend):
    from chameleon_recsys_tpu_torch.parallel.distributed import initialize_multihost

    torch.set_num_threads(1)
    try:
        initialize_multihost(f"localhost:{port}", world, rank, backend=backend)
        queue.put((rank, fn(rank, *args)))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _tensors(arrays):
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def step_rank(rank, inputs):
    """The sharded eval step from the initial state, then the train steps
    with the given uniforms (global shape): per step the metrics, the
    collectives and (after the first) the whole Adam moments; after the last
    the rank's own parameters, the whole ones and the stream."""
    from chameleon_recsys_tpu_torch.convert import stream_from_numpy
    from chameleon_recsys_tpu_torch.models.nar import NARModel
    from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
    from chameleon_recsys_tpu_torch.parallel import distributed
    from chameleon_recsys_tpu_torch.parallel.mesh import make_mesh
    from chameleon_recsys_tpu_torch.parallel.sharded import put_batch, shard_nar_programs
    from chameleon_recsys_tpu_torch.train.steps import init_train_state

    cfg = inputs["cfg"]
    plan = make_mesh(inputs["dp"], inputs["mp"], device="cpu")
    model = NARModel(cfg, inputs["sess"], inputs["art"], inputs["ace"].shape[1])
    model.load_state_dict(_tensors(inputs["params"]))
    programs = shard_nar_programs(plan, model, inputs["ace"], inputs["min_rows"])
    state = init_train_state(model, stream_from_numpy(inputs["stream"], device="cpu"),
                             torch.Generator())
    ace = programs.local_ace(torch.from_numpy(inputs["ace"]))
    metadata = _tensors(inputs["metadata"])
    _, metrics, fetches = programs.eval_step(
        model, state.stream, put_batch(programs, inputs["eval_batch"]), ace, metadata,
        generator=torch.Generator().manual_seed(inputs["eval_seed"]))
    out = {"eval_metrics": {k: float(v) for k, v in metrics.items()},
           "eval_fetches": _numpy(fetches), "steps": [],
           "sharded": sorted(n for n, s in programs.state_sharding.items() if s),
           "ace_sharded": programs.ace_sharding is not None}
    for i, (batch, uniforms) in enumerate(zip(inputs["batches"], inputs["uniforms"])):
        distributed.reset_counts()
        state, metrics = programs.train_step(
            state, put_batch(programs, batch), ace, metadata,
            uniforms=SamplerUniforms(*(torch.from_numpy(np.array(u)) for u in uniforms)))
        step = {"metrics": {k: float(v) for k, v in metrics.items()},
                "collectives": distributed.snapshot_counts()}
        if i == 0:
            params = dict(state.model.named_parameters())
            step["moments"] = {
                key: _numpy(programs.full_tensors(
                    {n: state.optimizer.state[p][key] for n, p in params.items()}))
                for key in ("exp_avg", "exp_avg_sq")}
        out["steps"].append(step)
    params = dict(state.model.named_parameters())
    out["local_params"] = _numpy(params)
    out["params"] = _numpy(programs.full_tensors(params))
    out["stream"] = _numpy(state.stream._asdict())
    return out


def harness_rank(rank, inputs):
    """A mesh harness over ``inputs["hours"]``: train hour 0, write a
    checkpoint, train hour 1, evaluate hour 2 (with the recommendation log
    and ``inputs["host_tier"]``'s arguments);
    then a new mesh harness from the one-device checkpoint
    ``inputs["single_checkpoint"]`` trains hour 1."""
    from chameleon_recsys_tpu_torch.config import RunConfig
    from chameleon_recsys_tpu_torch.parallel.mesh import make_mesh
    from chameleon_recsys_tpu_torch.train.temporal import TemporalHarness

    plan = make_mesh(inputs["dp"], inputs["mp"], device="cpu")
    hours = inputs["hours"]

    def harness(model_dir, **kw):
        return TemporalHarness(
            inputs["cfg"], RunConfig(model_dir=model_dir, training_hours_for_each_eval=2),
            inputs["sess"], inputs["art"], inputs["ace"], inputs["metadata"],
            mesh_plan=plan, mesh_min_rows=inputs["min_rows"], device="cpu", **kw)

    h = harness(inputs["model_dir"], log_recommendations=True, **inputs["host_tier"])
    stats = [h.train_hour(hours[0])]
    h.save_checkpoint(inputs["mesh_checkpoint"])
    stats.append(h.train_hour(hours[1]))
    stream_after_training = _numpy(h.state.stream._asdict())
    row = h.evaluate_hour(hours[2])
    resumed = harness(inputs["model_dir"] + "_resumed")
    resumed.load_checkpoint(inputs["single_checkpoint"])
    return {
        "losses": [s["avg_ce_loss"] for s in stats],
        "stream": stream_after_training,
        "row": row,
        "recommendations": h.artifacts.sessions_chameleon_recommendations_log,
        "negatives": h.artifacts.sessions_negative_items_log,
        "resumed_loss": resumed.train_hour(hours[1])["avg_ce_loss"],
        "sharded": sorted(n for n, s in h._sharded.state_sharding.items() if s),
    }


def cli_rank(rank, module_name, argv, injected):
    """A trainer CLI's ``main(argv)`` on this rank, as under ``torchrun``
    (the environment names the rank and the world).  ``injected``: None, or
    the initial parameters (a Flax tree) and stream, and the sampler
    uniforms of every step in order (global shape), to start from and draw."""
    import importlib

    from chameleon_recsys_tpu_torch.convert import params_from_flax, stream_from_numpy
    from chameleon_recsys_tpu_torch.models.nar import NARModel
    from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
    from chameleon_recsys_tpu_torch.parallel import sharded

    dist = torch.distributed
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(dist.get_world_size()))
    module = importlib.import_module(module_name)
    if injected is not None:
        draws = iter(injected["uniforms"])

        def next_uniforms():
            return SamplerUniforms(*(torch.from_numpy(np.array(u)) for u in next(draws)))

        class Injected(module.TemporalHarness):
            def init_state(self):
                super().init_state()
                whole = params_from_flax(injected["params"], NARModel(
                    self.cfg, self.session_schema, self.article_schema,
                    self.ace_matrix_np.shape[1]))
                self.state.model.load_state_dict(self._sharded.local_tensors(whole))
                self.state = self.state._replace(
                    stream=stream_from_numpy(injected["stream"], device="cpu"))

        train, evaluate = sharded.ShardedNARPrograms.train_step, \
            sharded.ShardedNARPrograms.eval_step
        sharded.ShardedNARPrograms.train_step = (
            lambda self, *a, **k: train(self, *a, **k, uniforms=next_uniforms()))
        sharded.ShardedNARPrograms.eval_step = (
            lambda self, *a, **k: evaluate(self, *a, **k, uniforms=next_uniforms()))
        module.TemporalHarness = Injected
    module.main(argv)
    return rank


def card_collectives_rank(rank):
    """gloo's all-reduce and all-gather on CUDA tensors, every rank on the
    one card (NCCL refuses two ranks on one device)."""
    from chameleon_recsys_tpu_torch.parallel import distributed

    x = torch.full((5,), float(rank + 1), device="cuda")
    distributed.all_reduce(x, None)
    parts = distributed.all_gather(torch.arange(3, device="cuda") + 10 * rank, None)
    return {"sum": x.cpu().numpy(), "gathered": [p.cpu().numpy() for p in parts],
            "on_card": x.is_cuda and all(p.is_cuda for p in parts)}


def card_step_rank(rank, cfg, sess, art):
    """At 1 x 1 on the card: the sharded eval and train steps against the
    plain ones from the same weights, stream, batch and uniforms, with each
    path's kernel launches."""
    import copy

    from chameleon_recsys_tpu_torch.data.collate import collate_sessions
    from chameleon_recsys_tpu_torch.data.synthetic import (
        make_synthetic_corpus,
        synthetic_hour_sessions,
    )
    from chameleon_recsys_tpu_torch.models.nar import NARModel
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer, ugrnn
    from chameleon_recsys_tpu_torch.ops.sampling import draw_uniforms
    from chameleon_recsys_tpu_torch.parallel.mesh import make_mesh
    from chameleon_recsys_tpu_torch.parallel.sharded import put_batch, shard_nar_programs
    from chameleon_recsys_tpu_torch.state.stream_state import (
        init_stream_state,
        update_stream_state,
    )
    from chameleon_recsys_tpu_torch.train.steps import (
        _batch_all_clicks,
        eval_step,
        init_train_state,
        train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    plan = make_mesh(1, 1, device=device)
    b, length = cfg.batch_size, cfg.max_session_length
    corpus = make_synthetic_corpus(art, ace_dim=8)
    warm, np_batch = (collate_sessions(synthetic_hour_sessions(corpus, sess, h, b, length),
                                       sess, b, length) for h in (0, 1))
    stream = update_stream_state(
        init_stream_state(cfg, art.num_items, device=device),
        *_batch_all_clicks({k: v.to(device) for k, v in _tensors(warm).items()}), cfg)
    ace = torch.from_numpy(corpus.ace_matrix).to(device)
    metadata = {k: v.to(device) for k, v in _tensors(corpus.metadata).items()}
    model = NARModel(cfg, sess, art, 8)
    model.reset_parameters(torch.Generator().manual_seed(0))
    models = {"plain": model.to(device), "sharded": copy.deepcopy(model).to(device)}
    programs = shard_nar_programs(plan, models["sharded"], corpus.ace_matrix)
    batch = put_batch(programs, np_batch)
    gen = torch.Generator(device=device).manual_seed(4)
    l, buffer = length, cfg.recent_clicks_buffer_max_size
    eval_u = draw_uniforms(gen, b, l, buffer, num_negatives=cfg.eval_negative_samples,
                           buffer_sample_size=cfg.eval_negative_sample_from_buffer)
    train_u = draw_uniforms(gen, b, l, buffer, num_negatives=cfg.negative_samples,
                            buffer_sample_size=cfg.negative_sample_from_buffer,
                            rows=cfg.train_valid_row_capacity)
    out = {}
    for name, m in models.items():
        launches = []

        def counts():
            torch.cuda.synchronize()
            return [cand_scorer.launches, cand_scorer.stash_launches,
                    cand_scorer.bwd_launches, ugrnn.launches, ugrnn.bwd_launches]

        before = counts()
        call = eval_step if name == "plain" else programs.eval_step
        eval_stream, eval_metrics, fetches = call(
            m, stream, batch, ace, metadata, generator=torch.Generator(device=device),
            uniforms=eval_u)
        launches.append([a - c for a, c in zip(counts(), before)])
        state = init_train_state(m, stream, torch.Generator(device=device))
        before = counts()
        state, metrics = (train_step(state, batch, ace, metadata, uniforms=train_u)
                          if name == "plain" else
                          programs.train_step(state, batch, ace, metadata, uniforms=train_u))
        launches.append([a - c for a, c in zip(counts(), before)])
        out[name] = {
            "eval_metrics": _numpy(eval_metrics), "fetches": _numpy(fetches),
            "eval_stream": _numpy(eval_stream._asdict()),
            "metrics": _numpy(metrics), "stream": _numpy(state.stream._asdict()),
            "grads": {n: p.grad.detach().cpu().numpy() for n, p in m.named_parameters()},
            "params": _numpy(dict(m.named_parameters())), "launches": launches,
        }
    out["backend"] = torch.distributed.get_backend()
    return out

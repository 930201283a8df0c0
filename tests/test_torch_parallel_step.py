"""The port's sharded NAR steps on a 2 x 2 gloo world against the JAX
package's 2 x 2 mesh step and the port's one-device grouped step.

Four spawned ranks (``tests/_torch_parallel_worker.py::step_rank``, no JAX
there) run the sharded eval step from the initial weights, then three train
steps at ``train_compaction_groups`` 2 and a capacity that drops rows in
some group, from ``test_torch_train_step.py``'s perturbed JAX weights (via
``convert.params_from_flax``) and warm stream, with the JAX state's draws at
the global shape injected, at ``min_rows`` 64: the item embedding, the ACE
matrix and ``session_FC2``'s kernel are row-sharded over the model axis.

Checked: the first step's loss within 1e-5 relative and Adam's moments
within 1e-4 of JAX's 2 x 2 mesh step (``chameleon_recsys_tpu/parallel``,
on four of conftest's eight CPU devices; JAX's plain scorer, the port's
kernel branches, whose twins run here) and of the port's one-device
grouped step; after three steps the replicated parameters bit-equal on all
four ranks (a row shard on the two ranks that hold it) and the stream
exactly the one-device step's; the eval step's summed metrics and each
rank's fetch rows against the one-device eval step; each step's
``dropped_clicks`` against the groups' overflow counted on the host; the
same collectives every step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from chameleon_recsys_tpu.parallel.sharded import put_batch as jax_put_batch
from chameleon_recsys_tpu.parallel.sharded import shard_nar_programs as jax_shard_nar_programs
from chameleon_recsys_tpu.train.steps import build_nar_train

from chameleon_recsys_tpu_torch.convert import flax_from_tensors
from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
from chameleon_recsys_tpu_torch.train.steps import eval_step, init_train_state, train_step

from _torch_parallel_worker import run_world, step_rank
from test_torch_eval_step import port_aux_consts, port_model, to_port_stream, warm_stream
from test_torch_train_step import (
    G1_LEARNING_RATE,
    config,
    jax_train_uniforms,
    leaves,
    to_torch,
    world,  # noqa: F401  (the module's fixture)
)

DP, MP, MIN_ROWS, STEPS, CAPACITY, EVAL_SEED = 2, 2, 64, 3, 24, 11


def numpy_batch(batch):
    return {k: np.array(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs(world):  # noqa: F811
    cfg = config(train_valid_row_capacity=CAPACITY, novelty_reg_factor=0.1,
                 learning_rate=G1_LEARNING_RATE, train_compaction_groups=DP)
    port_cfg = dataclasses.replace(cfg, use_pallas_scorer=True, use_pallas_rnn=True)
    batches = [numpy_batch(b) for b in world["batches"][:STEPS]]
    eval_batch = numpy_batch(world["batches"][STEPS])

    # JAX: the 2 x 2 mesh step, and the draws of each step from its key chain
    params = jax.tree_util.tree_map(jnp.asarray, world["params"])
    programs = build_nar_train(cfg, world["sess"], world["art"])
    stream = warm_stream(world, cfg, 2)
    state = world["state"]._replace(
        params=params, opt_state=programs.optimizer.init(params),
        stream=jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), stream),
        rng=jnp.array(world["state"].rng, copy=True))
    rng, uniforms = np.asarray(state.rng), []
    for _ in range(STEPS):
        u, rng = jax_train_uniforms(cfg, rng, CAPACITY, cfg.batch_size,
                                    cfg.max_session_length,
                                    cfg.recent_clicks_buffer_max_size)
        uniforms.append(tuple(x.numpy() for x in u))
    plan = jax_make_mesh(data_parallelism=DP, model_parallelism=MP,
                         devices=jax.devices()[: DP * MP])
    sharded = jax_shard_nar_programs(programs, plan, state, batches[0], world["ace"],
                                     world["metadata"], min_rows=MIN_ROWS)
    jax_state, jax_metrics = sharded.train_step(
        jax.device_put(state, sharded.state_sharding), jax_put_batch(sharded, batches[0]),
        jax.device_put(world["ace"], sharded.ace_sharding),
        jax.device_put(world["metadata"], sharded.metadata_sharding))
    jax_step = {"loss": float(jax_metrics["loss"]),
                "exp_avg": leaves(jax_state.opt_state[0].mu),
                "exp_avg_sq": leaves(jax_state.opt_state[0].nu)}

    # the port on one device, grouped
    model = port_model(world, port_cfg).train()
    initial = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    ace, metadata = port_aux_consts(world)
    warm = to_port_stream(stream)
    _, eval_metrics, eval_fetches = eval_step(
        model, warm, to_torch(eval_batch), ace, metadata,
        generator=torch.Generator().manual_seed(EVAL_SEED))
    one = init_train_state(model, warm, torch.Generator())
    one_steps = []
    for i, (batch, u) in enumerate(zip(batches, uniforms)):
        one, metrics = train_step(one, to_torch(batch), ace, metadata,
                                  uniforms=SamplerUniforms(*map(torch.from_numpy, u)))
        step = {"metrics": {k: float(v) for k, v in metrics.items()}}
        if i == 0:
            step["moments"] = {
                key: {n: one.optimizer.state[p][key].numpy().copy()
                      for n, p in one.model.named_parameters()}
                for key in ("exp_avg", "exp_avg_sq")}
        one_steps.append(step)

    ranks = run_world(step_rank, DP * MP, {
        "cfg": port_cfg, "sess": model.session_schema, "art": model.article_schema,
        "params": initial, "stream": {k: v.numpy() for k, v in warm._asdict().items()},
        "ace": ace.numpy(), "metadata": {k: v.numpy() for k, v in metadata.items()},
        "batches": batches, "uniforms": uniforms, "eval_batch": eval_batch,
        "eval_seed": EVAL_SEED, "dp": DP, "mp": MP, "min_rows": MIN_ROWS,
    })
    return dict(cfg=cfg, batches=batches, eval_batch=eval_batch, jax_step=jax_step,
                one_steps=one_steps, one_state=one,
                eval_metrics={k: float(v) for k, v in eval_metrics.items()},
                eval_fetches={k: v.numpy() for k, v in eval_fetches.items()}, ranks=ranks)


def flax_leaves(tensors):
    return leaves(flax_from_tensors({n: torch.from_numpy(v) for n, v in tensors.items()}))


def test_the_tables_are_row_sharded(runs):
    for rank in runs["ranks"]:
        assert rank["sharded"] == ["item_clicked_embedding.weight", "session_FC2.weight"]
        assert rank["ace_sharded"]


def test_first_step_matches_the_jax_mesh_step(runs):
    jax_step = runs["jax_step"]
    for rank in runs["ranks"]:
        step = rank["steps"][0]
        assert step["metrics"]["loss"] == pytest.approx(jax_step["loss"], rel=1e-5)
        for key in ("exp_avg", "exp_avg_sq"):
            got = flax_leaves(step["moments"][key])
            assert set(got) == set(jax_step[key])
            for path, expected in jax_step[key].items():
                np.testing.assert_allclose(got[path], expected, atol=1e-4, rtol=0,
                                           err_msg=f"{key} {path}")


def test_first_step_matches_the_one_device_grouped_step(runs):
    one = runs["one_steps"][0]
    for rank in runs["ranks"]:
        step = rank["steps"][0]
        assert set(step["metrics"]) == set(one["metrics"])
        for key in ("loss", "ce_loss", "reg_loss"):
            assert step["metrics"][key] == pytest.approx(one["metrics"][key], rel=1e-5), key
        for key in ("sessions", "clicks", "dropped_clicks"):
            assert step["metrics"][key] == one["metrics"][key], key
        for key in ("exp_avg", "exp_avg_sq"):
            for name, expected in one["moments"][key].items():
                np.testing.assert_allclose(step["moments"][key][name], expected,
                                           atol=1e-4, rtol=0, err_msg=f"{key} {name}")


def test_replicated_state_is_bit_equal_across_ranks(runs):
    """After three steps: each replicated parameter bit-equal on all four
    ranks, each row shard on the two ranks of its model index, the gathered
    parameters and the first step's gathered moments on all four."""
    ranks = runs["ranks"]
    sharded = set(ranks[0]["sharded"])
    for name, value in ranks[0]["local_params"].items():
        for rank_index, rank in enumerate(ranks):
            same_rows = name not in sharded or rank_index % MP == 0
            if same_rows:
                assert np.array_equal(rank["local_params"][name], value), (name, rank_index)
        if name in sharded:
            assert np.array_equal(ranks[1]["local_params"][name],
                                  ranks[3]["local_params"][name]), name
            assert not np.array_equal(ranks[0]["local_params"][name],
                                      ranks[1]["local_params"][name]), name
    for rank in ranks[1:]:
        for name, value in ranks[0]["params"].items():
            assert np.array_equal(rank["params"][name], value), name
        for key in ("exp_avg", "exp_avg_sq"):
            for name, value in ranks[0]["steps"][0]["moments"][key].items():
                assert np.array_equal(rank["steps"][0]["moments"][key][name], value), name


def test_stream_state_is_exactly_the_one_device_steps(runs):
    expected = {k: v.numpy() for k, v in runs["one_state"].stream._asdict().items()}
    for rank in runs["ranks"]:
        for field, value in expected.items():
            np.testing.assert_array_equal(rank["stream"][field], value, err_msg=field)


def test_losses_follow_the_one_device_steps(runs):
    for rank in runs["ranks"]:
        got = [s["metrics"]["loss"] for s in rank["steps"]]
        np.testing.assert_allclose(got, [s["metrics"]["loss"] for s in runs["one_steps"]],
                                   rtol=1e-5)


def test_dropped_clicks_are_the_groups_overflow(runs):
    cfg, t = runs["cfg"], runs["cfg"].max_inputs_length
    drops = []
    for i, batch in enumerate(runs["batches"]):
        sizes = batch["session_size"]
        valid = (np.arange(t)[None] < (sizes - 1)[:, None]).reshape(DP, -1).sum(1)
        overflow = float(np.maximum(valid - CAPACITY // DP, 0).sum())
        drops.append(overflow)
        for rank in runs["ranks"]:
            assert rank["steps"][i]["metrics"]["dropped_clicks"] == overflow
    assert max(drops) > 0, drops


def test_eval_step_sums_metrics_and_fetches_the_ranks_rows(runs):
    expected, fetches = runs["eval_metrics"], runs["eval_fetches"]
    rows = runs["eval_batch"]["item_clicked"].shape[0] // DP
    for rank_index, rank in enumerate(runs["ranks"]):
        got = rank["eval_metrics"]
        assert list(got) == list(expected)
        for key in ("hit_sum", "label_count", "clicks", "sessions"):
            assert got[key] == expected[key], key
        for key in ("rr_sum", "ce_loss"):
            assert got[key] == pytest.approx(expected[key], rel=1e-5), key
        block = slice(rank_index // MP * rows, (rank_index // MP + 1) * rows)
        assert set(rank["eval_fetches"]) == set(fetches)
        for key, value in fetches.items():
            np.testing.assert_array_equal(rank["eval_fetches"][key], value[block],
                                          err_msg=key)


def test_the_same_collectives_every_step(runs):
    """Only all-reduce, all-gather and broadcast (the eval's gather to rank
    0 is the harness's, not a step's); the same calls and bytes on every
    step and every rank; the gradients' all-reduce and the replicated ones'
    broadcast in a few buckets."""
    first = runs["ranks"][0]["steps"][0]["collectives"]
    assert {k for k, v in first.items() if v["calls"]} == {
        "all_reduce", "all_gather", "broadcast"}
    assert first["gather"] == {"calls": 0, "bytes": 0}
    for rank in runs["ranks"]:
        for step in rank["steps"]:
            assert step["collectives"] == first
    assert first["broadcast"]["calls"] == 1  # one bucket of replicated gradients
    local_bytes = sum(v.nbytes for v in runs["ranks"][0]["local_params"].values())
    assert first["all_reduce"]["bytes"] > local_bytes  # the gradients, and the rest

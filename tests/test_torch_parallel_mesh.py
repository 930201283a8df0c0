"""The port's (data x model) layout against the JAX package's.

``parallel/mesh.py``'s rule against JAX's ``params_sharding`` on the NAR
parameter trees of both packages: the conftest model at a small
``min_rows`` (the item embedding, the ACE matrix and a Dense kernel
sharded), and the G1 model at the default 4,096 rows (its 46,034-row tables
sharded at model parallelism 2, 46,033 rows replicated), each rank's rows
of each sharded leaf; ``make_mesh``'s errors; the batch's blocks by data
index.
"""
import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from chameleon_recsys_tpu.config import gcom_article_schema as jax_gcom_article_schema
from chameleon_recsys_tpu.config import gcom_session_schema as jax_gcom_session_schema
from chameleon_recsys_tpu.data.collate import collate_sessions as jax_collate
from chameleon_recsys_tpu.data.synthetic import make_synthetic_corpus, synthetic_hour_sessions
from chameleon_recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from chameleon_recsys_tpu.parallel.mesh import params_sharding as jax_params_sharding
from chameleon_recsys_tpu.train.steps import nar_init_state

from chameleon_recsys_tpu_torch.config import NARConfig, gcom_article_schema, gcom_session_schema
from chameleon_recsys_tpu_torch.convert import (
    _flax_path,
    adam_state_from_optax,
    params_from_flax,
    shard_from_jax,
)
from chameleon_recsys_tpu_torch.models.nar import NARModel
from chameleon_recsys_tpu_torch.parallel import distributed
from chameleon_recsys_tpu_torch.parallel.mesh import (
    MeshPlan,
    batch_sharding,
    make_mesh,
    params_sharding,
    row_shard,
)
from chameleon_recsys_tpu_torch.parallel.sharded import ShardedNARPrograms, model_sharding

from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema
from test_torch_serve import port_article_schema, port_config, port_session_schema


def plan_of(rank, dp, mp):
    """A rank's plan without a process group (the rules read the layout)."""
    return MeshPlan(dp * mp, rank, dp, mp, None, None, torch.device("cpu"), "gloo")


def jax_sharded_leaves(cfg, art, sess, ace_dim, mp, min_rows):
    """{Flax path: sharded over the model axis} of JAX's rule on the JAX
    model's parameter tree (shapes only), and whether the ACE matrix is."""
    plan = jax_make_mesh(data_parallelism=2, model_parallelism=mp,
                         devices=jax.devices()[:2 * mp])
    corpus_shape = (art.num_items, ace_dim)
    b, t = cfg.batch_size, cfg.max_session_length
    batch = {"item_clicked": np.zeros((b, t - 1), np.int32),
             "label_next_item": np.zeros((b, t - 1), np.int32),
             "label_last_item": np.zeros((b, 1), np.int32),
             "event_timestamp": np.zeros((b, t - 1), np.int64),
             "session_size": np.full(b, 2, np.int32)}
    for spec in sess.sequence:
        batch.setdefault(spec.name, np.zeros((b, t - 1), np.float32 if spec.dtype == "float"
                                             else np.int32))
    for spec in sess.single:
        batch.setdefault(spec.name, np.zeros(b, np.int32))
    metadata = {s.name: np.zeros(art.num_items, np.int32) for s in art.metadata_features()}
    metadata["created_at_ts"] = np.zeros(art.num_items, np.int64)
    ace = jax.ShapeDtypeStruct(corpus_shape, np.float32)
    state = jax.eval_shape(
        lambda *args: nar_init_state(cfg, sess, art, *args)[2], batch, ace, metadata)
    rule = jax_params_sharding(plan, state.params, min_rows=min_rows)
    flat = {jax.tree_util.keystr(path).replace("']['", "/").strip("[]'"): "model" in str(sh.spec)
            for path, sh in jax.tree_util.tree_flatten_with_path(rule)[0]}
    ace = jax_params_sharding(plan, ace, min_rows=min_rows)
    return flat, "model" in str(ace.spec)


def port_sharded_leaves(model, dp, mp, min_rows):
    """{Flax path: sharded} of the port's rule on each rank, checked to be
    the same leaves on every rank with the rank's rows of each."""
    names = dict(model.named_parameters())
    leaves = None
    for rank in range(dp * mp):
        plan = plan_of(rank, dp, mp)
        sharding = model_sharding(plan, model, min_rows)
        for name, spec in sharding.items():
            if spec is None:
                continue
            rows = names[name].shape[spec.dim]
            n = rows // mp
            assert spec.rows == (plan.model_index * n, (plan.model_index + 1) * n, rows)
        sharded = {_flax_path(name)[0]: spec is not None for name, spec in sharding.items()}
        assert leaves is None or sharded == leaves
        leaves = sharded
    return leaves


@pytest.mark.parametrize("mp", [1, 2])
def test_rule_matches_jax_on_the_tiny_model(mp):
    cfg = tiny_nar_config(matching_layer_sizes=(16, 8, 8))
    art, sess = tiny_article_schema(256), tiny_session_schema(256)
    jax_leaves, jax_ace = jax_sharded_leaves(cfg, art, sess, 8, mp, min_rows=64)
    model = NARModel(port_config(cfg), port_session_schema(sess), port_article_schema(art), 8)
    port_leaves = port_sharded_leaves(model, 2, mp, min_rows=64)
    assert port_leaves == jax_leaves
    assert any(port_leaves.values()) == (mp > 1)
    if mp > 1:
        assert port_leaves["item_clicked_embedding/embedding"]
        assert port_leaves["session_FC2/kernel"]  # a Dense kernel, [512, C] in Flax
    ace = params_sharding(plan_of(0, 2, mp), {"ace": torch.zeros(256, 8)}, 64)["ace"]
    assert (ace is not None) == jax_ace == (mp > 1)


@pytest.mark.parametrize("num_items,sharded", [(46_034, True), (46_033, False)])
def test_rule_matches_jax_on_the_g1_model(num_items, sharded):
    """The G1 widths (CAR 1024, UGRNN 255 x 2) at the default 4,096 rows: the
    item embedding and the ACE matrix alone are row-sharded, at an even
    catalog; an odd one is replicated."""
    cfg = NARConfig(batch_size=4)
    jax_cfg = jax_nar_config(cfg)
    art, sess = jax_gcom_article_schema(num_items), jax_gcom_session_schema(num_items)
    jax_leaves, jax_ace = jax_sharded_leaves(jax_cfg, art, sess, 250, 2, min_rows=4096)
    with torch.device("meta"):
        model = NARModel(cfg, gcom_session_schema(num_items), gcom_article_schema(num_items),
                         250)
    port_leaves = port_sharded_leaves(model, 2, 2, min_rows=4096)
    assert port_leaves == jax_leaves
    assert {k for k, v in port_leaves.items() if v} == (
        {"item_clicked_embedding/embedding"} if sharded else set())
    ace = params_sharding(plan_of(1, 2, 2), {"ace": torch.empty(num_items, 250,
                                                                device="meta")})["ace"]
    assert (ace is not None) == jax_ace == sharded
    if sharded:
        assert ace == (23_017, 46_034, 46_034)


def jax_nar_config(cfg):
    from chameleon_recsys_tpu.config import NARConfig as JaxNARConfig

    fields = {f.name for f in dataclasses.fields(JaxNARConfig)}
    return JaxNARConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                           if k in fields and k != "internal_features"})


def test_batch_blocks_and_row_shards():
    batch = {"item_clicked": np.zeros((8, 5)), "session_size": np.zeros(8),
             "scalar": np.zeros(())}
    for rank in range(4):
        plan = plan_of(rank, 2, 2)
        rows = batch_sharding(plan, batch)
        d = rank // 2
        assert rows["item_clicked"] == rows["session_size"] == slice(4 * d, 4 * d + 4)
        assert rows["scalar"] is None
        assert (plan.data_index, plan.model_index, plan.model_root) == (d, rank % 2, 2 * d)
        assert row_shard(plan, 10) == (5 * (rank % 2), 5 * (rank % 2) + 5, 10)


def test_make_mesh_errors():
    """Without a process group ``make_mesh`` refuses; over a world of one, a
    layout of another size raises JAX's ``ValueError`` with its message."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    distributed.initialize_multihost(f"localhost:{port}", 1, 0, backend="gloo")
    try:
        for dp, mp in ((2, 1), (None, 2), (1, 2)):
            with pytest.raises(ValueError) as jax_error:
                jax_make_mesh(data_parallelism=dp, model_parallelism=mp,
                              devices=jax.devices()[:1])
            with pytest.raises(ValueError) as port_error:
                make_mesh(dp, mp, device="cpu")
            assert str(port_error.value) == str(jax_error.value)
        plan = distributed.make_pod_mesh(1, device="cpu")
        assert (plan.world, plan.rank, plan.data_parallelism, plan.model_parallelism,
                plan.backend) == (1, 0, 1, 1, "gloo")
        # a group of one makes no call and counts nothing
        distributed.reset_counts()
        assert distributed.all_gather(torch.ones(3), plan.data_group)[0].sum() == 3
        distributed.all_reduce(torch.ones(3), plan.model_group)
        assert all(v["calls"] == 0 for v in distributed.counts.values())
    finally:
        dist.destroy_process_group()


def test_shard_from_jax_gives_each_rank_its_rows():
    """JAX's parameters and Adam state (as numpy) through
    ``convert.shard_from_jax``: each rank's rows of each row-sharded tensor,
    the whole of every other; the ranks' rows together are the whole."""
    cfg = tiny_nar_config(matching_layer_sizes=(16, 8, 8))
    art, sess = tiny_article_schema(256), tiny_session_schema(256)
    corpus = make_synthetic_corpus(art, ace_dim=8)
    batch = {k: jnp.asarray(v) for k, v in jax_collate(
        synthetic_hour_sessions(corpus, sess, 0, 8, cfg.max_session_length), sess,
        cfg.batch_size, cfg.max_session_length).items()}
    _, optimizer, state = nar_init_state(cfg, sess, art, batch, jnp.asarray(corpus.ace_matrix),
                                         {k: jnp.asarray(v) for k, v in corpus.metadata.items()})
    tree = jax.tree_util.tree_map(np.asarray, state.params)
    mu = jax.tree_util.tree_map(lambda p: np.asarray(p) * 0.5, state.params)
    nu = jax.tree_util.tree_map(lambda p: np.asarray(p) ** 2, state.params)
    adam = {"count": 3, "mu": mu, "nu": nu}
    model = NARModel(port_config(cfg), port_session_schema(sess), port_article_schema(art), 8)
    whole = params_from_flax(tree, model)
    whole_adam = adam_state_from_optax(3, mu, nu, model)
    names = [n for n, _ in model.named_parameters()]
    parts = {}
    for rank in range(4):
        plan = plan_of(rank, 2, 2)
        programs = ShardedNARPrograms(plan, model_sharding(plan, model, 64), None, 64)
        params, moments = shard_from_jax(tree, model, programs, adam)
        for index, name in enumerate(names):
            spec = programs.state_sharding[name]
            assert float(moments[index]["step"]) == 3.0
            for got, expected in ((params[name], whole[name]),
                                  (moments[index]["exp_avg"], whole_adam[index]["exp_avg"])):
                expected = torch.as_tensor(expected)
                want = expected if spec is None else spec.narrow(expected)
                np.testing.assert_array_equal(np.asarray(got), want.numpy(), err_msg=name)
            if spec is not None and rank // 2 == 0:
                parts.setdefault(name, []).append((spec.dim, params[name]))
    for name, shards in parts.items():
        dim = shards[0][0]
        np.testing.assert_array_equal(torch.cat([p for _, p in shards], dim).numpy(),
                                      whole[name].numpy())
    assert "item_clicked_embedding.weight" in parts

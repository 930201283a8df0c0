"""The harness's directory checkpoint (``save_checkpoint_dcp`` /
``load_checkpoint_dcp``, on ``torch.distributed.checkpoint``), the
counterpart of the JAX harness's orbax backend.

On one device: a directory of ``device_state/`` and the ``host_state.pkl``
sidecar with the JAX sidecar's keys; the state bit-equal after the load; the
next hour's loss equal to the pickle-resumed harness's and to the original
run's.  Over a 1 x 2 gloo world (this file's ``mesh_rank``; ranks spawned by
``tests/_torch_parallel_worker.py::run_world``), at a catalog the layout rule
row-shards: each rank writes its own rows of every sharded table (DCP's
metadata records one chunk a rank, in that rank's file, none the whole
table), the load gives back the rank's rows bit for bit, and the next hour's
loss equals the pickle-resumed run's; a directory written on one device
loads into the sharded layout (each rank its rows of it), as the JAX load
re-shards.  No JAX here: the spawned ranks import this module.
"""
import pickle

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from chameleon_recsys_tpu_torch.config import (
    ArticleFeaturesSchema,
    FeatureSpec,
    NARConfig,
    RunConfig,
    SessionFeaturesSchema,
)
from chameleon_recsys_tpu_torch.data.synthetic import (
    make_synthetic_corpus,
    synthetic_hour_sessions,
)
from chameleon_recsys_tpu_torch.train.temporal import TemporalHarness

from _torch_parallel_worker import run_world

NUM_ITEMS, SESSIONS, MIN_ROWS = 256, 16, 32
# the sidecar's keys: the JAX harness's (chameleon_recsys_tpu/train/temporal.py,
# save_checkpoint_orbax)
HOST_KEYS = {"hours_trained", "evals_done", "metrics_log", "host_cooccurrence",
             "host_first_click_step", "host_current_step", "host_benchmarks_states"}


def world():
    art = ArticleFeaturesSchema(features=(
        FeatureSpec("article_id", "categorical", NUM_ITEMS),
        FeatureSpec("created_at_ts", "numerical", dtype="int"),
        FeatureSpec("category_id", "categorical", 12),
    ))
    sess = SessionFeaturesSchema(
        single=(FeatureSpec("user_id", "categorical", 1000),
                FeatureSpec("session_id", "numerical", dtype="int"),
                FeatureSpec("session_start", "numerical", dtype="int"),
                FeatureSpec("session_size", "numerical", dtype="int")),
        sequence=(FeatureSpec("event_timestamp", "numerical", dtype="int"),
                  FeatureSpec("item_clicked", "categorical", NUM_ITEMS),
                  FeatureSpec("device", "categorical", 5)),
    )
    cfg = NARConfig(car_embedding_size=16, rnn_units=8, rnn_num_layers=2,
                    matching_layer_sizes=(16, 8, 8), negative_samples=4,
                    negative_sample_from_buffer=32, eval_negative_samples=4,
                    eval_negative_sample_from_buffer=32,
                    recent_clicks_buffer_max_size=128, recent_clicks_for_normalization=64,
                    batch_size=8, max_session_length=6, learning_rate=1e-3)
    corpus = make_synthetic_corpus(art, ace_dim=8)
    hours = [synthetic_hour_sessions(corpus, sess, h, SESSIONS, cfg.max_session_length)
             for h in range(3)]
    return cfg, art, sess, corpus, hours


def harness(model_dir, mesh_plan=None):
    cfg, art, sess, corpus, _ = world()
    return TemporalHarness(cfg, RunConfig(model_dir=str(model_dir),
                                          training_hours_for_each_eval=1),
                           sess, art, corpus.ace_matrix, corpus.metadata,
                           mesh_plan=mesh_plan, mesh_min_rows=MIN_ROWS, device="cpu")


def adam_state(h):
    return {name: {k: v.clone() for k, v in h.state.optimizer.state[p].items()}
            for name, p in h.state.model.named_parameters()}


def assert_same_state(a, b):
    for (name, p), q in zip(a.state.model.named_parameters(), b.state.model.parameters()):
        assert torch.equal(p, q), name
    moments_a, moments_b = adam_state(a), adam_state(b)
    assert moments_a.keys() == moments_b.keys()
    for name, fields in moments_a.items():
        for k, v in fields.items():
            assert torch.equal(v, moments_b[name][k]), (name, k)
    for field, value in a.state.stream._asdict().items():
        assert torch.equal(getattr(b.state.stream, field), value), field
    assert torch.equal(a.state.generator.get_state(), b.state.generator.get_state())
    assert a.state.step == b.state.step
    assert (a.hours_trained, a.evals_done) == (b.hours_trained, b.evals_done)
    assert a.artifacts.eval_sessions_metrics_log == b.artifacts.eval_sessions_metrics_log
    assert a.host_state.current_step == b.host_state.current_step


def test_dcp_round_trip_on_one_device(tmp_path):
    _, _, _, _, hours = world()
    h = harness(tmp_path / "run")
    h.run(lambda i: hours[i], range(2))  # train 0, evaluate 1, train 1
    path = h.save_checkpoint_dcp(tmp_path / "dcp")
    assert sorted(p.name for p in path.iterdir()) == ["device_state", "host_state.pkl"]
    with open(path / "host_state.pkl", "rb") as f:
        assert set(pickle.load(f)) == HOST_KEYS
    pickled = h.save_checkpoint(tmp_path / "ckpt.pkl")

    fresh = harness(tmp_path / "fresh")
    with pytest.raises(RuntimeError, match="init_state"):
        fresh.load_checkpoint_dcp(path)
    fresh.init_state()
    fresh.load_checkpoint_dcp(path)
    assert_same_state(h, fresh)
    resumed = harness(tmp_path / "resumed")
    resumed.load_checkpoint(pickled)
    # the next hour: bit for bit the pickle-resumed run's and the original's
    stats = [x.train_hour(hours[2]) for x in (h, fresh, resumed)]
    assert stats[0] == stats[1] == stats[2]
    assert_same_state(h, fresh)

    # the directory is replaced, not added to
    h.save_checkpoint_dcp(path)
    again = harness(tmp_path / "again")
    again.init_state()
    again.load_checkpoint_dcp(path)
    assert_same_state(h, again)


def mesh_rank(rank, tmp):
    """A 1 x 2 harness: train hour 0, write both checkpoints, then resume
    each into a new harness and train hour 1; then resume the one-device
    directory and pickle of the parent and train hour 1."""
    from chameleon_recsys_tpu_torch.parallel.mesh import make_mesh

    plan = make_mesh(1, 2, device="cpu")
    _, _, _, _, hours = world()
    h = harness(f"{tmp}/mesh{rank}", plan)
    h.train_hour(hours[0])
    h.save_checkpoint_dcp(f"{tmp}/mesh_dcp")
    h.save_checkpoint(f"{tmp}/mesh.pkl")
    local = {n: p.detach().clone() for n, p in h.state.model.named_parameters()}
    moments = adam_state(h)

    def resume(load, path):
        r = harness(f"{tmp}/resumed{rank}", plan)
        if load == "dcp":
            r.init_state()
            r.load_checkpoint_dcp(path)
        else:
            r.load_checkpoint(path)
        return r

    by_dcp, by_pickle = resume("dcp", f"{tmp}/mesh_dcp"), resume("pickle", f"{tmp}/mesh.pkl")
    same = all(torch.equal(p, local[n]) for n, p in by_dcp.state.model.named_parameters())
    same_moments = all(torch.equal(v, moments[n][k]) for n, fields in adam_state(by_dcp).items()
                       for k, v in fields.items())
    from_one_dcp = resume("dcp", f"{tmp}/one_dcp")
    from_one_pickle = resume("pickle", f"{tmp}/one.pkl")
    sharding = {n: (s.dim, s.rows.lo, s.rows.hi) for n, s in h._sharded.state_sharding.items()
                if s is not None}
    from_one_params = {n: p.detach().numpy().copy()
                       for n, p in from_one_dcp.state.model.named_parameters() if n in sharding}
    return {
        "sharding": sharding,
        "bit_equal": same and same_moments,
        "losses": [x.train_hour(hours[1])["avg_ce_loss"] for x in (h, by_dcp, by_pickle)],
        "from_one": [x.train_hour(hours[1])["avg_ce_loss"]
                     for x in (from_one_dcp, from_one_pickle)],
        "from_one_params": from_one_params,
    }


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dcp_mesh")
    _, _, _, _, hours = world()
    one = harness(tmp / "one")
    one.train_hour(hours[0])
    one.save_checkpoint_dcp(tmp / "one_dcp")
    one.save_checkpoint(tmp / "one.pkl")
    saved = {n: p.detach().numpy().copy() for n, p in one.state.model.named_parameters()}
    ranks = run_world(mesh_rank, 2, str(tmp))
    return {"tmp": tmp, "ranks": ranks, "one_params": saved,
            "one_loss": one.train_hour(hours[1])["avg_ce_loss"]}


def test_dcp_at_1x2_each_rank_writes_its_rows(mesh_runs):
    ranks = mesh_runs["ranks"]
    sharding = ranks[0]["sharding"]
    assert "item_clicked_embedding.weight" in sharding
    for rank, res in enumerate(ranks):
        assert res["bit_equal"], rank
        # the next hour from either checkpoint is the uninterrupted run's
        assert res["losses"][0] == res["losses"][1] == res["losses"][2], res["losses"]
    metadata = dcp.FileSystemReader(str(mesh_runs["tmp"] / "mesh_dcp" / "device_state")
                                    ).read_metadata()
    files = {}
    for index, info in metadata.storage_data.items():
        files.setdefault(index.fqn, []).append((tuple(index.offset), info.relative_path))
    for name, (dim, _, _) in sharding.items():
        for key in (f"model.{name}", f"adam.{name}.exp_avg", f"adam.{name}.exp_avg_sq"):
            chunks = metadata.state_dict_metadata[key].chunks
            rows = metadata.state_dict_metadata[key].size[dim]
            assert len(chunks) == 2 and all(c.sizes[dim] == rows // 2 for c in chunks), key
            # rank r's rows, and only they, in rank r's file
            written = sorted((offset[dim], path) for offset, path in files[key])
            assert written == [(0, "__0_0.distcp"), (rows // 2, "__1_0.distcp")], key
    # a replicated tensor is written once
    assert len(files["model.CAR_bias"]) == 1


def test_a_one_device_directory_loads_into_the_sharded_layout(mesh_runs):
    """Each rank reads its rows of the whole tables, as the JAX load
    re-shards; the next hour is the one-device run's next hour and the
    pickle-resumed mesh run's."""
    for res in mesh_runs["ranks"]:
        dcp_loss, pickle_loss = res["from_one"]
        assert dcp_loss == pickle_loss
        assert dcp_loss == pytest.approx(mesh_runs["one_loss"], rel=1e-5)
        for name, (dim, lo, hi) in res["sharding"].items():
            np.testing.assert_array_equal(
                res["from_one_params"][name],
                np.take(mesh_runs["one_params"][name], np.arange(lo, hi), axis=dim),
                err_msg=name)

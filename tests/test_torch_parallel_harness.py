"""The port's temporal harness over a 2 x 2 gloo world.

``parallel/dryrun.py`` at 2 x 2 (two train hours, the sharded eval with the
host tier, a checkpoint replayed); then a mesh harness
(``tests/_torch_parallel_worker.py::harness_rank``) against the one-device
harness at ``train_compaction_groups`` 2 on the same global batches over two
train hours and an eval hour, to the bounds of the JAX package's
``tests/test_multichip.py::test_single_vs_mesh_losses_and_eval`` (losses,
ranked lists click by click, HR and MRR) with the integer stream exactly
equal; and a checkpoint written at 2 x 2 resumed on one device, and one
written on one device resumed at 2 x 2, each training the next hour as the
run it came from does.
"""
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu_torch.baselines import (
    ItemCooccurrenceRecommender,
    RecentlyPopularRecommender,
)
from chameleon_recsys_tpu_torch.config import RunConfig
from chameleon_recsys_tpu_torch.data.synthetic import (
    make_synthetic_corpus,
    synthetic_hour_sessions,
)
from chameleon_recsys_tpu_torch.parallel import dryrun
from chameleon_recsys_tpu_torch.parallel.dryrun import dryrun_multichip
from chameleon_recsys_tpu_torch.train.temporal import BenchmarkSpec, TemporalHarness

from _torch_parallel_worker import harness_rank, run_world
from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema
from test_torch_serve import port_article_schema, port_config, port_session_schema

# at 32 rows the rule also shards four Dense kernels, which the ranks gather
# whole, in the same order on every rank
DP, MP, MIN_ROWS = 2, 2, 32
SHARDED = ["CAR_kernel", "matching_1_kernel", "item_clicked_embedding.weight",
           "rnn.layers.0.input_proj.weight", "session_FC2.weight"]
# Adam's first moves are ~lr * sign(g): gradients that are 0 up to f32
# noise make whole ranked lists part (tests/test_multichip.py's bounds)
IDENTICAL, TOP1, OVERLAP, LOSS_REL, METRIC_ABS = 0.45, 0.85, 0.9, 2e-2, 0.1


def test_dryrun_at_2x2():
    result = dryrun_multichip(4, "cpu")
    assert result["sharded"] == ["item_clicked_embedding.weight", "session_FC2.weight"]
    assert result["collectives"]["broadcast"]["calls"] > 0


def test_dryrun_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    """As every entry point of the port: the card by default, and an exit
    that names ``--platform cpu`` where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--platform cpu"):
        dryrun.main(["--devices", "2"])
    with pytest.raises(SystemExit, match="--platform cpu"):
        dryrun_multichip(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_harness")
    cfg = port_config(tiny_nar_config(
        batch_size=8, max_session_length=6, matching_layer_sizes=(16, 8, 8),
        train_valid_row_capacity=32, train_compaction_groups=DP))
    art = port_article_schema(tiny_article_schema(256))
    sess = port_session_schema(tiny_session_schema(256))
    corpus = make_synthetic_corpus(art, ace_dim=8)
    hours = [synthetic_hour_sessions(corpus, sess, h, 16, cfg.max_session_length)
             for h in range(3)]

    def single(name, **kw):
        return TemporalHarness(
            cfg, RunConfig(model_dir=str(tmp / name), training_hours_for_each_eval=2),
            sess, art, corpus.ace_matrix, corpus.metadata, device="cpu", **kw)

    # the host tier in full: two baselines, cold-start tracking, both logs
    host_tier = dict(benchmarks=[BenchmarkSpec(RecentlyPopularRecommender, {}),
                                 BenchmarkSpec(ItemCooccurrenceRecommender, {})],
                     eval_cold_start=True, log_negative_samples=True)
    one = single("one", log_recommendations=True, **host_tier)
    losses = [one.train_hour(hours[0])["avg_ce_loss"]]
    one.save_checkpoint(tmp / "one.pkl")
    losses.append(one.train_hour(hours[1])["avg_ce_loss"])
    stream = {k: v.numpy().copy() for k, v in one.state.stream._asdict().items()}
    row = one.evaluate_hour(hours[2])

    ranks = run_world(harness_rank, DP * MP, {
        "cfg": cfg, "sess": sess, "art": art, "ace": corpus.ace_matrix,
        "metadata": corpus.metadata, "hours": hours, "dp": DP, "mp": MP,
        "min_rows": MIN_ROWS, "model_dir": str(tmp / "mesh"),
        "mesh_checkpoint": str(tmp / "mesh.pkl"), "single_checkpoint": str(tmp / "one.pkl"),
        "host_tier": host_tier,
    })
    resumed = single("resumed")
    resumed.load_checkpoint(tmp / "mesh.pkl")
    return dict(losses=losses, stream=stream, row=row,
                recommendations=one.artifacts.sessions_chameleon_recommendations_log,
                negatives=one.artifacts.sessions_negative_items_log,
                resumed_loss=resumed.train_hour(hours[1])["avg_ce_loss"], ranks=ranks,
                cfg=cfg)


def test_every_rank_reports_the_global_metrics(runs):
    first = runs["ranks"][0]
    assert first["sharded"] == sorted(SHARDED)
    for rank in runs["ranks"][1:]:
        assert rank["losses"] == first["losses"]
        for key in ("hitrate_at_n", "mrr_at_n", "clicks_count", "sessions_count"):
            assert rank["row"][key] == first["row"][key], key
        # the host tier's metrics and logs are rank 0's
        assert "hitrate_at_n_chameleon" not in rank["row"]
        assert rank["recommendations"] == []


def test_two_hours_against_the_one_device_harness(runs):
    mesh = runs["ranks"][0]
    np.testing.assert_allclose(mesh["losses"], runs["losses"], rtol=LOSS_REL)
    for field, value in runs["stream"].items():
        np.testing.assert_array_equal(mesh["stream"][field], value, err_msg=field)
    top_n = runs["cfg"].metrics_top_n

    def ranked_lists(log):
        return {(row["session_id"], i): tuple(preds[:top_n])
                for row in log for i, preds in enumerate(row["predicted_item_ids"])}

    l1, l2 = ranked_lists(runs["recommendations"]), ranked_lists(mesh["recommendations"])
    assert set(l1) == set(l2) and len(l1) > 20
    identical = np.mean([l1[k] == l2[k] for k in l1])
    top1 = np.mean([l1[k][0] == l2[k][0] for k in l1])
    overlap = np.mean([len(set(l1[k]) & set(l2[k])) / len(l1[k]) for k in l1])
    print(f"ranked lists: identical {identical:.3f}, top-1 {top1:.3f}, "
          f"overlap {overlap:.3f}")
    assert identical >= IDENTICAL and top1 >= TOP1 and overlap >= OVERLAP
    row, expected = mesh["row"], runs["row"]
    for key in ("clicks_count", "sessions_count"):
        assert row[key] == expected[key], key
    for key in ("hitrate_at_n", "mrr_at_n"):
        assert row[key] == pytest.approx(expected[key], abs=METRIC_ABS), key
    for r in (row, expected):  # the device tier against the host tier, in each run
        assert r["hitrate_at_n"] == pytest.approx(r["hitrate_at_n_chameleon"])
        assert r["mrr_at_n"] == pytest.approx(r["mrr_at_n_chameleon"])


def test_the_host_tier_is_the_one_device_tier(runs):
    """The baselines learn from the global batch and rank the same sampled
    candidates, each data index its block: their metric columns and
    cold-start tallies, scored on rank 0, are the one-device harness's, as
    is the negatives log."""
    row, expected = runs["ranks"][0]["row"], runs["row"]
    keys = [k for k in expected if k.endswith(("_pop_recent", "_coocurrent"))]
    assert len(keys) >= 16
    for key in keys + ["coldstart_pop_recent", "coldstart_coocurrent"]:
        assert row[key] == expected[key], key
    assert row["coldstart_pop_recent"]["uniqueRecommendedItemsCount"] > 0
    assert runs["ranks"][0]["negatives"] == runs["negatives"]
    assert len(runs["negatives"]) > 10


def test_checkpoints_reshard_between_layouts(runs):
    """2 x 2 -> one device: the next hour's loss is the 2 x 2 run's; one
    device -> 2 x 2: it is the one-device run's (to the float noise of
    the summation order)."""
    mesh = runs["ranks"][0]
    assert runs["resumed_loss"] == pytest.approx(mesh["losses"][1], rel=1e-4)
    for rank in runs["ranks"]:
        assert rank["resumed_loss"] == pytest.approx(runs["losses"][1], rel=1e-4)

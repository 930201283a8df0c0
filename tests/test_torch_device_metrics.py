"""The eval metric set folded as tensor code (``metrics/device.py``) against
the host suite (``create_eval_metrics`` + ``update_metrics``), on the CPU.

1. ``MetricFold`` over three batches, its sums added into a fresh metric set
   (``add_batch_sums``, ``add_coverage_counts`` of its own bitmaps), against
   the host suite fed
   the same batches: random batches of G1's grid (256 sessions x 19 steps,
   top 10; 2,000 articles, ACE width 250) and the edge cases, each with
   HitRateBySessionPosition off and on.  Tolerances: exact for HR, the
   clicks and the coverage; relative 1e-12 for the float64 sums (MRR, NDCG,
   EILD-R, EILD-RR, the label popularity by position); 1e-6 for ESI-R and
   ESI-RR, whose ``-log2`` of the float32 popularity is float32 on both
   sides (numpy's and torch's differ by an ulp).
2. An eval hour of a small CPU harness with the fold set on it against the
   same hour on the host suite, from the same state; a harness on the CPU
   holds no fold.  Two such hours reseed the same bitmaps in place.
"""
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu_torch.cli import train_nar_synthetic
from chameleon_recsys_tpu_torch.metrics import (
    compute_metrics_results,
    create_eval_metrics,
    update_metrics,
)
from chameleon_recsys_tpu_torch.metrics.device import (
    SUMS,
    MetricFold,
    add_batch_sums,
    add_coverage_counts,
)

NUM_ITEMS, DIM, BATCH, STEPS = 2000, 250, 256, 19
NEGATIVE_RELEVANCE = 0.02
EXACT = ("hitrate_at_n", "item_coverage_at_n", "clicks_at_pos")
LOG2_OF_F32 = ("esi-r_at_n", "esi-rr_at_n")
WALL_CLOCK = ("elapsed_s", "per_s")


def _batch(rng, columns, case):
    """(predicted ids [B, T, columns] distinct a row, labels [B, T] valid as
    a prefix of each row, clicked ids [B, T]) by the traffic's length law."""
    preds = np.stack([rng.choice(np.arange(1, NUM_ITEMS), columns, replace=False)
                      for _ in range(BATCH * STEPS)]).reshape(BATCH, STEPS, columns)
    lengths = np.minimum(rng.zipf(2.25, BATCH) + 1, STEPS + 1)
    valid = np.arange(STEPS)[None, :] < (lengths - 1)[:, None]
    if case == "no_valid_click":
        valid[:] = False
    # the label in the top n a third of the time, elsewhere otherwise
    labels = rng.integers(1, NUM_ITEMS, (BATCH, STEPS))
    take = rng.random((BATCH, STEPS)) < 1 / 3
    labels = np.where(take, preds[..., 0] if case == "label_ranks" else
                      preds[np.arange(BATCH)[:, None], np.arange(STEPS)[None, :],
                            rng.integers(0, min(columns, 10), (BATCH, STEPS))], labels)
    if case == "label_ranks":  # at rank 1, at rank n, past the top n
        third = np.arange(STEPS) % 3
        labels = np.where(third == 1, preds[..., 9], labels)
        labels = np.where(third == 2, preds[..., columns - 1], labels)
    if case == "id_zero":
        preds[:, ::2, 3] = 0
    labels = np.where(valid, labels, 0)
    clicked = np.where(np.arange(STEPS)[None, :] < lengths[:, None],
                       rng.integers(1, NUM_ITEMS, (BATCH, STEPS)), 0)
    return preds.astype(np.int64), labels.astype(np.int32), clicked.astype(np.int32)


def _world(rng, case):
    ace = rng.normal(size=(NUM_ITEMS, DIM)).astype(np.float32)
    ace[0] = 0.0
    if case == "zero_ace_row":
        ace[1:NUM_ITEMS:7] = 0.0
    pop = np.maximum(rng.random(NUM_ITEMS) ** 3, 1e-3).astype(np.float32)
    buffer = np.concatenate([rng.integers(1, NUM_ITEMS, 300), np.zeros(40, np.int64)])
    return ace, pop, buffer.astype(np.int32)


def _assert_rows_agree(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        if key.endswith(WALL_CLOCK):
            continue
        have = got[key]
        if isinstance(value, float) and np.isnan(value):
            assert np.isnan(have), key
        elif key.startswith(EXACT):
            assert have == value, key
        elif key.startswith(LOG2_OF_F32):
            assert have == pytest.approx(value, rel=1e-6, abs=0.0), key
        else:
            assert have == pytest.approx(value, rel=1e-12, abs=0.0), key


@pytest.mark.parametrize("by_position", [False, True], ids=["flat", "by_position"])
@pytest.mark.parametrize("case", ["random", "full_ranking", "no_valid_click", "label_ranks",
                                  "zero_ace_row", "id_zero", "top_n_1"])
def test_fold_equals_host_suite(case, by_position):
    rng = np.random.default_rng(sum(map(ord, case)) + by_position)
    top_n = 1 if case == "top_n_1" else 10
    columns = {"full_ranking": 51, "label_ranks": 12}.get(case, 10)
    ace, pop, buffer = _world(rng, case)
    host = create_eval_metrics(top_n, NEGATIVE_RELEVANCE, by_position, ace, buffer)
    folded = create_eval_metrics(top_n, NEGATIVE_RELEVANCE, by_position, ace, buffer)
    fold = MetricFold(top_n, NEGATIVE_RELEVANCE, by_position)
    ace_t, pop_t = torch.from_numpy(ace), torch.from_numpy(pop)
    fold.seed_coverage(torch.from_numpy(buffer), NUM_ITEMS)
    for _ in range(3):
        preds, labels, clicked = _batch(rng, columns, case)
        update_metrics(preds, labels, pop[labels], pop[preds], clicked, host)
        out = fold(torch.from_numpy(preds), torch.from_numpy(labels), pop_t,
                   torch.from_numpy(clicked), ace_t)
        assert list(out) == [SUMS] and out[SUMS].dtype == torch.float64
        add_batch_sums(folded, out[SUMS].numpy())
    add_coverage_counts(folded, fold.coverage_counts())
    want = compute_metrics_results(host, "chameleon")
    got = compute_metrics_results(folded, "chameleon")
    _assert_rows_agree(got, want)
    if case == "no_valid_click":
        assert np.isnan(got["hitrate_at_n_chameleon"]) and np.isnan(got["mrr_at_n_chameleon"])
    if by_position and case != "no_valid_click":
        assert any(k.startswith("clicks_at_pos_") for k in got)


def test_normalized_copy_is_made_once_per_matrix():
    """The fold's float64 copy of the ACE matrix: zero rows stay zero, and
    a new copy is made only for another matrix or a written one."""
    fold = MetricFold(10, NEGATIVE_RELEVANCE, False)
    ace = torch.randn(50, 8)
    ace[3] = 0.0
    normed = fold.normalized(ace)
    assert normed.dtype == torch.float64 and fold.normalized(ace) is normed
    assert torch.equal(normed[3], torch.zeros(8, dtype=torch.float64))
    torch.testing.assert_close(normed[5].norm(), torch.tensor(1.0, dtype=torch.float64))
    ace.mul_(2.0)
    assert fold.normalized(ace) is not normed
    assert fold.normalized(ace.clone()) is not fold.normalized(ace)


def _small_harness():
    args = train_nar_synthetic.create_args_parser().parse_args(
        ["--platform", "cpu", "--num_items", "300", "--sessions_per_hour", "48",
         "--batch_size", "16", "--rnn_units", "16", "--car_size", "32",
         "--negatives", "12"])
    harness, source = train_nar_synthetic.build(
        args, "cpu", {"matching_layer_sizes": (16, 8, 8)})
    harness.eval_metrics_by_session_position = True
    return harness, source


def test_harness_hour_with_the_fold_equals_the_host_suite():
    """One eval hour on the host suite and one with the fold, from the same
    state and generator state: the same row under the tolerances above
    (the baselines' columns equal), HR equal to the step's ``hitrate_at_n``;
    the fold's span opened once a batch inside ``nar.eval.metrics``."""
    from chameleon_recsys_tpu_torch.utils import profiling

    harness, source = _small_harness()
    assert harness._metric_fold is None  # the CPU runs the host suite
    harness.train_hour(source(0))
    generator = harness.state.generator.get_state()
    want = harness.evaluate_hour(source(1))

    harness.state.generator.set_state(generator)
    harness._metric_fold = MetricFold(harness.cfg.metrics_top_n,
                                      harness.cfg.eval_negative_sample_relevance, True)
    was = profiling.set_tracing(True)
    saved = profiling.span_snapshot()
    profiling.reset_spans()
    try:
        got = harness.evaluate_hour(source(1))
        spans = profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()
        profiling._spans.update({k: list(v) for k, v in saved.items()})
    _assert_rows_agree(got, want)
    assert got["hitrate_at_n"] == got["hitrate_at_n_chameleon"]
    assert any(k.startswith("clicks_at_pos_chameleon_") for k in got)
    assert spans["nar.eval.metrics.device"][1] == spans["nar.eval.metrics"][1] > 0


def test_two_hours_reseed_the_same_bitmaps_in_place():
    """Two eval hours with the fold keep its ItemCoverage bitmaps where
    they are (one graph can read them every hour), reseed them at each
    hour's start, and count the host suite's ``item_coverage_at_n``."""
    harness, source = _small_harness()
    harness.train_hour(source(0))
    generator = harness.state.generator.get_state()
    want = [harness.evaluate_hour(source(hour)) for hour in (1, 2)]

    harness.state.generator.set_state(generator)
    fold = harness._metric_fold = MetricFold(
        harness.cfg.metrics_top_n, harness.cfg.eval_negative_sample_relevance, True)
    got, addresses = [], []
    for hour in (1, 2):
        got.append(harness.evaluate_hour(source(hour)))
        addresses.append(tuple(bits.data_ptr() for bits in fold.coverage))
    assert addresses[0] == addresses[1]
    key = "item_coverage_at_n_chameleon"
    assert [row[key] for row in got] == [row[key] for row in want]
    assert want[0][key] != want[1][key]

"""The learnable synthetic streams, the quality example and the small
helpers of the port against the JAX package.

1. The five generators of ``data/synthetic.py`` (``make_churn_corpus``,
   ``make_transition_graph``, ``synthetic_markov_hour_sessions``,
   ``synthetic_contextual_hour_sessions``, ``synthetic_churn_hour_sessions``)
   bit-equal to JAX's at two catalog sizes and two hours: every corpus
   field, the graph, every ``Session`` field.
2. ``cli/train_nar_synthetic.py`` against ``examples/train_nar_synthetic.py``
   on each stream, both built by their own code at a tiny size (60 items,
   3 hours of 24 sessions, one training hour an eval, batch 8, CAR 16, UGRNN
   8, matching 16/8/8 and the learning rate 1e-4 through ``cfg_overrides``
   on the port and a ``NARConfig`` patched the same way on JAX; the JAX
   example runs through its ``main``).  At the example's 1e-3, Adam's first
   moves (~lr times the sign of gradients that are 0 up to f32 rounding,
   ROADMAP section 3) part the two runs' probabilities by up to 6.9e-5 on
   the contextual stream within nine steps (2e-7 on the other two), past
   the near-tie gap; at 1e-4, as ``tests/test_torch_train_step.py`` runs,
   by 1e-7 on all three.  The port starts from the JAX harness's initial weights
   (``params_from_flax``) and draws JAX's sampler uniforms (the key chain
   of ``tests/test_torch_temporal.py::jax_draws``).  Both streams start
   with hour 0's clicks folded in: on an empty click buffer the jitted JAX
   step's novelty feature is ill-conditioned (ROADMAP section 3), as in
   ``tests/test_torch_temporal.py``.  The baseline columns are bit-equal;
   CHAMELEON's at ``tests/test_torch_temporal.py``'s tolerances (1e-6, and
   one label's share per near tie ranked the other way).
3. ``config.replace``, ``SessionFeaturesSchema.by_name``,
   ``utils.io.gini_index`` / ``min_max_scale`` and
   ``models.towers.towers_output_dim`` return what JAX's return.
4. The example takes the card unless ``--platform cpu`` is given.
"""
import dataclasses
import json
import runpy
import sys
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chameleon_recsys_tpu.config as jax_config
from chameleon_recsys_tpu.data import synthetic as jax_synthetic
from chameleon_recsys_tpu.models.towers import towers_output_dim as jax_towers_output_dim
from chameleon_recsys_tpu.state.stream_state import update_stream_state
from chameleon_recsys_tpu.train.steps import _batch_all_clicks
from chameleon_recsys_tpu.train.temporal import TemporalHarness as JaxTemporalHarness
from chameleon_recsys_tpu.utils import io as jax_io

from chameleon_recsys_tpu_torch import config as port_config
from chameleon_recsys_tpu_torch.cli import train_nar_synthetic
from chameleon_recsys_tpu_torch.convert import params_from_flax, stream_from_numpy
from chameleon_recsys_tpu_torch.data import synthetic as port_synthetic
from chameleon_recsys_tpu_torch.models.towers import towers_output_dim
from chameleon_recsys_tpu_torch.utils import io as port_io

from test_torch_temporal import _near_tie_swaps, jax_draws

ROOT = Path(__file__).resolve().parents[1]
JAX_EXAMPLE = ROOT / "examples" / "train_nar_synthetic.py"
EXAMPLE_ARGV = ["--hours", "3", "--eval_every", "1", "--sessions_per_hour", "24",
                "--num_items", "60", "--car_size", "16", "--rnn_units", "8",
                "--batch_size", "8"]
OVERRIDES = {"matching_layer_sizes": (16, 8, 8), "learning_rate": 1e-4}
# the column suffixes of the example's baselines (content-based on churn)
BASELINES = ("_pop_recent", "_coocurrent", "_sr", "_cb")


def schemas(config, num_items):
    """The example's schemas, in ``config``'s classes."""
    spec = config.FeatureSpec
    art = config.ArticleFeaturesSchema(features=(
        spec("article_id", "categorical", num_items),
        spec("created_at_ts", "numerical", dtype="int"),
        spec("category_id", "categorical", 20),
    ))
    sess = config.SessionFeaturesSchema(
        single=(spec("user_id", "categorical", 100000),
                spec("session_id", "numerical", dtype="int"),
                spec("session_start", "numerical", dtype="int"),
                spec("session_size", "numerical", dtype="int")),
        sequence=(spec("event_timestamp", "numerical", dtype="int"),
                  spec("item_clicked", "categorical", num_items),
                  spec("device", "categorical", 5),
                  spec("hour_sin", "numerical", dtype="float")),
    )
    return art, sess


def assert_corpus_equal(port, jax_corpus):
    assert port.num_items == jax_corpus.num_items
    assert port.metadata.keys() == jax_corpus.metadata.keys()
    for name, column in jax_corpus.metadata.items():
        assert port.metadata[name].dtype == column.dtype, name
        np.testing.assert_array_equal(port.metadata[name], column, err_msg=name)
    for field in ("ace_matrix", "item_popularity"):
        a, b = getattr(port, field), getattr(jax_corpus, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def assert_sessions_equal(port, jax_sessions):
    assert len(port) == len(jax_sessions) > 0
    for a, b in zip(port, jax_sessions):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("num_items", [60, 1500])
def test_generators_bit_equal_jax(num_items):
    (j_art, j_sess), (p_art, p_sess) = (schemas(jax_config, num_items),
                                        schemas(port_config, num_items))
    graph = port_synthetic.make_transition_graph(num_items)
    np.testing.assert_array_equal(graph, jax_synthetic.make_transition_graph(num_items))
    corpus = port_synthetic.make_synthetic_corpus(p_art, ace_dim=64)
    j_corpus = jax_synthetic.make_synthetic_corpus(j_art, ace_dim=64)
    churn = port_synthetic.make_churn_corpus(p_art, ace_dim=64, stream_hours=6)
    j_churn = jax_synthetic.make_churn_corpus(j_art, ace_dim=64, stream_hours=6)
    assert_corpus_equal(churn, j_churn)  # the births are created_at_ts
    for hour in (0, 3):
        assert_sessions_equal(
            port_synthetic.synthetic_markov_hour_sessions(corpus, p_sess, graph, hour, 24, 12),
            jax_synthetic.synthetic_markov_hour_sessions(j_corpus, j_sess, graph, hour, 24, 12))
        assert_sessions_equal(
            port_synthetic.synthetic_contextual_hour_sessions(
                corpus, p_sess, hour, 24, successors_per_context=5, max_session_length=12),
            jax_synthetic.synthetic_contextual_hour_sessions(
                j_corpus, j_sess, hour, 24, successors_per_context=5, max_session_length=12))
        assert_sessions_equal(
            port_synthetic.synthetic_churn_hour_sessions(churn, p_sess, hour, 24,
                                                         max_session_length=12),
            jax_synthetic.synthetic_churn_hour_sessions(j_churn, j_sess, hour, 24,
                                                        max_session_length=12))


def run_jax_example(argv, model_dir):
    """``examples/train_nar_synthetic.py``'s ``main`` on ``argv`` with
    ``OVERRIDES`` over its ``NARConfig``, the recommendation log on, its
    stream warmed with hour 0's clicks; returns the harness and its initial
    parameters, warm stream and raw key."""
    captured = {}
    real_run, real_cfg = JaxTemporalHarness.run, jax_config.NARConfig
    real_init = JaxTemporalHarness.__init__

    def init(self, *args, **kw):
        real_init(self, *args, log_recommendations=True, **kw)

    def run(self, hour_source, hours):
        hours = list(hours)
        self.init_from_batch(next(iter(self._batches(hour_source(hours[0])))))
        stream = self.state.stream
        for batch in self._batches(hour_source(hours[0])):
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            stream = update_stream_state(stream, *_batch_all_clicks(batch), self.cfg)
        self.state = self.state._replace(stream=stream)
        captured.update(
            harness=self, params=jax.tree_util.tree_map(np.asarray, self.state.params),
            stream={k: np.asarray(v).copy() for k, v in stream._asdict().items()},
            rng=np.asarray(self.state.rng).copy())
        return real_run(self, hour_source, hours)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(JaxTemporalHarness, "__init__", init)
        patch.setattr(JaxTemporalHarness, "run", run)
        patch.setattr(jax_config, "NARConfig", lambda **kw: real_cfg(**{**kw, **OVERRIDES}))
        patch.setattr(tempfile, "mkdtemp", lambda prefix="": str(model_dir))
        patch.setattr(sys, "argv", [str(JAX_EXAMPLE)] + argv)
        runpy.run_path(str(JAX_EXAMPLE))["main"]()
    return captured


def read_log(harness):
    path = Path(harness.run_cfg.model_dir) / "eval_chameleon_recommendations_log.json"
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("stream", ["markov", "contextual", "churn"])
def test_example_matches_jax(stream, tmp_path, monkeypatch):
    argv = EXAMPLE_ARGV + ["--stream", stream]
    jax_run = run_jax_example(argv, tmp_path / "jax")
    jax_h = jax_run["harness"]
    jax_rows = jax_h.artifacts.eval_sessions_metrics_log

    args = train_nar_synthetic.create_args_parser().parse_args(argv + ["--platform", "cpu"])
    real_harness = train_nar_synthetic.TemporalHarness
    monkeypatch.setattr(train_nar_synthetic, "TemporalHarness",
                        lambda *a, **kw: real_harness(*a, log_recommendations=True, **kw))
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": str(tmp_path / "port"))
    harness, hour_source = train_nar_synthetic.build(args, "cpu", OVERRIDES)
    assert dataclasses.asdict(harness.cfg) == dataclasses.asdict(jax_h.cfg)
    harness.init_state()
    harness.state.model.load_state_dict(params_from_flax(jax_run["params"],
                                                         harness.state.model))
    harness.state = harness.state._replace(
        stream=stream_from_numpy(jax_run["stream"], device="cpu"))
    with jax_draws(types.SimpleNamespace(cfg=jax_h.cfg), jax_run["rng"]):
        rows = harness.run(hour_source, range(args.hours))
    harness.export_artifacts()

    assert len(rows) == len(jax_rows) == 2
    swaps = _near_tie_swaps(read_log(harness), read_log(jax_h))
    if swaps:
        print("near ties ranked the other way:", swaps)
    compared = 0
    for row, jax_row in zip(rows, jax_rows):
        assert set(row) == set(jax_row)
        assert (row["clicks_count"], row["sessions_count"]) == (
            jax_row["clicks_count"], jax_row["sessions_count"])
        rank_tol = 1e-6 + len(swaps) / row["clicks_count"]
        for key, value in jax_row.items():
            if key.endswith(BASELINES):
                assert row[key] == value, key
                compared += 1
            elif key in ("hitrate_at_n", "mrr_at_n") or key.endswith("_chameleon"):
                tol = rank_tol if any(m in key for m in ("hitrate", "mrr", "ndcg")) else 1e-6
                assert row[key] == pytest.approx(value, abs=tol), key
    assert compared >= 2 * 8 * 3


def test_helpers_match_jax():
    cfg = port_config.NARConfig(rnn_units=8)
    j_cfg = jax_config.NARConfig(rnn_units=8)
    assert dataclasses.asdict(port_config.replace(cfg, rnn_units=12, batch_size=4)) == \
        dataclasses.asdict(jax_config.replace(j_cfg, rnn_units=12, batch_size=4))
    (j_art, j_sess), (p_art, p_sess) = schemas(jax_config, 300), schemas(port_config, 300)
    for name in ("user_id", "session_size", "item_clicked", "hour_sin"):
        assert dataclasses.asdict(p_sess.by_name(name)) == \
            dataclasses.asdict(j_sess.by_name(name))
    with pytest.raises(KeyError):
        p_sess.by_name("article_id")
    rng = np.random.RandomState(3)
    for values in (rng.lognormal(size=200), np.zeros(5), [], [3.0], rng.randint(0, 9, 50)):
        assert port_io.gini_index(values) == jax_io.gini_index(values)
    for values, bounds in ((rng.randn(40), (0.0, 1.0)), (rng.randn(7), (-0.1, 0.1)),
                           (np.full(4, 2.5), (0.0, 1.0))):
        np.testing.assert_array_equal(port_io.min_max_scale(values, bounds),
                                      jax_io.min_max_scale(values, bounds))
    for features in (p_art.features, p_sess.sequence, p_sess.single):
        jax_features = tuple(jax_config.FeatureSpec(**dataclasses.asdict(f)) for f in features)
        for ohe, mult in ((10, 8), (4, 8), (10, 4)):
            assert towers_output_dim(features, ohe, mult) == \
                jax_towers_output_dim(jax_features, ohe, mult)


def test_example_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--platform", "cuda"], ["--platform", "gpu"]):
        with pytest.raises(SystemExit, match="--platform cpu"):
            train_nar_synthetic.main(argv + ["--hours", "1"])

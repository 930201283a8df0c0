"""The neural baselines' temporal runner and their CLIs: the port
(``baselines/neural_runner.py``, ``cli/run_gru4rec.py``, ``cli/run_sr_gnn.py``)
against the JAX package's, on the CPU.

Each pair of runs starts from JAX's initial weights (recorded by a subclass
of the JAX model that the JAX run constructs); GRU4Rec's negative draws are
JAX's, reproduced from its key chain and injected
(``test_torch_gru4rec.inject``); SR-GNN's negatives and the runner's fresh
eval negatives come from numpy ``RandomState``s of the same seeds in both.
The eval rows (the runner's, the CLIs' CSVs) agree at rel / abs 1e-6: the
same ranked lists give the same metrics up to the float64 sums' order.
"""
import csv
import json

import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.baselines import gru4rec as jax_gru4rec
from chameleon_recsys_tpu.baselines import neural_runner as jax_runner
from chameleon_recsys_tpu.baselines import sr_gnn as jax_sr_gnn
from chameleon_recsys_tpu.cli import run_gru4rec as jax_run_gru4rec
from chameleon_recsys_tpu.cli import run_sr_gnn as jax_run_sr_gnn
from chameleon_recsys_tpu.data.synthetic import (
    make_synthetic_corpus as jax_corpus,
    synthetic_hour_sessions as jax_hour_sessions,
)
from chameleon_recsys_tpu.metrics.evaluation import (
    create_eval_metrics as jax_create_eval_metrics,
)
from chameleon_recsys_tpu.utils import jax_cache

import chameleon_recsys_tpu_torch as port
from chameleon_recsys_tpu_torch.baselines import gru4rec, sr_gnn
from chameleon_recsys_tpu_torch.baselines.neural_runner import (
    NeuralBaselineRunner,
    load_eval_negative_samples,
    mean_of_scalars,
)
from chameleon_recsys_tpu_torch.cli import run_gru4rec, run_sr_gnn
from chameleon_recsys_tpu_torch.config import gcom_session_schema
from chameleon_recsys_tpu_torch.convert import (
    gru4rec_params_from_jax,
    srgnn_params_from_jax,
)
from chameleon_recsys_tpu_torch.data.collate import Session
from chameleon_recsys_tpu_torch.data.sessions import write_sessions_tfrecord
from chameleon_recsys_tpu_torch.data.synthetic import (
    make_synthetic_corpus,
    synthetic_hour_sessions,
)
from chameleon_recsys_tpu_torch.metrics.evaluation import create_eval_metrics

from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema
from test_torch_gru4rec import inject, jax_draws, jax_fields

TOL = 1e-6


class RecordingGRU4RecJax(jax_gru4rec.GRU4RecJax):
    """The JAX model, recording its initial weights and each step's draws."""

    recommender_name = "gru4rec"  # what the JAX runner names GRU4RecJax

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial = jax_fields(self.params)
        self.negatives, self.masks = [], []

    def fit_batch(self, items, labels, buffer_ids):
        indices, masks = jax_draws(self, items, buffer_ids)
        self.negatives.append(indices)
        self.masks.extend(masks)
        return super().fit_batch(items, labels, buffer_ids)


class RecordingSRGNNJax(jax_sr_gnn.SRGNNJax):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial = {k: np.asarray(v) for k, v in self.params._asdict().items()}


def port_gru4rec_from(recorder, monkeypatch):
    """A constructor of port GRU4Rec models that start from ``recorder``'s
    initial weights and draw its negatives and masks."""
    inject(monkeypatch, list(recorder.negatives), list(recorder.masks))

    def make(*args, **kwargs):
        model = gru4rec.GRU4Rec(*args, **kwargs)
        model.params.load_state_dict(gru4rec_params_from_jax(recorder.initial, model.params))
        return model
    return make


def port_srgnn_from(recorder):
    def make(*args, **kwargs):
        model = sr_gnn.SRGNN(*args, **kwargs)
        model.params.load_state_dict(srgnn_params_from_jax(recorder.initial, model.params))
        return model
    return make


def assert_rows_match(got, expected):
    assert len(got) == len(expected) and got
    for row, ref in zip(got, expected):
        assert list(row) == list(ref)
        for key, value in ref.items():
            assert float(row[key]) == pytest.approx(float(value), rel=TOL, abs=TOL), key


# ---------------------------------------------------------------------------
# The runner over synthetic hours
# ---------------------------------------------------------------------------

def _runner_world(n_items=100):
    """The tiny stream of ``tests/test_neural_runner.py`` in both packages:
    (port, jax) pairs of the config, the hour source and the metrics."""
    jax_cfg = tiny_nar_config(batch_size=8, max_session_length=6)
    art, sess = tiny_article_schema(n_items), tiny_session_schema(n_items)
    cfg = port.NARConfig(**{f: getattr(jax_cfg, f) for f in (
        "batch_size", "max_session_length", "metrics_top_n", "eval_negative_samples",
        "recent_clicks_buffer_max_size", "recent_clicks_for_normalization")})
    p_art = port.ArticleFeaturesSchema(features=tuple(
        port.FeatureSpec(f.name, f.kind, f.cardinality, dtype=f.dtype) for f in art.features))
    p_sess = port.SessionFeaturesSchema(
        single=tuple(port.FeatureSpec(f.name, f.kind, f.cardinality, dtype=f.dtype)
                     for f in sess.single),
        sequence=tuple(port.FeatureSpec(f.name, f.kind, f.cardinality, dtype=f.dtype)
                       for f in sess.sequence))
    jax_world = jax_corpus(art, ace_dim=8)
    corpus = make_synthetic_corpus(p_art, ace_dim=8)
    np.testing.assert_array_equal(corpus.ace_matrix, jax_world.ace_matrix)

    def metrics(create, ace):
        return lambda: create(cfg.metrics_top_n, 0.02, False, ace, np.zeros(10, np.int64))

    return (
        (cfg, p_sess, lambda h: synthetic_hour_sessions(corpus, p_sess, h, 16, 6),
         metrics(create_eval_metrics, corpus.ace_matrix)),
        (jax_cfg, sess, lambda h: jax_hour_sessions(jax_world, sess, h, 16, 6),
         metrics(jax_create_eval_metrics, jax_world.ace_matrix)),
    )


@pytest.mark.parametrize("name", ["gru4rec", "sr-gnn"])
def test_runner_matches_jax(name, monkeypatch):
    """Three hours, two training hours an eval, fresh eval negatives from
    the runner's own draws: the eval row, and each hour's mean loss."""
    (cfg, sess, source, metrics), (j_cfg, j_sess, j_source, j_metrics) = _runner_world()
    if name == "gru4rec":
        recorder = RecordingGRU4RecJax(100, layers=(16,), n_sample=16, seed=0)
        jax_model = recorder
    else:
        recorder = RecordingSRGNNJax(100, hidden_size=12, seed=0)
        jax_model = jax_sr_gnn.SRGNNSessionAdapter(recorder, n_sample=16)
    jax_losses, losses = [], []

    class JaxRunner(jax_runner.NeuralBaselineRunner):
        def train_hour(self, sessions, update_buffer=True):
            jax_losses.append(super().train_hour(sessions, update_buffer))
            return jax_losses[-1]

    class Runner(NeuralBaselineRunner):
        def train_hour(self, sessions, update_buffer=True):
            losses.append(super().train_hour(sessions, update_buffer))
            return losses[-1]

    expected = JaxRunner(jax_model, j_cfg, j_sess, 100, j_metrics).run(
        j_source, hours=range(3), training_hours_for_each_eval=2)
    if name == "gru4rec":
        model = port_gru4rec_from(recorder, monkeypatch)(100, layers=(16,), n_sample=16,
                                                         device="cpu")
    else:
        model = sr_gnn.SRGNNSessionAdapter(
            port_srgnn_from(recorder)(100, hidden_size=12, device="cpu"), n_sample=16)
    runner = Runner(model, cfg, sess, 100, metrics)
    rows = runner.run(source, hours=range(3), training_hours_for_each_eval=2)
    assert runner.recommender_name() == name
    assert f"hitrate_at_n_{name}" in rows[0]
    assert_rows_match(rows, expected)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)


def test_click_buffer_matches_jax():
    """The runner's host click buffer (numpy arrays, newest first) holds
    what the JAX runner's list of (id, ts) pairs holds after each batch:
    clicks more than an hour older than a batch's oldest dropped, the
    newest ``recent_clicks_buffer_max_size`` kept, padding skipped."""
    from chameleon_recsys_tpu.config import NARConfig as JaxNARConfig
    from chameleon_recsys_tpu_torch.config import NARConfig

    kw = dict(batch_size=4, max_session_length=5, recent_clicks_buffer_max_size=40)
    ours = NeuralBaselineRunner(None, NARConfig(**kw), None, 50, lambda: [])
    theirs = jax_runner.NeuralBaselineRunner(None, JaxNARConfig(**kw), None, 50, lambda: [])
    assert np.array_equal(ours._buffer_ids(), theirs._buffer_ids())
    rng = np.random.RandomState(0)
    t0 = 1000
    for step in range(30):
        t0 += int(rng.choice([60, 900, 4000]))
        items = rng.randint(1, 50, size=(4, 4)) * (rng.rand(4, 4) < 0.7)
        ts = np.where(items != 0, t0 + rng.randint(0, 600, size=(4, 4)), 0)
        batch = {"item_clicked": items.astype(np.int32), "event_timestamp": ts.astype(np.int32),
                 "label_last_item": rng.randint(0, 50, size=(4, 1)).astype(np.int32)}
        ours._update_buffer(batch)
        theirs._update_buffer(batch)
        np.testing.assert_array_equal(ours._buffer_ids(), theirs._buffer_ids(), err_msg=str(step))


def test_mean_of_scalars_mixes_tensors_and_floats():
    assert mean_of_scalars([torch.tensor(1.0), 0.0, torch.tensor(5.0)]) == 2.0
    assert mean_of_scalars([1.5, 2.5]) == 2.0


# ---------------------------------------------------------------------------
# The CLIs over session TFRecord hours
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hour_files(tmp_path_factory):
    """Three hourly session files (``tests/test_neural_cli.py``'s), and an
    eval-negatives log for half of the eval hour's sessions (the other half
    draws fresh negatives)."""
    root = tmp_path_factory.mktemp("hours")
    num_items = 60
    schema = gcom_session_schema(num_items=num_items)
    rng = np.random.RandomState(0)
    log = []
    for h in range(3):
        sessions = []
        for i in range(10):
            n = int(rng.randint(2, 6))
            start = 1000 + h * 3600 + i * 60
            sessions.append(Session(
                session_id=start * 100 + i,
                user_id=int(rng.randint(1, 30)),
                session_start=start,
                item_ids=rng.randint(1, num_items, n).tolist(),
                timestamps=(start + np.arange(n) * 10).tolist(),
                context={
                    s.name: rng.randint(1, max(s.cardinality, 2), n).tolist()
                    if s.kind == "categorical" else rng.uniform(-1, 1, n).tolist()
                    for s in schema.context_sequence_features()
                },
            ))
            if h == 2 and i % 2 == 0:
                log.append({"session_id": str(start * 100 + i), "negative_items": [
                    rng.randint(1, num_items, 5).tolist() for _ in range(n - 1)]})
        write_sessions_tfrecord(sessions, schema, root / f"h_{h:03d}.tfrecord.gz")
    negatives = root / "eval_sessions_negative_samples.json"
    negatives.write_text("".join(json.dumps(r) + "\n" for r in log))
    return root, num_items, negatives


def _cli_argv(hour_files, out_csv, *extra):
    root, num_items, negatives = hour_files
    return ["--train_set_path_regex", str(root / "h_*.tfrecord.gz"),
            "--eval_sessions_negative_samples_json_path", str(negatives),
            "--num_items", str(num_items), "--output_csv", str(out_csv),
            "--training_hours_for_each_eval", "2", "--batch_size", "8",
            "--truncate_session_length", "6", "--n_sample", "16",
            "--eval_total_negative_samples", "5", "--eval_metrics_top_n", "3", *extra]


def _csv_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_load_eval_negative_samples(hour_files):
    loaded = load_eval_negative_samples(hour_files[2])
    assert len(loaded) == 5 and all(isinstance(k, str) for k in loaded)
    assert loaded == jax_runner.load_eval_negative_samples(hour_files[2])


@pytest.mark.parametrize("cli", ["run_gru4rec", "run_sr_gnn"])
def test_cli_matches_jax(cli, hour_files, tmp_path, monkeypatch):
    """Each CLI with the JAX CLI's flags (``--platform cpu`` added) writes
    the JAX CLI's CSV: the same columns, every value at 1e-6."""
    monkeypatch.setattr(jax_cache, "enable_persistent_compile_cache", lambda: None)
    if cli == "run_gru4rec":
        extra = ["--layers", "12"]
        recorders = []
        monkeypatch.setattr(jax_run_gru4rec, "GRU4RecJax", lambda *a, **k: recorders.append(
            RecordingGRU4RecJax(*a, **k)) or recorders[-1])
        jax_run_gru4rec.main(_cli_argv(hour_files, tmp_path / "jax.csv", *extra))
        monkeypatch.setattr(run_gru4rec, "GRU4Rec",
                            port_gru4rec_from(recorders[0], monkeypatch))
        run_gru4rec.main(_cli_argv(hour_files, tmp_path / "port.csv", *extra,
                                   "--platform", "cpu"))
    else:
        extra = ["--hidden_size", "12"]
        recorders = []
        monkeypatch.setattr(jax_run_sr_gnn, "SRGNNJax", lambda *a, **k: recorders.append(
            RecordingSRGNNJax(*a, **k)) or recorders[-1])
        jax_run_sr_gnn.main(_cli_argv(hour_files, tmp_path / "jax.csv", *extra))
        monkeypatch.setattr(run_sr_gnn, "SRGNN", port_srgnn_from(recorders[0]))
        run_sr_gnn.main(_cli_argv(hour_files, tmp_path / "port.csv", *extra,
                                  "--platform", "cpu"))
    rows = _csv_rows(tmp_path / "port.csv")
    suffix = "gru4rec" if cli == "run_gru4rec" else "sr-gnn"
    assert len(rows) == 1 and f"hitrate_at_n_{suffix}" in rows[0]
    assert_rows_match(rows, _csv_rows(tmp_path / "jax.csv"))


@pytest.mark.parametrize("module", [run_gru4rec, run_sr_gnn], ids=["gru4rec", "sr_gnn"])
def test_cli_exits_without_a_card_unless_asked_for_the_cpu(module, hour_files, tmp_path,
                                                           monkeypatch):
    """Without a card the CLIs stop before reading anything: no fallback to
    the CPU unless ``--platform cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ([], ["--platform", "cuda"], ["--platform", "gpu"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            module.main(_cli_argv(hour_files, tmp_path / "out.csv", *platform))
    assert not (tmp_path / "out.csv").exists()

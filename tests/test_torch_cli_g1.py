"""The port's G1 pipeline through its CLIs against the JAX package's.

Each package runs its own chain on the CPU: ``make_pseudo_g1`` (6 hours,
300 articles, 8-wide ACEs, mixed regime, ~100 sessions an hour on average;
the stream starts at local midnight, so these night hours hold ~30) ->
``nar_preprocess_gcom`` -> ``nar_trainer_gcom`` at tiny model widths with
``--platform cpu``, float32, over files 1-5 (train 1-2, eval 3, train 3-4,
eval 5, train 5) with all six classical baselines, the logs, the scalars,
the histograms and an artifact store.

The two trainers initialise their weights from their own RNGs, so the test
reuses ``tests/test_torch_temporal.py``'s machinery: the JAX harness the
JAX CLI builds records its initial params and key, both harnesses start
from the stream with file 0's clicks folded in (the jitted JAX step's
novelty feature is ill-conditioned on an empty click buffer, ROADMAP
section 3), the port's harness loads the params through
``convert.params_from_flax``, and ``jax_draws`` injects the JAX steps'
sampler uniforms into the port's steps.

Checked: the same artifact files (in ``model_dir`` and in the store), the
same CSV columns in the same order, the same rows and ``eval_hour`` /
``eval_day``, every baseline column bit-equal, the negative-sample logs
equal, the CHAMELEON columns within ``test_torch_temporal.py``'s
tolerances (1e-6, widened by one label's share per near tie ranked the
other way).  Each flag of a feature not ported yet exits before any file is
read, and so does a run that asks for the card where there is none.
"""
import csv
import gzip
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.cli import make_pseudo_g1 as jax_make_pseudo_g1
from chameleon_recsys_tpu.cli import nar_preprocess_gcom as jax_preprocess
from chameleon_recsys_tpu.cli import nar_trainer_gcom as jax_trainer
from chameleon_recsys_tpu.data.collate import collate_sessions as jax_collate
from chameleon_recsys_tpu.data.sessions import read_sessions_tfrecord as jax_read_sessions
from chameleon_recsys_tpu.state.stream_state import (
    update_stream_state as jax_update_stream_state,
)
from chameleon_recsys_tpu.train.steps import _batch_all_clicks as jax_batch_all_clicks

from chameleon_recsys_tpu_torch.cli import make_pseudo_g1, nar_preprocess_gcom
from chameleon_recsys_tpu_torch.cli import nar_trainer_gcom
from chameleon_recsys_tpu_torch.convert import params_from_flax, stream_from_numpy

from test_torch_temporal import BASELINES, _near_tie_swaps, jax_draws, numpy_tree

BUNDLE = ["--hours", "6", "--num_articles", "300", "--mean_sessions_per_hour", "100",
          "--ace_dim", "8", "--seed", "5", "--regime", "mixed"]
TRAINER = [
    "--train_files_from", "1", "--train_files_up_to", "6",
    "--training_hours_for_each_eval", "2", "--batch_size", "8",
    "--truncate_session_length", "6", "--learning_rate", "1e-3",
    "--CAR_embedding_size", "32", "--rnn_units", "24", "--rnn_num_layers", "2",
    "--train_total_negative_samples", "5", "--train_negative_samples_from_buffer", "30",
    "--eval_total_negative_samples", "5", "--eval_negative_samples_from_buffer", "30",
    "--eval_metrics_top_n", "4", "--recent_clicks_buffer_max_size", "128",
    "--recent_clicks_for_normalization", "64", "--compute_dtype", "float32",
    "--save_eval_sessions_negative_samples", "--save_eval_sessions_recommendations",
    "--save_scalars", "--save_histograms", "--sync_artifacts_to", "run",
    "--enabled_internal_features",
    "recency,novelty,article_content_embeddings,item_clicked_embeddings",
    "--platform", "cpu",
]


def pipeline(root: Path, make, preprocess):
    make.main(["--output_dir", str(root / "bundle")] + BUNDLE)
    preprocess.main(["--input_clicks_csv_path_regex",
                     str(root / "bundle" / "clicks" / "clicks_hour_*.csv"),
                     "--output_sessions_tfrecords_path",
                     str(root / "sessions" / "sessions_hour_*.tfrecord.gz")])
    return [
        "--train_set_path_regex", str(root / "sessions" / "sessions_hour_*.tfrecord.gz"),
        "--acr_module_articles_metadata_csv_path",
        str(root / "bundle" / "articles_metadata.csv"),
        "--acr_module_articles_content_embeddings_pickle_path",
        str(root / "bundle" / "articles_embeddings.pickle"),
        "--model_dir", str(root / "model"), "--artifact_store_root", str(root / "store"),
    ] + TRAINER


def warm_file(root: Path) -> str:
    return str(root / "sessions" / "sessions_hour_000.tfrecord.gz")


def run_chains(root: Path, jax_extra=(), port_runs=(("port", ()),)):
    """The JAX chain in ``root / "jax"`` and the port's in ``root / "port"``
    (bundle and session files), the JAX trainer with ``jax_extra`` flags and
    one port trainer run per ``port_runs`` entry (name, flags) into
    ``root / name / "model"`` and its store, each from the JAX run's params,
    stream and draws."""
    captured = {}

    class WarmJaxHarness(jax_trainer.TemporalHarness):
        """The CLI's JAX harness, its stream warmed with file 0's clicks;
        records what the port's run starts from."""

        def init_from_batch(self, example_batch):
            super().init_from_batch(example_batch)
            cfg = self.cfg
            sessions = jax_read_sessions(warm_file(root / "jax"), self.session_schema)
            stream = self.state.stream
            for i in range(0, len(sessions), cfg.batch_size):
                batch = jax_collate(sessions[i: i + cfg.batch_size], self.session_schema,
                                    cfg.batch_size, cfg.max_session_length)
                stream = jax_update_stream_state(stream, *jax_batch_all_clicks(batch),
                                                 cfg)
            self.state = self.state._replace(stream=stream)
            captured.update(
                cfg=cfg, rng=np.asarray(self.state.rng).copy(),
                params=numpy_tree(self.state.params),
                stream={k: np.asarray(v).copy() for k, v in stream._asdict().items()})

    class InjectedPortHarness(nar_trainer_gcom.TemporalHarness):
        """The CLI's port harness, from the JAX harness's params and stream."""

        def init_state(self):
            super().init_state()
            model = self.state.model
            model.load_state_dict(params_from_flax(captured["params"], model))
            self.state = self.state._replace(
                stream=stream_from_numpy(captured["stream"], device="cpu"))

    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("CHAMELEON_JAX_CACHE", "")  # no compile cache outside the run
        patch.setattr(jax_trainer, "TemporalHarness", WarmJaxHarness)
        patch.setattr(nar_trainer_gcom, "TemporalHarness", InjectedPortHarness)
        jax_trainer.main(pipeline(root / "jax", jax_make_pseudo_g1, jax_preprocess)
                         + list(jax_extra))
        port_argv = pipeline(root / "port", make_pseudo_g1, nar_preprocess_gcom)
        for name, extra in port_runs:
            argv = port_argv + ["--model_dir", str(root / name / "model"),
                                "--artifact_store_root", str(root / name / "store")]
            with jax_draws(types.SimpleNamespace(cfg=captured["cfg"]), captured["rng"]):
                nar_trainer_gcom.main(argv + list(extra))
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_chains(tmp_path_factory.mktemp("cli_g1"))


def model_dir(runs, name):
    return runs / name / "model"


def read_csv(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def read_json_lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_same_bundle_and_session_files(runs):
    """The CLIs' bundles byte-equal; the session files' payloads equal (their
    gzip headers hold the clock's mtime)."""
    for sub in ("bundle", "sessions"):
        port_files = sorted(p.relative_to(runs / "port").as_posix()
                            for p in (runs / "port" / sub).rglob("*") if p.is_file())
        jax_files = sorted(p.relative_to(runs / "jax").as_posix()
                           for p in (runs / "jax" / sub).rglob("*") if p.is_file())
        assert port_files == jax_files and port_files
        for rel in port_files:
            port_bytes, jax_bytes = ((runs / d / rel).read_bytes() for d in ("port", "jax"))
            if sub == "sessions":
                port_bytes, jax_bytes = gzip.decompress(port_bytes), gzip.decompress(jax_bytes)
            assert port_bytes == jax_bytes, rel


def test_same_artifact_files(runs):
    for sub in ("model", "store/run"):
        port_names = sorted(p.name for p in (runs / "port" / sub).iterdir())
        jax_names = sorted(p.name for p in (runs / "jax" / sub).iterdir())
        assert port_names == jax_names, sub
    assert "eval_stats_benchmarks.csv" in port_names


def test_eval_csv_matches_jax(runs):
    assert_eval_csv_matches(model_dir(runs, "port"), model_dir(runs, "jax"))


def assert_eval_csv_matches(port_dir: Path, jax_dir: Path):
    """The eval CSV of ``port_dir`` against ``jax_dir``'s: the same columns
    and rows, the baselines bit-equal, CHAMELEON within the tolerances."""
    port_columns, port_rows = read_csv(port_dir / "eval_stats_benchmarks.csv")
    jax_columns, jax_rows = read_csv(jax_dir / "eval_stats_benchmarks.csv")
    assert port_columns == jax_columns
    assert len(port_rows) == len(jax_rows) == 2
    baseline = [c for c in jax_columns if c.endswith(BASELINES)]
    assert len(baseline) == 8 * len(BASELINES)
    swaps = _near_tie_swaps(
        read_json_lines(port_dir / "eval_chameleon_recommendations_log.json"),
        read_json_lines(jax_dir / "eval_chameleon_recommendations_log.json"))
    if swaps:
        print("near ties ranked the other way:", swaps)
    for port_row, jax_row in zip(port_rows, jax_rows):
        for key in ("eval_hour", "eval_day", "clicks_count", "sessions_count"):
            assert port_row[key] == jax_row[key], key
        for key in baseline:
            assert float(port_row[key]) == float(jax_row[key]), key
        rank_tol = 1e-6 + len(swaps) / int(port_row["clicks_count"])
        for key in jax_columns:
            if key in ("hitrate_at_n", "mrr_at_n") or key.endswith("_chameleon"):
                tol = rank_tol if any(m in key for m in ("hitrate", "mrr", "ndcg")) \
                    else 1e-6
                assert float(port_row[key]) == pytest.approx(float(jax_row[key]),
                                                             abs=tol), key
        assert port_row["hitrate_at_n"] == port_row["hitrate_at_n_chameleon"]


def test_negative_samples_equal_jax(runs):
    name = "eval_sessions_negative_samples.json"
    port_log = read_json_lines(model_dir(runs, "port") / name)
    assert port_log == read_json_lines(model_dir(runs, "jax") / name) and port_log


NOT_PORTED = {
    "--data_parallelism": (["--data_parallelism", "2"], "multi-GPU"),
    "--model_parallelism": (["--model_parallelism", "2"], "multi-GPU"),
}
MISSING = ["--train_set_path_regex", "/nonexistent/sessions_*.tfrecord.gz",
           "--acr_module_articles_metadata_csv_path", "/nonexistent/meta.csv",
           "--acr_module_articles_content_embeddings_pickle_path", "/nonexistent/ace.pkl"]


@pytest.mark.parametrize("flag", sorted(NOT_PORTED))
def test_not_ported_flag_exits_before_reading(flag, capsys, tmp_path):
    extra, slice_name = NOT_PORTED[flag]
    with pytest.raises(SystemExit) as exit_info:
        nar_trainer_gcom.main(MISSING + ["--model_dir", str(tmp_path / "m"),
                                         "--platform", "cpu"] + extra)
    assert exit_info.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and slice_name in err and "not ported" in err
    assert not (tmp_path / "m").exists()
    # the flag's default value and a value the port runs pass the check
    args = nar_trainer_gcom.parse_args(MISSING + ["--model_parallelism", "1",
                                                  "--dropout_keep_prob", "0.8"])
    assert args.dropout_keep_prob == 0.8 and args.data_parallelism == 0


def test_card_asked_without_a_card_exits(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ([], ["--platform", "cuda"], ["--platform", "gpu"]):
        with pytest.raises(SystemExit, match="--platform cpu"):
            nar_trainer_gcom.main(MISSING + ["--model_dir", str(tmp_path / "m")] + platform)
    assert nar_trainer_gcom.select_device("cpu") == torch.device("cpu")
    assert not (tmp_path / "m").exists()

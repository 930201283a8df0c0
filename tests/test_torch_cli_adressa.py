"""The port's Adressa chain through its CLIs against the JAX package's.

Each package runs its own chain on the CPU over the tiny raw fixture of
``tests/test_adressa_cli.py`` (25 articles, a 50-word 6-dim word2vec file,
30 users' clicks over three hours): ``acr_preprocess_adressa`` ->
``acr_trainer_adressa`` (the published CNN encoder, 8-wide ACEs, batch 8,
two epochs) -> ``nar_preprocess_adressa`` -> ``nar_trainer_adressa`` at
tiny model widths, float32, one training hour an eval (train 0, eval 1,
train 1, eval 2, train 2), all six classical baselines, the logs, the
scalars and the histograms.

The ACR trainers initialise their weights from their own RNGs: the JAX
trainer the CLI builds records its initial params, and the port's trainer
loads them through ``convert.acr_params_from_flax``.  The exported ACE
matrices then agree within 1e-4 (abs; f32 sums of the same products in
another order over 8 Adam steps), the label encoders and the metadata
exactly.  Both NAR trainers read the JAX trainer's ACE pickle, so
that the content-based baseline sees the same matrix; the NAR step's weights
and draws are matched as in ``tests/test_torch_cli_g1.py`` (the stream
warmed with file 0's clicks, ``params_from_flax``, ``jax_draws``).

Checked: the pseudo-Adressa bundles (both regimes) and the preprocessing
outputs byte-equal (gzip files with the header's mtime zeroed: the names
are equal), the eval CSV's columns, rows and
``eval_hour`` / ``eval_day``, every baseline column bit-equal, the
negative-sample logs equal, the CHAMELEON columns within
``test_torch_temporal.py``'s tolerances (1e-6, widened by one label's share
per near tie ranked the other way), each package's ACE pickle through the
other's ``load_ace_for_nar``, the port's resume from its own checkpoint, an
id past its table stopping on the host, and each mesh flag: a layout that
is not the world's size exiting with the JAX CLI's message before any file
is read, the run going through on a 2-rank gloo world.
"""
import csv
import pickle
import re
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from chameleon_recsys_tpu.acr.trainer import load_ace_for_nar as jax_load_ace_for_nar
from chameleon_recsys_tpu.cli import acr_preprocess_adressa as jax_acr_preprocess
from chameleon_recsys_tpu.cli import acr_trainer_adressa as jax_acr_trainer
from chameleon_recsys_tpu.cli import make_pseudo_adressa as jax_make_pseudo_adressa
from chameleon_recsys_tpu.cli import nar_preprocess_adressa as jax_nar_preprocess
from chameleon_recsys_tpu.cli import nar_trainer_adressa as jax_nar_trainer
from chameleon_recsys_tpu.data.collate import collate_sessions as jax_collate
from chameleon_recsys_tpu.data.sessions import read_sessions_tfrecord as jax_read_sessions
from chameleon_recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from chameleon_recsys_tpu.state.stream_state import (
    update_stream_state as jax_update_stream_state,
)
from chameleon_recsys_tpu.train.steps import _batch_all_clicks as jax_batch_all_clicks

from chameleon_recsys_tpu_torch.acr.trainer import load_ace_for_nar
from chameleon_recsys_tpu_torch.cli import (
    acr_preprocess_adressa,
    acr_trainer_adressa,
    make_pseudo_adressa,
    nar_preprocess_adressa,
    nar_trainer_adressa,
)
from chameleon_recsys_tpu_torch.convert import (
    acr_params_from_flax,
    params_from_flax,
    stream_from_numpy,
)

from _torch_parallel_worker import cli_rank, run_world
from test_adressa_cli import raw  # noqa: F401  (the tiny raw fixture)
from test_torch_cli_g1 import read_csv, read_json_lines
from test_torch_temporal import BASELINES, _near_tie_swaps, jax_draws, numpy_tree

ACE_TOL = 1e-4
ACR_TRAINER = ["--text_feature_extractor", "CNN", "--acr_embeddings_size", "8",
               "--batch_size", "8", "--training_epochs", "2", "--learning_rate", "3e-3",
               "--l2_reg_lambda", "1e-5", "--truncate_tokens_length", "12",
               "--platform", "cpu"]
NAR_TRAINER = [
    "--training_hours_for_each_eval", "1", "--batch_size", "8",
    "--truncate_session_length", "6", "--CAR_embedding_size", "16", "--rnn_units", "10",
    "--train_total_negative_samples", "3", "--train_negative_samples_from_buffer", "16",
    "--eval_total_negative_samples", "3", "--eval_negative_samples_from_buffer", "16",
    "--eval_metrics_top_n", "3", "--recent_clicks_buffer_max_size", "64",
    "--recent_clicks_for_normalization", "32", "--compute_dtype", "float32",
    "--save_eval_sessions_negative_samples", "--save_eval_sessions_recommendations",
    "--save_scalars", "--save_histograms", "--platform", "cpu",
]
SESSIONS = "sessions/sessions_hour_*.tfrecord.gz"


def preprocess(raw_dir: Path, root: Path, acr_preprocess, nar_preprocess):
    acr_preprocess.main([
        "--input_articles_json_path", str(raw_dir / "articles.jsonl"),
        "--input_word_embeddings_path", str(raw_dir / "w2v.txt"),
        "--output_dir", str(root / "acr"), "--truncate_tokens_length", "12",
        "--min_label_freq", "1"])
    nar_preprocess.main([
        "--input_clicks_json_path", str(raw_dir / "clicks.jsonl"),
        "--output_sessions_tfrecords_path", str(root / SESSIONS),
        "--output_nar_preprocessing_resources_path", str(root / "nar_resources.pickle"),
        "--num_workers", "2"])


def acr_argv(root: Path):
    return ["--train_set_path_regex", str(root / "acr" / "articles_tokenized_*.tfrecord.gz"),
            "--input_word_vocab_embeddings_path",
            str(root / "acr" / "acr_word_vocab_embeddings.pickle"),
            "--input_label_encoders_path", str(root / "acr" / "acr_label_encoders.pickle"),
            "--output_acr_metadata_embeddings_path", str(root / "ace.pickle")] + ACR_TRAINER


def nar_argv(root: Path, ace_root: Path, model="model"):
    return ["--train_set_path_regex", str(root / SESSIONS),
            "--acr_module_resources_path", str(ace_root / "ace.pickle"),
            "--nar_module_preprocessing_resources_path",
            str(root / "nar_resources.pickle"), "--model_dir", str(root / model)
            ] + NAR_TRAINER


@pytest.fixture(scope="module")
def runs(raw, tmp_path_factory):  # noqa: F811
    raw_dir, _ = raw
    root = tmp_path_factory.mktemp("cli_adressa")
    captured = {}

    class RecordingJaxACRTrainer(jax_acr_trainer.ACRTrainer):
        def init(self, example_batch):
            super().init(example_batch)
            captured["acr_params"] = numpy_tree(self.params)

    class InjectedPortACRTrainer(acr_trainer_adressa.ACRTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.model.load_state_dict(
                acr_params_from_flax(captured["acr_params"], self.model))

    class WarmJaxHarness(jax_nar_trainer.TemporalHarness):
        """The CLI's JAX harness, its stream warmed with file 0's clicks;
        records what the port's run starts from."""

        def init_from_batch(self, example_batch):
            super().init_from_batch(example_batch)
            cfg = self.cfg
            sessions = jax_read_sessions(
                sorted((root / "jax" / "sessions").iterdir())[0], self.session_schema)
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

    class InjectedPortHarness(nar_trainer_adressa.TemporalHarness):
        """The CLI's port harness, from the JAX harness's params and stream."""

        def init_state(self):
            super().init_state()
            model = self.state.model
            model.load_state_dict(params_from_flax(captured["params"], model))
            self.state = self.state._replace(
                stream=stream_from_numpy(captured["stream"], device="cpu"))

    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("CHAMELEON_JAX_CACHE", "")  # no compile cache outside the run
        patch.setattr(jax_acr_trainer, "ACRTrainer", RecordingJaxACRTrainer)
        patch.setattr(acr_trainer_adressa, "ACRTrainer", InjectedPortACRTrainer)
        patch.setattr(jax_nar_trainer, "TemporalHarness", WarmJaxHarness)
        patch.setattr(nar_trainer_adressa, "TemporalHarness", InjectedPortHarness)
        preprocess(raw_dir, root / "jax", jax_acr_preprocess, jax_nar_preprocess)
        preprocess(raw_dir, root / "port", acr_preprocess_adressa, nar_preprocess_adressa)
        jax_acr_trainer.main(acr_argv(root / "jax"))
        acr_trainer_adressa.main(acr_argv(root / "port"))
        jax_nar_trainer.main(nar_argv(root / "jax", root / "jax"))
        with jax_draws(types.SimpleNamespace(cfg=captured["cfg"]), captured["rng"]):
            nar_trainer_adressa.main(nar_argv(root / "port", root / "jax"))
    return root


def gzip_without_mtime(data: bytes) -> bytes:
    assert data[:2] == b"\x1f\x8b"
    return data[:4] + b"\0\0\0\0" + data[8:]


def test_preprocessing_outputs_byte_equal(runs):
    """Articles TFRecords, label encoders with class weights, word-vocab
    embeddings, session TFRecords and the NAR resources pickle."""
    def files(side):
        return sorted(p.relative_to(runs / side).as_posix()
                      for sub in ("acr", "sessions") for p in (runs / side / sub).iterdir())

    names = files("port")
    assert names == files("jax") and len(names) == 3 + 3
    for rel in names + ["nar_resources.pickle"]:
        port_bytes, jax_bytes = ((runs / d / rel).read_bytes() for d in ("port", "jax"))
        if rel.endswith(".gz"):
            port_bytes, jax_bytes = map(gzip_without_mtime, (port_bytes, jax_bytes))
        assert port_bytes == jax_bytes, rel


@pytest.mark.parametrize("regime", ["legacy", "mixed"])
def test_pseudo_adressa_bundle_byte_equal(regime, tmp_path):
    argv = ["--hours", "3", "--num_articles", "200", "--sessions_per_hour", "30",
            "--vocab_size", "2000", "--seed", "3", "--regime", regime, "--quiet"]
    jax_make_pseudo_adressa.main(["--output_dir", str(tmp_path / "jax")] + argv)
    make_pseudo_adressa.main(["--output_dir", str(tmp_path / "port")] + argv)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["articles.jsonl", "clicks.jsonl", "w2v.txt"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_exported_ace_matches_jax(runs):
    port_enc, port_meta, port_ace = pickle.loads((runs / "port" / "ace.pickle").read_bytes())
    jax_enc, jax_meta, jax_ace = pickle.loads((runs / "jax" / "ace.pickle").read_bytes())
    assert port_enc == jax_enc
    assert list(port_meta) == list(jax_meta)
    for key in jax_meta:
        np.testing.assert_array_equal(port_meta[key], jax_meta[key])
    assert port_ace.shape == jax_ace.shape == (26, 8) and port_ace.dtype == np.float32
    np.testing.assert_allclose(port_ace, jax_ace, rtol=0, atol=ACE_TOL)
    np.testing.assert_allclose(port_ace[0], port_ace[1:].mean(axis=0), atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ace_pickle_loads_through_either_package(runs, writer):
    path = runs / writer / "ace.pickle"
    port_loaded, jax_loaded = load_ace_for_nar(path, 6.0), jax_load_ace_for_nar(path, 6.0)
    assert port_loaded[0] == jax_loaded[0]
    for key in jax_loaded[1]:
        np.testing.assert_array_equal(port_loaded[1][key], jax_loaded[1][key])
    np.testing.assert_array_equal(port_loaded[2], jax_loaded[2])
    np.testing.assert_allclose(np.linalg.norm(port_loaded[2], axis=1), 6.0, rtol=1e-5)


def test_eval_csv_matches_jax(runs):
    port_columns, port_rows = read_csv(runs / "port" / "model" / "eval_stats_benchmarks.csv")
    jax_columns, jax_rows = read_csv(runs / "jax" / "model" / "eval_stats_benchmarks.csv")
    assert port_columns == jax_columns
    assert len(port_rows) == len(jax_rows) == 2
    baseline = [c for c in jax_columns if c.endswith(BASELINES)]
    assert len(baseline) == 8 * len(BASELINES)
    swaps = _near_tie_swaps(
        read_json_lines(runs / "port" / "model" / "eval_chameleon_recommendations_log.json"),
        read_json_lines(runs / "jax" / "model" / "eval_chameleon_recommendations_log.json"))
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


def test_artifacts_and_negative_samples_match_jax(runs):
    port_names = sorted(p.name for p in (runs / "port" / "model").iterdir())
    assert port_names == sorted(p.name for p in (runs / "jax" / "model").iterdir())
    assert {"checkpoint.pkl", "train_scalars.jsonl", "train_histograms.jsonl"} <= set(
        port_names)
    name = "eval_sessions_negative_samples.json"
    port_log = read_json_lines(runs / "port" / "model" / name)
    assert port_log == read_json_lines(runs / "jax" / "model" / name) and port_log
    port_scalars = read_json_lines(runs / "port" / "model" / "train_scalars.jsonl")
    jax_scalars = read_json_lines(runs / "jax" / "model" / "train_scalars.jsonl")
    assert [list(r) for r in port_scalars] == [list(r) for r in jax_scalars]
    for port_row, jax_row in zip(port_scalars, jax_scalars):
        assert port_row["step"] == jax_row["step"]
        assert port_row["ce_loss"] == pytest.approx(jax_row["ce_loss"], rel=1e-5)


def test_port_resumes_from_its_checkpoint(runs, tmp_path):
    """``--resume_checkpoint``: a run over the first two hours, then one over
    all three from its checkpoint, continues the step count."""
    part = tmp_path / "sessions"
    part.mkdir()
    files = sorted((runs / "port" / "sessions").iterdir())
    for f in files[:-1]:
        (part / f.name).symlink_to(f)
    first = nar_argv(runs / "port", runs / "jax", model=str(tmp_path / "m1"))
    first[1] = str(part / "sessions_hour_*.tfrecord.gz")
    nar_trainer_adressa.main(first)
    nar_trainer_adressa.main(nar_argv(runs / "port", runs / "jax", model=str(tmp_path / "m2"))
                             + ["--resume_checkpoint", str(tmp_path / "m1" / "checkpoint.pkl")])
    steps = [pickle.loads((tmp_path / m / "checkpoint.pkl").read_bytes())["step"]
             for m in ("m1", "m2")]
    assert steps[1] > steps[0] > 0
    rows = list(csv.DictReader(open(tmp_path / "m2" / "eval_stats_benchmarks.csv")))
    assert len(rows) == 2  # the resumed run's eval log carries the first one's row


def test_id_past_its_table_stops_on_the_host(runs, tmp_path):
    enc, meta, ace = pickle.loads((runs / "jax" / "ace.pickle").read_bytes())
    meta = dict(meta, author=np.where(np.arange(len(meta["author"])) == 3,
                                      len(enc["author"]), meta["author"]))
    (tmp_path / "ace.pickle").write_bytes(pickle.dumps((enc, meta, ace)))
    with pytest.raises(SystemExit, match=f"author id {len(enc['author'])} is outside"):
        nar_trainer_adressa.main(nar_argv(runs / "port", tmp_path, model=str(tmp_path / "m")))
    assert not (tmp_path / "m").exists()
    schema = nar_preprocess_adressa.adressa_session_schema({"city": 5})
    session = types.SimpleNamespace(item_ids=[1, 2], context={"city": [4, 5]})
    with pytest.raises(SystemExit, match="hour 7: city id 5 is outside its table of 5"):
        nar_trainer_adressa.check_sessions_fit([session], schema, "hour 7")


MISSING = {
    nar_trainer_adressa: ["--train_set_path_regex", "/nonexistent/s_*.tfrecord.gz",
                          "--acr_module_resources_path", "/nonexistent/ace.pkl",
                          "--nar_module_preprocessing_resources_path", "/nonexistent/r.pkl"],
    acr_trainer_adressa: ["--train_set_path_regex", "/nonexistent/a_*.tfrecord.gz",
                          "--input_word_vocab_embeddings_path", "/nonexistent/v.pkl",
                          "--input_label_encoders_path", "/nonexistent/l.pkl"],
}
# each mesh flag of the NAR trainer at 2, and the layout it asks for (data, model)
MESH_FLAGS = {"--data_parallelism": (2, 1), "--model_parallelism": (None, 2)}
CASES = [(nar_trainer_adressa, flag) for flag in sorted(MESH_FLAGS)]


def _out_args(cli, tmp_path):
    if cli is nar_trainer_adressa:
        return ["--model_dir", str(tmp_path / "m")]
    return ["--output_acr_metadata_embeddings_path", str(tmp_path / "m" / "ace.pkl")]


@pytest.mark.parametrize("cli,flag", CASES,
                         ids=[f"{c.__name__.rsplit('.', 1)[1]}{f}" for c, f in CASES])
def test_not_ported_flag_exits_before_reading(cli, flag, runs, tmp_path):
    """A mesh flag: over a world of one a layout of two devices exits with
    the JAX CLI's ``make_mesh`` message before any file is read; under a
    2-rank gloo world, as under ``torchrun``, the run goes through."""
    dp, mp = MESH_FLAGS[flag]
    with pytest.raises(ValueError) as jax_error:
        jax_make_mesh(data_parallelism=dp, model_parallelism=mp, devices=jax.devices()[:1])
    with pytest.raises(SystemExit, match=re.escape(str(jax_error.value))):
        cli.main(MISSING[cli] + _out_args(cli, tmp_path) + ["--platform", "cpu", flag, "2"])
    assert not (tmp_path / "m").exists() and not dist.is_initialized()
    run_world(cli_rank, 2, cli.__name__,
              nar_argv(runs / "port", runs / "jax", model=str(tmp_path / "two")) + [flag, "2"],
              None)
    rows = list(csv.DictReader(open(tmp_path / "two" / "eval_stats_benchmarks.csv")))
    assert len(rows) == 2
    for row in rows:
        assert row["hitrate_at_n"] == row["hitrate_at_n_chameleon"]


@pytest.mark.parametrize("cli", [nar_trainer_adressa, acr_trainer_adressa],
                         ids=lambda c: c.__name__.rsplit(".", 1)[1])
def test_card_asked_without_a_card_exits(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ([], ["--platform", "cuda"], ["--platform", "gpu"]):
        with pytest.raises(SystemExit, match="--platform cpu"):
            cli.main(MISSING[cli] + _out_args(cli, tmp_path) + platform)
    assert not (tmp_path / "m").exists()


def test_dropout_and_autoencoder_flags_run(runs, tmp_path):
    """``--dropout_keep_prob`` < 1 passes both trainers' parsers, and the
    ACR trainer trains the denoising autoencoder (two GRU layers, dropout
    between them, noise) on the port's preprocessed corpus, exporting the
    handoff pickle: the flat encoders, the metadata, an [articles + 1, ACE]
    matrix with the mean in row 0."""
    assert nar_trainer_adressa.parse_args(
        nar_argv(runs / "port", runs / "port") + ["--dropout_keep_prob", "0.8"]
    ).dropout_keep_prob == 0.8
    argv = acr_argv(runs / "port")
    argv[argv.index("--output_acr_metadata_embeddings_path") + 1] = str(tmp_path / "ae.pkl")
    acr_trainer_adressa.main(argv + [
        "--training_task", "autoencoder", "--dropout_keep_prob", "0.8",
        "--autoencoder_noise", "0.05", "--rnn_layers", "2", "--rnn_units", "16",
        "--text_feature_extractor", "GRU"])
    enc, meta, ace = pickle.loads((tmp_path / "ae.pkl").read_bytes())
    port_enc, port_meta, port_ace = pickle.loads((runs / "port" / "ace.pickle").read_bytes())
    assert enc == port_enc and list(meta) == list(port_meta)
    assert ace.shape == port_ace.shape and np.isfinite(ace).all()
    np.testing.assert_allclose(ace[0], ace[1:].mean(axis=0), atol=1e-6)

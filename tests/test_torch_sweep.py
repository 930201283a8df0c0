"""The port's sweep runner and G1 hypertuning CLI against the JAX package's
(mirrors ``tests/test_sweep.py``), on the CPU.

* ``grid``, ``load_sweep_spec`` in both layouts (YAML and JSON) and the
  shipped ``examples/nar_hypertuning_gcom.yaml``: equal to JAX's; a YAML
  spec without PyYAML raises naming it;
* ``run_sweep`` over stub harnesses (fixed eval rows per trial, one trial
  failing): the trials run, their order under MAXIMIZE and MINIMIZE (the
  failed trial last under either), the ``max_trials`` subsample and
  ``sweep_results.json`` equal to JAX's ``run_sweep``'s;
* ``max_parallel=2`` against the serial run over the port's own harness
  (two trials, two synthetic hours): equal results and results file but
  for the wall-clock throughput fields;
* ``nar_hypertuning_gcom.main`` on ``tests/test_cli_pipeline.py``'s tiny raw
  fixture (its session TFRecords, a seeded ACE pickle and metadata CSV; an
  ML Engine JSON spec of two trials), each port trial from the JAX trial's
  initial weights, warm stream and sampler draws (``tests/test_torch_cli_g1.py``'s
  machinery, per trial): the trial order and each objective within
  ``tests/test_torch_temporal.py``'s tolerances (1e-6, widened by one
  label's share per near tie ranked the other way).
"""
import csv
import dataclasses
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.cli import nar_hypertuning_gcom as jax_hyper
from chameleon_recsys_tpu.config import RunConfig as JaxRunConfig
from chameleon_recsys_tpu.data.collate import collate_sessions as jax_collate
from chameleon_recsys_tpu.data.sessions import read_sessions_tfrecord as jax_read_sessions
from chameleon_recsys_tpu.state.stream_state import (
    update_stream_state as jax_update_stream_state,
)
from chameleon_recsys_tpu.train import sweep as jax_sweep
from chameleon_recsys_tpu.train.steps import _batch_all_clicks as jax_batch_all_clicks

from chameleon_recsys_tpu_torch.cli import nar_hypertuning_gcom, nar_preprocess_gcom
from chameleon_recsys_tpu_torch.config import RunConfig
from chameleon_recsys_tpu_torch.convert import params_from_flax, stream_from_numpy
from chameleon_recsys_tpu_torch.data import synthetic as port_synthetic
from chameleon_recsys_tpu_torch.train import steps, sweep, temporal

from test_cli_pipeline import N_ARTICLES, raw_data  # noqa: F401  (the tiny raw fixture)
from test_torch_temporal import (
    _near_tie_swaps,
    jax_eval_uniforms,
    numpy_tree,
    port_article_schema,
    port_config,
    port_session_schema,
)
from test_torch_train_step import jax_train_uniforms

from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema

ROOT = Path(__file__).resolve().parents[1]
MLENGINE = {"trainingInput": {"hyperparameters": {
    "goal": "MAXIMIZE", "hyperparameterMetricTag": "mrr_at_n", "maxTrials": 2,
    "maxParallelTrials": 1, "params": [
        {"parameterName": "rnn_units", "type": "DISCRETE", "discreteValues": [8, 12]},
        {"parameterName": "dropout_keep_prob", "type": "DISCRETE",
         "discreteValues": [1.0]}]}}}
FLAT = {"params": {"learning_rate": [1e-3, 3e-4], "keep_prob": [0.8, 1.0]},
        "objective": "hitrate_at_n", "goal": "MINIMIZE", "max_trials": 3,
        "max_parallel": 2}


def test_grid_matches_jax():
    param_grid = {"learning_rate": [1e-3, 1e-4], "rnn_units": [8, 16, 24]}
    assert sweep.grid(param_grid) == jax_sweep.grid(param_grid)
    assert len(sweep.grid(param_grid)) == 6


@pytest.mark.parametrize("layout,suffix", [("mlengine", ".yaml"), ("mlengine", ".json"),
                                           ("flat", ".yml"), ("flat", ".json"),
                                           ("shipped", ".yaml")])
def test_load_sweep_spec_matches_jax(tmp_path, layout, suffix):
    import yaml

    if layout == "shipped":
        path = ROOT / "examples" / "nar_hypertuning_gcom.yaml"
    else:
        path = tmp_path / f"spec{suffix}"
        spec = MLENGINE if layout == "mlengine" else FLAT
        path.write_text(json.dumps(spec) if suffix == ".json" else yaml.safe_dump(spec))
    got, want = sweep.load_sweep_spec(str(path)), jax_sweep.load_sweep_spec(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if layout == "shipped":
        assert got.param_grid["keep_prob"] == [0.8, 0.9, 1.0] and got.max_parallel == 2


def test_yaml_spec_without_pyyaml_names_it(tmp_path, monkeypatch):
    path = tmp_path / "spec.yaml"
    path.write_text("params: {}\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        sweep.load_sweep_spec(str(path))


class StubHarness:
    """A harness whose ``run`` returns fixed eval rows for its learning rate
    (none: a failed trial)."""

    ROWS = {1e-3: [{"mrr_at_n": 0.5}, {"mrr_at_n": 0.3}], 3e-4: [{"mrr_at_n": 0.1}],
            1e-4: [], 3e-3: [{"mrr_at_n": 0.2, "hitrate_at_n": 0.9}]}

    def __init__(self, cfg, run_cfg):
        self.cfg = cfg

    def run(self, hour_source, hours):
        return [dict(r) for r in self.ROWS[self.cfg.learning_rate]]


@pytest.mark.parametrize("goal", ["MAXIMIZE", "MINIMIZE"])
@pytest.mark.parametrize("max_trials", [None, 3])
def test_run_sweep_matches_jax(tmp_path, goal, max_trials):
    param_grid = {"learning_rate": [1e-3, 3e-4, 1e-4, 3e-3], "rnn_units": [8]}
    results = {}
    for name, module, cfg, run_cfg in (
            ("port", sweep, port_config(tiny_nar_config()), RunConfig),
            ("jax", jax_sweep, tiny_nar_config(), JaxRunConfig)):
        out = module.run_sweep(cfg, run_cfg(model_dir=str(tmp_path / name)), param_grid,
                               StubHarness, lambda h: [], hours=range(2),
                               max_trials=max_trials, goal=goal, seed=5)
        results[name] = [dataclasses.asdict(r) for r in out]
    assert results["port"] == results["jax"]
    assert len(results["port"]) == (max_trials or 4)
    ports = json.loads((tmp_path / "port" / "sweep_results.json").read_text())
    assert ports == json.loads((tmp_path / "jax" / "sweep_results.json").read_text())
    if max_trials is None:  # the failed trial (lr 1e-4) sorts last either way
        assert results["port"][-1]["overrides"]["learning_rate"] == 1e-4
        assert results["port"][-1]["objective"] == (float("-inf") if goal == "MAXIMIZE"
                                                    else float("inf"))


def test_parallel_sweep_equals_serial(tmp_path):
    cfg = port_config(tiny_nar_config(batch_size=8, max_session_length=6))
    art, sess = port_article_schema(tiny_article_schema(120)), port_session_schema(
        tiny_session_schema(120))
    corpus = port_synthetic.make_synthetic_corpus(art, ace_dim=8)

    def harness_factory(trial_cfg, trial_run_cfg):
        return temporal.TemporalHarness(trial_cfg, trial_run_cfg, sess, art,
                                        corpus.ace_matrix, corpus.metadata, device="cpu")

    def hour_source(h):
        return port_synthetic.synthetic_hour_sessions(corpus, sess, h, 16,
                                                      cfg.max_session_length)

    def run(name, max_parallel):
        return sweep.run_sweep(
            cfg, RunConfig(model_dir=str(tmp_path / name), training_hours_for_each_eval=1),
            {"rnn_units": [8, 16], "keep_prob": [0.8]}, harness_factory, hour_source,
            hours=range(2), max_parallel=max_parallel)

    def load(name):
        rows = json.loads((tmp_path / name / "sweep_results.json").read_text())
        for row in rows:  # wall-clock throughput differs between the runs
            for key in [k for k in row["metrics"] if k.startswith("train_")
                        and k != "train_steps"]:
                row["metrics"].pop(key)
        return rows

    serial, parallel = run("serial", 1), run("parallel", 2)
    assert [r.trial_id for r in serial] == [r.trial_id for r in parallel]
    assert [r.objective for r in serial] == [r.objective for r in parallel]
    assert load("serial") == load("parallel") and len(load("serial")) == 2


HYPER = ["--train_files_from", "1", "--training_hours_for_each_eval", "1",
         "--batch_size", "8", "--truncate_session_length", "6",
         "--CAR_embedding_size", "16", "--rnn_num_layers", "1",
         "--train_total_negative_samples", "4", "--train_negative_samples_from_buffer", "20",
         "--eval_total_negative_samples", "4", "--eval_negative_samples_from_buffer", "20",
         "--eval_metrics_top_n", "3", "--recent_clicks_buffer_max_size", "128",
         "--recent_clicks_for_normalization", "64", "--compute_dtype", "float32",
         "--learning_rate", "1e-3", "--platform", "cpu"]


@pytest.fixture(scope="module")
def sweep_inputs(raw_data, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("sweep_cli")
    nar_preprocess_gcom.main(["--input_clicks_csv_path_regex",
                              str(raw_data / "clicks_hour_*.csv"),
                              "--output_sessions_tfrecords_path",
                              str(root / "sessions" / "sessions_hour_*.tfrecord.gz")])
    rng = np.random.RandomState(0)
    with open(root / "articles_embeddings.pickle", "wb") as f:
        pickle.dump(rng.randn(N_ARTICLES + 1, 8).astype(np.float32), f)
    with open(root / "articles_metadata.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["article_id", "category_id", "created_at_ts"])
        writer.writeheader()
        for i in range(1, N_ARTICLES + 1):
            writer.writerow({"article_id": i, "category_id": int(rng.randint(1, 5)),
                             "created_at_ts": 1_500_000_000_000 + i * 3_600_000})
    (root / "spec.json").write_text(json.dumps(MLENGINE))
    return root


def test_hypertuning_cli_matches_jax(sweep_inputs):
    root = sweep_inputs
    argv = ["--train_set_path_regex", str(root / "sessions" / "sessions_hour_*.tfrecord.gz"),
            "--acr_module_articles_metadata_csv_path", str(root / "articles_metadata.csv"),
            "--acr_module_articles_content_embeddings_pickle_path",
            str(root / "articles_embeddings.pickle"), "--sweep_spec",
            str(root / "spec.json")] + HYPER
    warm_file = root / "sessions" / "sessions_hour_000.tfrecord.gz"
    captured, chain = {}, {}

    class WarmJaxHarness(jax_hyper.TemporalHarness):
        """A JAX trial's harness: its stream warmed with file 0's clicks and
        its recommendations logged; records what the port's trial starts
        from."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, log_recommendations=True, **kwargs)

        def init_from_batch(self, example_batch):
            super().init_from_batch(example_batch)
            cfg, stream = self.cfg, self.state.stream
            sessions = jax_read_sessions(warm_file, self.session_schema)
            for i in range(0, len(sessions), cfg.batch_size):
                batch = jax_collate(sessions[i: i + cfg.batch_size], self.session_schema,
                                    cfg.batch_size, cfg.max_session_length)
                stream = jax_update_stream_state(stream, *jax_batch_all_clicks(batch), cfg)
            self.state = self.state._replace(stream=stream)
            captured[Path(self.run_cfg.model_dir).name] = dict(
                cfg=cfg, rng=np.asarray(self.state.rng).copy(),
                params=numpy_tree(self.state.params),
                stream={k: np.asarray(v).copy() for k, v in stream._asdict().items()})

    class InjectedPortHarness(nar_hypertuning_gcom.TemporalHarness):
        """A port trial's harness from the same JAX trial's weights, stream
        and sampler draws."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, log_recommendations=True, **kwargs)

        def init_state(self):
            super().init_state()
            start = captured[Path(self.run_cfg.model_dir).name]
            model = self.state.model
            model.load_state_dict(params_from_flax(start["params"], model))
            self.state = self.state._replace(
                stream=stream_from_numpy(start["stream"], device="cpu"))
            chain.update(cfg=start["cfg"], rng=start["rng"].copy())

    def train_step(state, batch, ace_matrix, metadata):
        cfg = chain["cfg"]
        uniforms, chain["rng"] = jax_train_uniforms(
            cfg, chain["rng"], None, cfg.batch_size, cfg.max_session_length,
            cfg.recent_clicks_buffer_max_size)
        return steps.train_step(state, batch, ace_matrix, metadata, uniforms=uniforms)

    def eval_step(model, stream, batch, ace_matrix, metadata, **kw):
        cfg = chain["cfg"]
        uniforms, chain["rng"] = jax_eval_uniforms(cfg, chain["rng"], cfg.batch_size,
                                                   cfg.recent_clicks_buffer_max_size)
        return steps.eval_step(model, stream, batch, ace_matrix, metadata,
                               uniforms=uniforms, **kw)

    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("CHAMELEON_JAX_CACHE", "")  # no compile cache outside the run
        patch.setattr(jax_hyper, "TemporalHarness", WarmJaxHarness)
        patch.setattr(nar_hypertuning_gcom, "TemporalHarness", InjectedPortHarness)
        patch.setattr(temporal, "train_step", train_step)
        patch.setattr(temporal, "eval_step", eval_step)
        jax_hyper.main(argv + ["--model_dir", str(root / "jax")])
        port_results = nar_hypertuning_gcom.main(argv + ["--model_dir", str(root / "port")])

    jax_results = json.loads((root / "jax" / "sweep_results.json").read_text())
    port_file = json.loads((root / "port" / "sweep_results.json").read_text())
    assert [r["trial_id"] for r in port_file] == [r.trial_id for r in port_results]
    assert len(port_file) == len(jax_results) == 2
    by_trial = {r["trial_id"]: r for r in jax_results}
    for port_row in port_file:
        jax_row = by_trial[port_row["trial_id"]]
        assert port_row["overrides"] == jax_row["overrides"]
        trial = f"trial_{port_row['trial_id']:03d}"
        logs = [[json.loads(line) for line in (root / side / trial /
                 "eval_chameleon_recommendations_log.json").read_text().splitlines()]
                for side in ("port", "jax")]
        assert len(logs[0]) == len(logs[1]) > 0
        swaps = _near_tie_swaps(*logs)
        labels = port_row["metrics"]["clicks_count"]
        assert labels == jax_row["metrics"]["clicks_count"] > 0
        tol = 1e-6 + len(swaps) / labels
        assert port_row["objective"] == pytest.approx(jax_row["objective"], abs=tol)
        for key in ("hitrate_at_n", "mrr_at_n"):
            assert port_row["metrics"][key] == pytest.approx(jax_row["metrics"][key], abs=tol)
    gap = abs(jax_results[0]["objective"] - jax_results[1]["objective"])
    if gap > 2e-6:  # an order within the tolerance may flip
        assert [r["trial_id"] for r in port_file] == [r["trial_id"] for r in jax_results]


def test_hypertuning_cli_refuses_as_the_trainer(sweep_inputs, monkeypatch):
    """As the JAX sweep, the port's takes ``--data_parallelism`` and
    ``--model_parallelism`` and ignores them (its trials run on one device,
    on no mesh): a sweep with them writes the trial results of the same
    sweep without them.  Without a card and ``--platform cpu`` it exits
    before reading; ``--use_native_loader`` is accepted (and ignored)."""
    root = sweep_inputs
    argv = ["--train_set_path_regex", str(root / "sessions" / "sessions_hour_*.tfrecord.gz"),
            "--acr_module_articles_metadata_csv_path", str(root / "articles_metadata.csv"),
            "--acr_module_articles_content_embeddings_pickle_path",
            str(root / "articles_embeddings.pickle"), "--max_trials", "1",
            "--param_grid", json.dumps({"rnn_units": [8]})] + HYPER
    runs = {}
    for name, extra in (("one", []), ("mesh_flags", ["--data_parallelism", "2",
                                                     "--model_parallelism", "2"])):
        nar_hypertuning_gcom.main(argv + ["--model_dir", str(root / name)] + extra)
        rows = json.loads((root / name / "sweep_results.json").read_text())
        for row in rows:  # wall-clock throughput differs between the runs
            for key in [k for k in row["metrics"] if k.startswith("train_")
                        and k != "train_steps"]:
                row["metrics"].pop(key)
        runs[name] = rows
    assert runs["mesh_flags"] == runs["one"] and len(runs["one"]) == 1
    assert runs["one"][0]["metrics"]["clicks_count"] > 0
    base = ["--train_set_path_regex", "/nonexistent/s_*.tfrecord.gz",
            "--acr_module_articles_metadata_csv_path", "/nonexistent/m.csv",
            "--acr_module_articles_content_embeddings_pickle_path", "/nonexistent/a.pkl",
            "--model_dir", str(root / "refused")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--platform cpu"):
        nar_hypertuning_gcom.main(base + ["--data_parallelism", "2"])
    assert not (root / "refused").exists()
    args = nar_hypertuning_gcom.create_sweep_parser().parse_args(
        base + ["--max_trials", "4", "--max_parallel", "2", "--dropout_keep_prob", "0.8",
                "--use_native_loader", "--data_parallelism", "2"])
    assert (args.max_trials, args.max_parallel, args.dropout_keep_prob) == (4, 2, 0.8)
    assert args.use_native_loader and args.data_parallelism == 2
    assert nar_hypertuning_gcom.DEFAULT_GRID == jax_hyper.DEFAULT_GRID

"""The port's native session loader (``native/chio.cc`` through
``native/loader.py``) against the port's Python reader and collation and
the JAX package's native loader, and ``--use_native_loader`` on the port's
G1 trainer CLI.

On session TFRecords written by the port's writer (the G1 session schema,
with integer and float per-click features, sessions longer than the
truncation and the last batch partial), ``NativeSessionLoader``'s batches
equal ``batches_from_sessions`` over ``read_sessions_tfrecord`` and the JAX
package's ``NativeSessionLoader`` array for array, dtypes included.  The G1
CLI with the flag gives the eval CSV of the run without it (same weights,
same draws: equal but for the host clock's columns), and the JAX CLI's
with the flag within ``tests/test_torch_cli_g1.py``'s tolerances; where the
loader cannot be built, the CLI exits before it trains.
"""
from pathlib import Path

import numpy as np
import pytest

from chameleon_recsys_tpu.config import gcom_session_schema as jax_gcom_session_schema
from chameleon_recsys_tpu.native import NativeSessionLoader as JaxNativeSessionLoader
from chameleon_recsys_tpu.native import native_available as jax_native_available

from chameleon_recsys_tpu_torch.cli import nar_trainer_gcom
from chameleon_recsys_tpu_torch.config import gcom_session_schema
from chameleon_recsys_tpu_torch.data.collate import Session, batches_from_sessions
from chameleon_recsys_tpu_torch.data.sessions import (
    read_sessions_tfrecord,
    write_sessions_tfrecord,
)
from chameleon_recsys_tpu_torch.native import NativeSessionLoader, build, loader

from test_torch_cli_g1 import TRAINER, assert_eval_csv_matches, read_csv, run_chains

EPOCH_MS = 1_506_826_800_000
NUM_ITEMS = 500


def g1_sessions(seed: int, count: int):
    """``count`` sessions of 2-12 clicks with every G1 per-click feature."""
    rng = np.random.RandomState(seed)
    schema = gcom_session_schema(num_items=NUM_ITEMS, num_users=300)
    sessions = []
    for i in range(count):
        n = int(rng.randint(2, 13))
        start = 3_600 * 5 + 7 * i
        context = {}
        for spec in schema.context_sequence_features():
            if spec.dtype == "float":
                context[spec.name] = rng.uniform(-1, 1, n).astype(np.float32).tolist()
            else:
                context[spec.name] = rng.randint(0, spec.cardinality, n).tolist()
        sessions.append(Session(
            session_id=1_000_000 + 13 * i, user_id=int(rng.randint(1, 300)),
            session_start=start, item_ids=rng.randint(1, NUM_ITEMS, n).tolist(),
            timestamps=(start + np.cumsum(rng.randint(0, 90, n))).tolist(),
            context=context))
    return schema, sessions


@pytest.fixture(scope="module")
def session_file(tmp_path_factory):
    schema, sessions = g1_sessions(0, 23)
    path = tmp_path_factory.mktemp("native_loader") / "sessions_hour_000.tfrecord.gz"
    write_sessions_tfrecord(sessions, schema, path, epoch_ms=EPOCH_MS)
    return path, schema


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("batch_size,max_len", [(5, 8), (23, 20), (8, 3)],
                         ids=["partial_last_truncated", "one_batch", "max_len_3"])
def test_native_batches_equal_python_and_jax(session_file, batch_size, max_len):
    path, schema = session_file
    assert loader.native_available(), loader.build_error()
    native = NativeSessionLoader(path, schema, epoch_ms=EPOCH_MS)
    sessions = read_sessions_tfrecord(path, schema, epoch_ms=EPOCH_MS)
    assert len(native) == len(sessions) == 23
    got = list(native.batches(batch_size, max_len))
    want = list(batches_from_sessions(sessions, schema, batch_size, max_len))
    assert len(got) == len(want) == -(-23 // batch_size)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    assert jax_native_available()
    jax_loader = JaxNativeSessionLoader(path, jax_gcom_session_schema(NUM_ITEMS, 300),
                                        epoch_ms=EPOCH_MS)
    for g, j in zip(got, jax_loader.batches(batch_size, max_len)):
        assert_batches_equal(g, j)
    jax_loader.close()
    native.close()


def test_loader_lifetime_and_library(session_file):
    """The library is the port's own build under its ``_build/``; a closed
    loader refuses to collate; a missing file raises."""
    path, schema = session_file
    native = NativeSessionLoader(path, schema, epoch_ms=EPOCH_MS)
    lib_file = Path(native.lib._name)
    assert lib_file == build.lib_path("chio") and lib_file.parent == build.BUILD_DIR
    assert lib_file.name.startswith("libchio-")
    last = native.batch(20, 5, 8)
    assert (last["session_size"] > 0).sum() == 3 and not last["item_clicked"][3:].any()
    native.close()
    native.close()
    with pytest.raises(ValueError, match="closed"):
        native.batch(0, 5, 8)
    with pytest.raises(IOError, match="failed to load"):
        NativeSessionLoader(path.parent / "missing.tfrecord.gz", schema)


@pytest.fixture(scope="module")
def native_cli_runs(tmp_path_factory):
    """The JAX chain with ``--use_native_loader``, and the port's trainer on
    its own files with the flag and without it."""
    return run_chains(tmp_path_factory.mktemp("cli_g1_native"),
                      jax_extra=["--use_native_loader"],
                      port_runs=(("port", ["--use_native_loader"]), ("port_python", [])))


def test_cli_native_loader_equals_python_reader(native_cli_runs):
    native_columns, native_rows = read_csv(
        native_cli_runs / "port" / "model" / "eval_stats_benchmarks.csv")
    python_columns, python_rows = read_csv(
        native_cli_runs / "port_python" / "model" / "eval_stats_benchmarks.csv")
    assert native_columns == python_columns and len(native_rows) == 2
    clock = {"train_elapsed_s", "train_steps_per_s", "train_sessions_per_s"}
    assert clock < set(native_columns)
    for native_row, python_row in zip(native_rows, python_rows):
        for key in set(native_columns) - clock:
            assert native_row[key] == python_row[key], key


def test_cli_native_loader_matches_jax(native_cli_runs):
    assert_eval_csv_matches(native_cli_runs / "port" / "model",
                            native_cli_runs / "jax" / "model")


def test_cli_exits_when_the_loader_cannot_build(native_cli_runs, monkeypatch, tmp_path):
    monkeypatch.setattr(loader, "LIBRARY",
                        build.NativeLibrary("no_such_source", ("z",), loader._bind))
    root = native_cli_runs / "port"
    argv = ["--train_set_path_regex", str(root / "sessions" / "sessions_hour_*.tfrecord.gz"),
            "--acr_module_articles_metadata_csv_path",
            str(root / "bundle" / "articles_metadata.csv"),
            "--acr_module_articles_content_embeddings_pickle_path",
            str(root / "bundle" / "articles_embeddings.pickle"),
            "--model_dir", str(tmp_path / "model")] + TRAINER + ["--use_native_loader"]
    with pytest.raises(SystemExit, match="native loader unavailable.*no_such_source"):
        nar_trainer_gcom.main(argv)
    assert not (tmp_path / "model" / "eval_stats_benchmarks.csv").exists()

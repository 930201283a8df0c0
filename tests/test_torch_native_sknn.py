"""The port's native session-kNN predictor (``native/sknn.cc`` through
``native/sknn.py``) against its numpy row loop and the JAX package's two
paths.

Four predictions of one batch are held bit-equal (int64 ids): the port's
C++ predictor, the port's numpy row loop (``use_native: False``), the JAX
package's C++ predictor and its numpy row loop, over every decay and both
similarities with the candidate cut and the neighbour cut triggering
constantly; then without a candidate cut and on an empty buffer.  The port
builds its own library from its own source into its ``_build/``; a process
that predicts through it loads no file of the JAX package.  A library that
cannot be built makes ``predict`` fall through to the numpy loop, and the
counters say which path ran.
"""
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from chameleon_recsys_tpu_torch.baselines import session_knn
from chameleon_recsys_tpu_torch.native import build, sknn

from test_torch_baselines import SKNN_ITEMS, sknn_pair

ROOT = Path(__file__).resolve().parents[1]
DECAYS = ("same", "div", "linear", "log", "quadratic")
SIMILARITIES = ("cosine", "jaccard")


def native_built():
    assert sknn.native_available(), sknn.build_error()


def four_ways(port_clf, jax_clf, items, valid, topk):
    """The four predictions, each path's counter checked where the port's
    ran."""
    out = []
    for clf in (port_clf, jax_clf):
        for use_native in (True, False):
            clf.params["use_native"] = use_native
            before = session_knn.native_calls, session_knn.numpy_calls
            out.append(clf.predict(None, items, topk=topk, valid_items=valid))
            if clf is port_clf:
                moved = (session_knn.native_calls - before[0],
                         session_knn.numpy_calls - before[1])
                assert moved == ((1, 0) if use_native else (0, 1))
    return out


@pytest.mark.parametrize("sim", SIMILARITIES)
@pytest.mark.parametrize("decay", DECAYS)
def test_native_equals_numpy_and_jax(decay, sim):
    native_built()
    port_clf, jax_clf = sknn_pair(7, n_batches=10, t=5, first_session_clicks_decay=decay,
                                  similarity=sim, candidate_sessions_sample_size=12,
                                  nearest_neighbor_session_for_scoring=6)
    rng = np.random.RandomState(8)
    for trial in range(5):
        items = rng.randint(0, 14, size=(7, 6)).astype(np.int64)
        items[trial % 7] = 0  # an all-padding row
        valid = rng.randint(1, SKNN_ITEMS, size=(7, 6, 9)).astype(np.int64)
        port_native, port_numpy, jax_native, jax_numpy = four_ways(
            port_clf, jax_clf, items, valid, topk=4)
        assert port_native.dtype == np.int64 and port_native.shape == (7, 6, 4)
        assert port_native.any()
        for other in (port_numpy, jax_native, jax_numpy):
            np.testing.assert_array_equal(port_native, other, f"trial {trial}")


def test_native_no_cut_and_empty_buffer():
    native_built()
    port_clf, jax_clf = sknn_pair(11, n_batches=0, candidate_sessions_sample_size=0)
    rng = np.random.RandomState(11)
    items = rng.randint(0, SKNN_ITEMS, size=(4, 5)).astype(np.int64)
    valid = rng.randint(1, SKNN_ITEMS, size=(4, 5, 8)).astype(np.int64)
    # empty buffer: all-zero predictions on every path
    for out in four_ways(port_clf, jax_clf, items, valid, topk=3):
        np.testing.assert_array_equal(out, 0)
    port_clf, jax_clf = sknn_pair(11, n_batches=8, candidate_sessions_sample_size=0,
                                  nearest_neighbor_session_for_scoring=10_000)
    port_native, *others = four_ways(port_clf, jax_clf, items, valid, topk=3)
    assert port_native.any()
    for other in others:
        np.testing.assert_array_equal(port_native, other)


def test_library_is_the_ports_own_build():
    """Built from ``chameleon_recsys_tpu_torch/native/sknn.cc`` into the
    port's ``_build/``, named by the source's and the host's hash; a
    process that predicts natively maps no file of the JAX package."""
    native_built()
    lib = sknn.LIBRARY.get()
    path = Path(lib._name)
    assert path.parent == build.BUILD_DIR == ROOT / "chameleon_recsys_tpu_torch" / "_build"
    assert path == build.lib_path("sknn") and path.name.startswith("libsknn-")
    assert (ROOT / "chameleon_recsys_tpu_torch" / "native" / "sknn.cc").exists()
    # sknn_pair builds a JAX twin too: drive the port alone here
    check = """
import sys
import numpy as np
from chameleon_recsys_tpu_torch.baselines.benchmarks import StreamStateView
from chameleon_recsys_tpu_torch.baselines import session_knn
from chameleon_recsys_tpu_torch.state.host_state import HostState
view = StreamStateView(HostState(40), np.zeros(8, np.int32), np.ones(40, np.float32),
                       np.zeros(40, np.int64))
clf = session_knn.SessionBasedKNNRecommender(view, dict(
    sessions_buffer_size=20, candidate_sessions_sample_size=5,
    nearest_neighbor_session_for_scoring=4), [])
rng = np.random.RandomState(0)
clf.train(None, np.arange(1, 9), rng.randint(1, 40, (8, 4)), rng.randint(1, 40, (8, 1)))
out = clf.predict(None, rng.randint(1, 40, (3, 4)), topk=3,
                  valid_items=rng.randint(1, 40, (3, 4, 6)))
assert session_knn.native_calls == 1 and session_knn.numpy_calls == 0
maps = open("/proc/self/maps").read()
files = [m.__file__ for m in list(sys.modules.values()) if getattr(m, "__file__", None)]
jax_dir = "chameleon_recsys_tpu/"
assert not [f for f in files if jax_dir in f], "a module of the JAX package"
assert jax_dir not in maps and "libsknn-" in maps, "a library of the JAX package"
assert "jax" not in sys.modules
"""
    proc = subprocess.run([sys.executable, "-c", check], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_failed_build_falls_through_to_numpy(monkeypatch):
    """A library that cannot be built is reported (``build_error``) and
    ``predict`` serves from the numpy loop, bit-equal, counted as such."""
    native_built()
    port_clf, _ = sknn_pair(3, n_batches=6)
    rng = np.random.RandomState(3)
    items = rng.randint(0, SKNN_ITEMS, size=(5, 4)).astype(np.int64)
    valid = rng.randint(1, SKNN_ITEMS, size=(5, 4, 7)).astype(np.int64)
    want = port_clf.predict(None, items, topk=4, valid_items=valid)
    missing = build.NativeLibrary("no_such_source", (), sknn._bind)
    monkeypatch.setattr(sknn, "LIBRARY", missing)
    before = session_knn.native_calls, session_knn.numpy_calls
    got = port_clf.predict(None, items, topk=4, valid_items=valid)
    assert not sknn.native_available() and "no_such_source" in sknn.build_error()
    assert (session_knn.native_calls, session_knn.numpy_calls) == (before[0], before[1] + 1)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="native sknn unavailable"):
        sknn.predict_batch(port_clf._vote_table(port_clf._state()), lambda i: [], items,
                           valid, sample_size=5, nearest_neighbors=5, topk=4,
                           similarity="cosine", decay="div")


def test_concurrent_first_builds_make_one_library(monkeypatch, tmp_path):
    """Eight threads asking for a library that is not built yet: one g++
    run, one file in the build directory, every thread loads it."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "build_seconds", {})
    libs, errors = [], []

    def first_use():
        try:
            libs.append(build.load("sknn", ("pthread",)))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_use) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(libs) == 8 and list(build.build_seconds) == ["sknn"]
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [build.lib_path("sknn").name]

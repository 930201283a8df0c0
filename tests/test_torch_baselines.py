"""The port's classical baselines against the JAX package's, bit for bit.

Item co-occurrence, item-kNN, session-kNN, content-based and the host
candidate sampler are numpy code in both packages.  Each case builds the
same streaming state in both (``HostState`` co-occurrences, buffer,
popularity, from one seeded numpy draw), trains both twins on the same
batches and holds every output of the port's ``train`` / ``predict`` (and of
the oracles kept beside them) equal to the JAX twin's.  The cases are those
of ``tests/test_baseline_predicts.py``, ``tests/test_session_knn.py`` and
``tests/test_candidate_sampling.py``.  The JAX session-kNN runs its numpy
path and, where the JAX default takes it, its native predictor (documented
bit-equal to the numpy path); the port has the numpy path only.
"""
import numpy as np
import pytest

from chameleon_recsys_tpu.baselines import benchmarks as jax_benchmarks
from chameleon_recsys_tpu.baselines import candidate_sampling as jax_candidate_sampling
from chameleon_recsys_tpu.baselines import content_based as jax_content_based
from chameleon_recsys_tpu.baselines import item_cooccurrence as jax_item_cooccurrence
from chameleon_recsys_tpu.baselines import item_knn as jax_item_knn
from chameleon_recsys_tpu.baselines import session_knn as jax_session_knn
from chameleon_recsys_tpu.state import host_state as jax_host_state

from chameleon_recsys_tpu_torch.baselines import (
    benchmarks,
    candidate_sampling,
    content_based,
    item_cooccurrence,
    item_knn,
    session_knn,
)
from chameleon_recsys_tpu_torch.state import host_state

NUM_ITEMS = 60
B, T, K = 6, 5, 4  # sessions, steps, negatives per click
PORT = (benchmarks, host_state)
JAX = (jax_benchmarks, jax_host_state)


def make_view(packages, seed, cooc_batches=5):
    """A ``StreamStateView`` of one package over the state of
    ``tests/test_baseline_predicts.py`` (5 batches of co-occurrences; 60
    make the counts differ enough to rank by more than popularity), drawn
    from ``seed``."""
    bench, hs = packages
    rng = np.random.RandomState(seed)
    host = hs.HostState(NUM_ITEMS)
    for _ in range(cooc_batches):
        host.update_items_coocurrences(
            rng.randint(0, NUM_ITEMS, size=(B, T + 1)).astype(np.int64))
    buffer_ids = rng.randint(0, NUM_ITEMS, size=128).astype(np.int32)
    pop = np.bincount(buffer_ids[buffer_ids != 0], minlength=NUM_ITEMS).astype(np.int64)
    return bench.StreamStateView(host, buffer_ids, rng.rand(NUM_ITEMS).astype(np.float32),
                                 pop)


def batches(seed, trials=8, pad_prob=0.3):
    """(items [B, T], valid [B, T, K+1]) pairs with padded clicks, a fully
    padded session and zero-padded valid rows."""
    rng = np.random.RandomState(seed)
    for _ in range(trials):
        items = rng.randint(1, NUM_ITEMS, size=(B, T)).astype(np.int64)
        items[rng.rand(B, T) < pad_prob] = 0
        items[-1] = 0
        valid = rng.randint(0, NUM_ITEMS, size=(B, T, K + 1)).astype(np.int64)
        valid[rng.rand(B, T, K + 1) < 0.15] = 0
        yield items, valid


def tie_ace():
    ace = np.random.RandomState(1).randn(NUM_ITEMS, 16).astype(np.float32)
    ace[7] = ace[11]  # an exact similarity tie
    ace[20] = 0.0  # a zero row
    return ace


# name -> (port class, JAX class, params)
ITEM_CASES = {
    "content_based": (content_based.ContentBasedRecommender,
                      jax_content_based.ContentBasedRecommender,
                      {"content_article_embeddings_matrix": tie_ace()}),
    "item_cooccurrence": (item_cooccurrence.ItemCooccurrenceRecommender,
                          jax_item_cooccurrence.ItemCooccurrenceRecommender, {}),
    "item_knn_0.75": (item_knn.ItemKNNRecommender, jax_item_knn.ItemKNNRecommender,
                      {"reg_lambda": 20, "alpha": 0.75}),
    "item_knn_0.5": (item_knn.ItemKNNRecommender, jax_item_knn.ItemKNNRecommender,
                     {"reg_lambda": 20, "alpha": 0.5}),
}


@pytest.mark.parametrize("cooc_batches", [5, 60])
@pytest.mark.parametrize("name", sorted(ITEM_CASES))
def test_item_baselines_bit_equal_jax(name, cooc_batches):
    port_cls, jax_cls, params = ITEM_CASES[name]
    port_clf = port_cls(make_view(PORT, 2, cooc_batches), dict(params), [])
    jax_clf = jax_cls(make_view(JAX, 2, cooc_batches), dict(params), [])
    assert port_clf.get_clf_suffix() == jax_clf.get_clf_suffix()
    for trial, (items, valid) in enumerate(batches(3)):
        got = port_clf.predict(None, items, topk=5, valid_items=valid)
        np.testing.assert_array_equal(
            got, jax_clf.predict(None, items, topk=5, valid_items=valid), f"trial {trial}")
        np.testing.assert_array_equal(
            port_clf._predict_scalar(None, items, topk=5, valid_items=valid),
            jax_clf._predict_scalar(None, items, topk=5, valid_items=valid))
    # content-based without valid items ranks the buffer's distinct items
    if name == "content_based":
        items, _ = next(batches(4))
        np.testing.assert_array_equal(port_clf.predict(None, items, topk=5),
                                      jax_clf.predict(None, items, topk=5))


SKNN_ITEMS = 80


def sknn_pair(seed, n_batches=6, b=8, t=4, **overrides):
    """Port and JAX session-kNN, trained alike on random sessions."""
    params = dict(sessions_buffer_size=50, candidate_sessions_sample_size=20,
                  nearest_neighbor_session_for_scoring=10, similarity="cosine",
                  first_session_clicks_decay="div")
    params.update(overrides)
    pair = []
    for bench, hs, knn in ((benchmarks, host_state, session_knn),
                           (jax_benchmarks, jax_host_state, jax_session_knn)):
        view = bench.StreamStateView(hs.HostState(SKNN_ITEMS), np.zeros(64, np.int32),
                                     np.full(SKNN_ITEMS, 0.01, np.float32),
                                     np.zeros(SKNN_ITEMS, np.int64))
        clf = knn.SessionBasedKNNRecommender(view, dict(params), [])
        rng = np.random.RandomState(seed)
        for _ in range(n_batches):
            sids = rng.randint(1_000_000, 9_000_000, size=b)
            clf.train(np.arange(b), sids, rng.randint(0, SKNN_ITEMS, size=(b, t)),
                      rng.randint(1, SKNN_ITEMS, size=(b, 1)))
        pair.append(clf)
    port_clf, jax_clf = pair
    assert port_clf.sessions == jax_clf.sessions
    assert dict(port_clf.item_sessions) == dict(jax_clf.item_sessions)
    assert port_clf.get_clf_suffix() == jax_clf.get_clf_suffix()
    return port_clf, jax_clf


DECAY_SIM = [("div", "cosine"), ("same", "cosine"), ("div", "jaccard"),
             ("log", "cosine"), ("same", "jaccard"), ("quadratic", "jaccard"),
             ("linear", "cosine")]


@pytest.mark.parametrize("jax_native", [False, True], ids=["jax_numpy", "jax_default"])
@pytest.mark.parametrize("decay,sim", DECAY_SIM)
def test_session_knn_predict_bit_equal_jax(decay, sim, jax_native):
    """The row-batched ``predict`` and the per-click oracle, with the
    candidate sampling and the neighbor cut triggering constantly, as in
    ``test_row_batched_predict_matches_per_click``."""
    port_clf, jax_clf = sknn_pair(11, n_batches=10, t=5, first_session_clicks_decay=decay,
                                  similarity=sim, candidate_sessions_sample_size=12,
                                  nearest_neighbor_session_for_scoring=6)
    jax_clf.params["use_native"] = jax_native
    rng = np.random.RandomState(12)
    for trial in range(4):
        items = rng.randint(0, 12, size=(7, 6)).astype(np.int64)
        items[-1] = 0
        valid = rng.randint(0, SKNN_ITEMS, size=(7, 6, 9)).astype(np.int64)
        got = port_clf.predict(None, items, topk=5, valid_items=valid)
        np.testing.assert_array_equal(
            got, jax_clf.predict(None, items, topk=5, valid_items=valid), f"trial {trial}")
        np.testing.assert_array_equal(
            port_clf._predict_per_click(None, items, topk=5, valid_items=valid),
            jax_clf._predict_per_click(None, items, topk=5, valid_items=valid))


@pytest.mark.parametrize("decay,sim", DECAY_SIM[:5])
def test_session_knn_scoring_bit_equal_jax(decay, sim):
    """The scalar scorer and the vectorized ranker without the neighbor cut,
    as in ``test_vectorized_matches_scalar_oracle``."""
    port_clf, jax_clf = sknn_pair(42, first_session_clicks_decay=decay, similarity=sim,
                                  nearest_neighbor_session_for_scoring=10_000)
    rng = np.random.RandomState(43)
    for _ in range(30):
        prefix = [int(x) for x in rng.randint(1, SKNN_ITEMS, size=rng.randint(1, 6))]
        assert port_clf._score_items(prefix) == jax_clf._score_items(prefix)
        assert port_clf._ranked_items_vectorized(prefix) == \
            jax_clf._ranked_items_vectorized(prefix)
        assert port_clf._candidate_sessions(prefix) == jax_clf._candidate_sessions(prefix)


def test_session_knn_no_cut_duplicates_and_eviction_bit_equal_jax():
    """No candidate cut (``test_row_batched_predict_no_cut_matches_per_click``),
    a session reached through two prefix items
    (``test_vectorized_duplicate_multiplicity``), and heavy eviction with a
    re-trained sid (``test_eviction_keeps_caches_consistent``,
    ``test_retrain_sid_with_different_items_keeps_index_consistent``)."""
    rng = np.random.RandomState(13)
    port_clf, jax_clf = sknn_pair(13, candidate_sessions_sample_size=0,
                                  nearest_neighbor_session_for_scoring=10_000)
    items = rng.randint(0, SKNN_ITEMS, size=(6, 5)).astype(np.int64)
    valid = rng.randint(0, SKNN_ITEMS, size=(6, 5, 8)).astype(np.int64)
    np.testing.assert_array_equal(port_clf.predict(None, items, topk=4, valid_items=valid),
                                  jax_clf.predict(None, items, topk=4, valid_items=valid))

    port_clf, jax_clf = sknn_pair(0, n_batches=0, candidate_sessions_sample_size=0,
                                  nearest_neighbor_session_for_scoring=100,
                                  first_session_clicks_decay="same")
    for clf in (port_clf, jax_clf):
        clf.train(np.array([0]), np.array([111]), np.array([[1, 2]]), np.array([[3]]))
    assert port_clf._score_items([1, 2]) == jax_clf._score_items([1, 2])

    port_clf, jax_clf = sknn_pair(1, n_batches=4, b=3, sessions_buffer_size=4)
    for clf in (port_clf, jax_clf):
        clf.train(None, np.array([11, 12]), np.array([[20, 21, 0], [1, 2, 3]], np.int64),
                  np.zeros((2, 1), np.int64))
    assert port_clf.sessions == jax_clf.sessions
    assert set(port_clf._state()["sess_arr"]) == set(jax_clf._state()["sess_arr"])
    items = np.array([[1, 2, 3, 20]], np.int64)
    valid = np.tile(np.arange(1, 10, dtype=np.int64), (1, 4, 1))
    for method in ("predict", "_predict_per_click"):
        np.testing.assert_array_equal(
            getattr(port_clf, method)(None, items, topk=5, valid_items=valid),
            getattr(jax_clf, method)(None, items, topk=5, valid_items=valid))


FAKE_BUFFER = np.array([5, 6, 7, 8, 9, 10, 5, 5, 6, 0, 0, 0], np.int64)
# the calls of tests/test_candidate_sampling.py, each on a fresh manager
SAMPLING_CALLS = {
    "buffer_sample": ("get_sample_from_recently_clicked_items_buffer", (5,)),
    "buffer_sample_capped": ("get_sample_from_recently_clicked_items_buffer", (100,)),
    "candidate_samples": ("get_candidate_samples", (4, [1, 2],
                                                    np.array([5, 6, 7, 8, 9, 5, 6]))),
    "zero_padding": ("get_candidate_samples", (6, [1], np.array([5, 6]))),
    "in_session_excluded": ("get_candidate_samples", (5, [5, 6],
                                                      np.array([5, 6, 7, 8, 9]))),
    "per_click_padded": ("get_samples_per_click", (np.array([3, 4, 0, 0]),
                                                   np.array([5, 6, 7, 8]), 3)),
    "batch_shape": ("get_batch_negative_samples",
                    (np.array([[1, 2, 0], [3, 4, 5]], np.int64), 4, 6)),
    "batch_exclusion": ("get_batch_negative_samples",
                        (np.array([[5, 6, 7]], np.int64), 4, 9)),
}


@pytest.mark.parametrize("name", sorted(SAMPLING_CALLS))
def test_candidate_sampling_bit_equal_jax(name):
    method, args = SAMPLING_CALLS[name]
    outs = []
    for module in (candidate_sampling, jax_candidate_sampling):
        manager = module.CandidateSamplingManager(lambda: FAKE_BUFFER,
                                                  rng=np.random.RandomState(7))
        # twice on one manager: the RNG's stream advances alike
        outs.append([getattr(manager, method)(*args) for _ in range(2)])
    for got, want in zip(*outs):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

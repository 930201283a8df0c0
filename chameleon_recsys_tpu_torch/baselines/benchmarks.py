"""Classical baseline recommenders sharing the NAR eval contract.

Re-creation of the reference benchmark layer
(nar_module/nar/benchmarks/benchmarks.py:13-68): every baseline

  * trains incrementally on each batch's sessions (both train and eval
    batches — the reference attaches the same hook in both modes,
    nar_trainer_gcom.py:305-316, nar_model.py:1628-1632);
  * predicts, per click, a top-k ranking restricted to ``valid_items`` =
    [next-click label ‖ that click's sampled negatives];
  * streams the same metric suite as CHAMELEON.

Baselines are host-side numpy by nature (dict/sparse structures); they read
the device streaming state through a ``StreamStateView`` snapshot.

The port's copy of ``chameleon_recsys_tpu/baselines/benchmarks.py``: the
port imports nothing of the JAX package.  Added here: ``evaluate`` in its
two halves, ``eval_predictions`` and ``record_eval``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..metrics.evaluation import compute_metrics_results, update_metrics
from ..state.host_state import HostState


class StreamStateView:
    """Numpy snapshot of the device StreamState + the host-side structures,
    presenting the accessor surface baselines need."""

    def __init__(
        self,
        host_state: HostState,
        buffer_ids: np.ndarray,
        recent_pop_norm: np.ndarray,
        global_pop: np.ndarray,
    ):
        self.host_state = host_state
        self._buffer_ids = np.asarray(buffer_ids)
        self._recent_pop_norm = np.asarray(recent_pop_norm)
        self._global_pop = np.asarray(global_pop)

    def get_recent_clicks_buffer(self) -> np.ndarray:
        return self._buffer_ids

    def get_articles_recent_pop_norm(self) -> np.ndarray:
        return self._recent_pop_norm

    def get_articles_pop(self) -> np.ndarray:
        return self._global_pop

    def get_items_coocurrences(self):
        return self.host_state.items_coocurrences

    @property
    def benchmarks_states(self) -> Dict[str, object]:
        return self.host_state.benchmarks_states

    def refresh(self, buffer_ids, recent_pop_norm, global_pop):
        self._buffer_ids = np.asarray(buffer_ids)
        self._recent_pop_norm = np.asarray(recent_pop_norm)
        self._global_pop = np.asarray(global_pop)


def fill_ranked_topk(ranked_ids, valid_items, topk: int) -> np.ndarray:
    """First ``topk`` entries of ``ranked_ids`` that appear in ``valid_items``,
    zero-padded (reference _get_top_n_valid_items, benchmarks.py:57-68)."""
    out = np.zeros(topk, np.int64)
    if len(ranked_ids) == 0:
        return out
    ranked = np.asarray(ranked_ids)
    if valid_items is not None:
        ranked = ranked[np.isin(ranked, valid_items)]
    n = min(topk, len(ranked))
    out[:n] = ranked[:n]
    return out


def topk_by_key(sessions_items, valid_items, keys, topk: int) -> np.ndarray:
    """Batched twin of per-click ``fill_ranked_topk`` over a scored
    valid-item tensor.

    For every click, orders that click's ``valid_items`` by ``keys``
    ascending with ties broken by ascending item id — exactly the order
    ``fill_ranked_topk`` produces when the global ranking is a stable
    ``argsort`` over an id-ascending candidate list (all the classical
    baselines' construction).  ``keys`` of +inf mean "not in the ranking"
    and zero-pad, as does any position whose input click is padding.

    Args:
      sessions_items: [B, T] int input clicks (0 = padding).
      valid_items:    [B, T, C] int candidate ids per click.
      keys:           [B, T, C] float ranking keys (smaller = better).
      topk:           outputs per click.
    Returns [B, T, topk] int64.
    """
    valid_items = np.asarray(valid_items)
    keys = np.asarray(keys, np.float64)
    # tie-break by id: pre-sort each row by item id ascending, then a stable
    # key sort preserves that order among equal keys
    id_order = np.argsort(valid_items, axis=2, kind="stable")
    ids_sorted = np.take_along_axis(valid_items, id_order, axis=2)
    keys_sorted = np.take_along_axis(keys, id_order, axis=2)
    # fill_ranked_topk filters a GLOBAL ranking, so a duplicated valid id
    # (zero padding, mostly) appears at most once — mask repeats to +inf
    dup = np.zeros_like(ids_sorted, bool)
    dup[..., 1:] = ids_sorted[..., 1:] == ids_sorted[..., :-1]
    keys_sorted = np.where(dup, np.inf, keys_sorted)
    order = np.argsort(keys_sorted, axis=2, kind="stable")[..., :topk]
    out_ids = np.take_along_axis(ids_sorted, order, axis=2)
    out_keys = np.take_along_axis(keys_sorted, order, axis=2)
    out = np.where(np.isfinite(out_keys), out_ids, 0).astype(np.int64)
    out *= (np.asarray(sessions_items) != 0)[:, :, None]
    return out


class BenchmarkRecommender:
    def __init__(self, state_view: StreamStateView, params: dict, streaming_metrics):
        self.state_view = state_view
        self.params = params
        self.streaming_metrics = streaming_metrics
        self.cold_start_state = None  # attached by the harness when enabled

    def get_clf_suffix(self) -> str:
        return ""

    def get_description(self) -> str:
        return ""

    def reset_eval_metrics(self):
        for metric in self.streaming_metrics:
            metric.reset()

    def train(self, users_ids, sessions_ids, sessions_items, sessions_next_items):
        pass

    def predict(self, users_ids, sessions_items, topk=5, valid_items=None):
        raise NotImplementedError

    def get_valid_candidate_items(self, sessions_next_items, eval_negative_items):
        return np.concatenate(
            [np.expand_dims(sessions_next_items, 2), eval_negative_items], axis=2
        )

    def is_stochastic(self) -> bool:
        """True when ``predict`` draws from an RNG (re-running it on the
        same inputs gives different output) — disables prediction reuse."""
        return False

    def evaluate(
        self, users_ids, sessions_items, sessions_next_items, topk=5,
        eval_negative_items=None,
    ) -> Dict[str, float]:
        preds = self.eval_predictions(
            users_ids, sessions_items, sessions_next_items, topk, eval_negative_items
        )
        return self.record_eval(preds, sessions_items, sessions_next_items, topk)

    def eval_predictions(
        self, users_ids, sessions_items, sessions_next_items, topk=5,
        eval_negative_items=None,
    ) -> np.ndarray:
        """The ranked lists ``evaluate`` scores, row by row: a data-parallel
        eval ranks each rank's rows apart (``train/temporal.py``)."""
        valid_items = self.get_valid_candidate_items(
            sessions_next_items, eval_negative_items
        )
        return self.predict(
            users_ids, sessions_items, topk=topk, valid_items=valid_items
        )

    def record_eval(
        self, preds, sessions_items, sessions_next_items, topk=5
    ) -> Dict[str, float]:
        """The second half of ``evaluate``: the batch's ranked lists
        ``preds`` into the streaming metrics."""
        # stash for the cold-start pass: it re-ranks the SAME batch with the
        # SAME valid items and state (reference nar_model.py:1496-1501 calls
        # predict twice; for a deterministic classifier the second call is
        # bit-identical, so the harness reuses this instead)
        self._last_eval_preds = (preds, topk)
        pop_norm = self.state_view.get_articles_recent_pop_norm()
        update_metrics(
            preds,
            sessions_next_items,
            pop_norm[sessions_next_items],
            pop_norm[preds],
            sessions_items,
            self.streaming_metrics,
            recommender=self.get_clf_suffix(),
        )
        return compute_metrics_results(
            self.streaming_metrics, recommender=self.get_clf_suffix()
        )

    # shared iteration helper: yields (row, col, item) for valid clicks
    @staticmethod
    def _valid_click_coords(sessions_items):
        rows, cols = np.nonzero(sessions_items)
        for r, c in zip(rows, cols):
            yield r, c, sessions_items[r, c]

"""RP — Most Popular from Recently Clicked
(reference nar_module/nar/benchmarks/recently_popular.py:10-48).

The port's copy of ``chameleon_recsys_tpu/baselines/recently_popular.py``,
unchanged but for this note: the port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

from .benchmarks import BenchmarkRecommender, fill_ranked_topk, topk_by_key


class RecentlyPopularRecommender(BenchmarkRecommender):
    def get_clf_suffix(self):
        return "pop_recent"

    def get_description(self):
        return "Most Popular from Recently Clicked"

    def _ranked_popular_items(self) -> np.ndarray:
        buffer_ids = self.state_view.get_recent_clicks_buffer()
        nonzero = buffer_ids[buffer_ids != 0]
        if len(nonzero) == 0:
            return np.zeros(1, np.int64)
        counts = np.bincount(nonzero)
        order = np.argsort(-counts, kind="stable")
        return order[counts[order] > 0]

    def predict(self, users_ids, sessions_items, topk=5, valid_items=None):
        # batched: a click's prediction = its valid items ordered by their
        # position in the global popularity ranking (identical output to the
        # per-click scalar path, kept below as the test oracle)
        ranked = self._ranked_popular_items()
        valid_items = np.asarray(valid_items)
        hi = max(int(valid_items.max(initial=0)), int(ranked.max(initial=0))) + 1
        pos = np.full(hi, np.inf)
        pos[ranked] = np.arange(len(ranked), dtype=np.float64)
        return topk_by_key(sessions_items, valid_items, pos[valid_items], topk)

    def _predict_scalar(self, users_ids, sessions_items, topk=5, valid_items=None):
        """Per-click transliteration — the oracle for ``predict``."""
        ranked = self._ranked_popular_items()
        preds = np.zeros(
            (sessions_items.shape[0], sessions_items.shape[1], topk), np.int64
        )
        for r, c, _ in self._valid_click_coords(sessions_items):
            preds[r, c] = fill_ranked_topk(ranked, valid_items[r, c], topk)
        return preds

"""CO — Most co-occurrent in sessions
(reference nar_module/nar/benchmarks/item_cooccurrences.py:11-41).
Co-occurrence counts live in HostState's csr matrix, updated per batch.
The port's copy of ``chameleon_recsys_tpu/baselines/item_cooccurrence.py``."""
from __future__ import annotations

import numpy as np

from .benchmarks import BenchmarkRecommender, fill_ranked_topk, topk_by_key


def rank_sparse_row(values: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Column indices of a sparse row ordered by value descending."""
    if len(values) == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(-values, kind="stable")
    return np.asarray(indices)[order]


def sample_cooc_counts(cooc, sessions_items, valid_items):
    """[B, T, C] co-occurrence counts of (active click, valid item) pairs,
    fetched in one vectorized csr lookup (0 where the click is padding)."""
    sessions_items = np.asarray(sessions_items)
    valid_items = np.asarray(valid_items)
    rows, cols = np.nonzero(sessions_items)
    out = np.zeros(valid_items.shape, np.float64)
    if len(rows) == 0:
        return out
    active = sessions_items[rows, cols]
    c = valid_items.shape[2]
    # flat (row, col) pair indexing returns a DENSE 1×(N·C) matrix; the
    # broadcastable 2-D form would return a sparse submatrix instead
    vals = cooc[np.repeat(active, c), valid_items[rows, cols].ravel()]
    out[rows, cols] = np.asarray(vals).reshape(len(rows), c)
    return out


class ItemCooccurrenceRecommender(BenchmarkRecommender):
    def get_clf_suffix(self):
        return "coocurrent"

    def get_description(self):
        return "Most co-ocurrent in sessions"

    def predict(self, users_ids, sessions_items, topk=5, valid_items=None):
        """Batched: pairwise (click, valid-item) counts in one csr fancy
        index; a valid item outside the click's co-occurrence row (count 0)
        is excluded exactly like the scalar ranking, ties order by ascending
        id like the csr row's canonical index order."""
        cooc = self.state_view.get_items_coocurrences()
        counts = sample_cooc_counts(cooc, sessions_items, valid_items)
        keys = np.where(counts > 0, -counts, np.inf)
        return topk_by_key(sessions_items, valid_items, keys, topk)

    def _predict_scalar(self, users_ids, sessions_items, topk=5, valid_items=None):
        """Per-click transliteration — the oracle for ``predict``."""
        cooc = self.state_view.get_items_coocurrences()
        preds = np.zeros(
            (sessions_items.shape[0], sessions_items.shape[1], topk), np.int64
        )
        for r, c, item in self._valid_click_coords(sessions_items):
            row = cooc[item]
            ranked = rank_sparse_row(row.data, row.indices)
            preds[r, c] = fill_ranked_topk(ranked, valid_items[r, c], topk)
        return preds

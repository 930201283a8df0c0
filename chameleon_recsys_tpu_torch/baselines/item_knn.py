"""ItemKNN — co-occurrence similarity normalized by item supports
(reference nar_module/nar/benchmarks/item_knn.py:12-58; Hidasi-style,
``sim(i,j) = cooc(i,j) / ((support_j + λ)^α · (support_i + λ)^(1−α))``).
G1 params λ=20, α=0.75; Adressa α=0.5 (nar_trainer_gcom.py:284-287).
The port's copy of ``chameleon_recsys_tpu/baselines/item_knn.py``."""
from __future__ import annotations

import numpy as np

from .benchmarks import BenchmarkRecommender, fill_ranked_topk, topk_by_key
from .item_cooccurrence import rank_sparse_row, sample_cooc_counts


class ItemKNNRecommender(BenchmarkRecommender):
    def __init__(self, state_view, params, streaming_metrics):
        super().__init__(state_view, params, streaming_metrics)
        self.reg_lambda = params["reg_lambda"]
        self.alpha = params["alpha"]

    def get_clf_suffix(self):
        return "item_knn"

    def get_description(self):
        return (
            "Item-KNN: most similar items based on support-normalized "
            "session co-occurrence"
        )

    def predict(self, users_ids, sessions_items, topk=5, valid_items=None):
        """Batched twin of the scalar oracle below: one csr fancy index for
        all (click, valid-item) counts, support normalization applied as
        array ops over the [B, T, C] tensor."""
        cooc = self.state_view.get_items_coocurrences()
        support = self.state_view.get_articles_pop().astype(np.float64)
        support_norm = np.power(support + self.reg_lambda, self.alpha)
        sessions_items = np.asarray(sessions_items)
        valid_items = np.asarray(valid_items)

        counts = sample_cooc_counts(cooc, sessions_items, valid_items)
        active_norm = np.power(
            support[sessions_items] + self.reg_lambda, 1.0 - self.alpha
        )[:, :, None]
        sims = counts / (support_norm[valid_items] * active_norm)
        keys = np.where(counts > 0, -sims, np.inf)
        return topk_by_key(sessions_items, valid_items, keys, topk)

    def _predict_scalar(self, users_ids, sessions_items, topk=5, valid_items=None):
        """Per-click transliteration — the oracle for ``predict``."""
        cooc = self.state_view.get_items_coocurrences()
        support = self.state_view.get_articles_pop().astype(np.float64)
        support_norm = np.power(support + self.reg_lambda, self.alpha)

        preds = np.zeros(
            (sessions_items.shape[0], sessions_items.shape[1], topk), np.int64
        )
        for r, c, item in self._valid_click_coords(sessions_items):
            row = cooc[item]
            if len(row.indices) == 0:
                continue
            denom = support_norm[row.indices] * np.power(
                support[item] + self.reg_lambda, 1.0 - self.alpha
            )
            sims = row.data / denom
            ranked = rank_sparse_row(sims, row.indices)
            preds[r, c] = fill_ranked_topk(ranked, valid_items[r, c], topk)
        return preds

"""CB — Content-Based similarity over ACE vectors
(reference nar_module/nar/benchmarks/content_based.py:10-57).

The candidate set per batch is the union of valid items; similarities for all
valid clicks are computed in one matrix product instead of per-click
sklearn calls.  The port's copy of
``chameleon_recsys_tpu/baselines/content_based.py``, on this package's
``metrics.streaming._normalized_embeddings``.
"""
from __future__ import annotations

import numpy as np

from ..metrics.streaming import _normalized_embeddings
from .benchmarks import BenchmarkRecommender, fill_ranked_topk, topk_by_key


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return np.divide(x, n, out=np.zeros_like(x, dtype=np.float64), where=n > 0)


class ContentBasedRecommender(BenchmarkRecommender):
    def get_clf_suffix(self):
        return "cb"

    def get_description(self):
        return "Content-Based similarity"

    def predict(self, users_ids, sessions_items, topk=5, valid_items=None):
        """Batched: similarities only for each click's own valid items
        ([N, C, D]·[N, D] products) instead of ranking the whole batch
        candidate union per click.  Identical output to the scalar oracle —
        every valid item (id 0 included, its padding embedding too —
        matching the reference's candidate handling) gets a similarity, and
        ties order by ascending id exactly like the stable argsort over the
        id-ascending candidate union."""
        ace = np.asarray(self.params["content_article_embeddings_matrix"])
        sessions_items = np.asarray(sessions_items)
        shared_candidates = None
        if valid_items is None:
            buffer_ids = self.state_view.get_recent_clicks_buffer()
            shared_candidates = np.unique(buffer_ids[buffer_ids != 0])
            valid_items = np.broadcast_to(
                shared_candidates,
                sessions_items.shape + (len(shared_candidates),),
            )
        valid_items = np.asarray(valid_items)

        rows, cols = np.nonzero(sessions_items)
        b, t = sessions_items.shape
        topk_shape = (b, t, valid_items.shape[2])
        keys = np.full(topk_shape, np.inf)
        if len(rows):
            ace_norm = _normalized_embeddings(ace)  # cached row-normalized
            click_ids = sessions_items[rows, cols]
            if shared_candidates is not None:
                # every click ranks the same candidate row — one gemm
                keys[rows, cols] = -(
                    ace_norm[click_ids] @ ace_norm[shared_candidates].T
                )
            else:
                # N·C·D work — each click scores only its OWN candidate row.
                # (A batch-union gemm is N·U·D with U up to the whole catalog
                # at eval scale: ~900× more FLOPs for B=256, C=51, G1's 46k
                # items.)
                vi = valid_items[rows, cols]            # [N, C]
                c = vi.shape[1]
                sims = np.empty(vi.shape)
                # chunk the [n, C, D] gather to ~64 MB of float64
                chunk = max(1, int(64e6 / (c * ace_norm.shape[1] * 8)))
                for s in range(0, len(rows), chunk):
                    ce = ace_norm[vi[s : s + chunk]]          # [n, C, D]
                    q = ace_norm[click_ids[s : s + chunk]]    # [n, D]
                    # batched BLAS gemv (einsum 'ncd,nd->nc' takes the slow
                    # non-BLAS c_einsum path here)
                    sims[s : s + chunk] = np.matmul(ce, q[:, :, None])[..., 0]
                keys[rows, cols] = -sims
        return topk_by_key(sessions_items, valid_items, keys, topk)

    def _predict_scalar(self, users_ids, sessions_items, topk=5, valid_items=None):
        """Per-click transliteration — the oracle for ``predict``."""
        ace = np.asarray(self.params["content_article_embeddings_matrix"])

        if valid_items is None:
            buffer_ids = self.state_view.get_recent_clicks_buffer()
            candidates = np.unique(buffer_ids[buffer_ids != 0])
        else:
            candidates = np.unique(valid_items)
        cand_emb = _normalize_rows(ace[candidates])

        preds = np.zeros(
            (sessions_items.shape[0], sessions_items.shape[1], topk), np.int64
        )
        rows, cols = np.nonzero(sessions_items)
        if len(rows) == 0:
            return preds
        click_items = sessions_items[rows, cols]
        click_emb = _normalize_rows(ace[click_items])
        sims = click_emb @ cand_emb.T  # [num_clicks, num_candidates]
        order = np.argsort(-sims, axis=1, kind="stable")
        ranked_all = candidates[order]
        for i, (r, c) in enumerate(zip(rows, cols)):
            preds[r, c] = fill_ranked_topk(ranked_all[i], valid_items[r, c], topk)
        return preds

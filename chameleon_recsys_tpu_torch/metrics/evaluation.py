"""Metric dispatch and cold-start analysis.

Twin of nar_module/nar/evaluation.py: routes each batch's
(preds, labels, pops, clicked) into every metric's ``add`` signature and
formats the ``{metric}_{recommender}`` result keys that make up the per-hour
eval CSV row.

The port's copy of ``chameleon_recsys_tpu/metrics/evaluation.py``,
unchanged but for this note: the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .streaming import (
    CategoryExpectedIntraListDiversity,
    ContentExpectedRankRelativeRelevanceSensitiveIntraListDiversity,
    ContentExpectedRankRelativeSensitiveIntraListDiversity,
    ExpectedRankRelevanceSensitiveNovelty,
    ExpectedRankSensitiveNovelty,
    HitRate,
    HitRateBySessionPosition,
    ItemCoverage,
    MRR,
    NDCG,
    Novelty,
    PopularityBias,
    StreamingMetric,
)


def update_metrics(
    preds,
    labels,
    labels_norm_pop,
    preds_norm_pop,
    clicked_items,
    streaming_metrics: List[StreamingMetric],
    recommender: str = "",
):
    """Route a batch into each metric (reference evaluation.py:12-26)."""
    for metric in streaming_metrics:
        if metric.name == HitRateBySessionPosition.name:
            metric.add(preds, labels, labels_norm_pop)
        elif metric.name == ItemCoverage.name:
            metric.add(preds, labels, clicked_items)
        elif metric.name in (
            PopularityBias.name,
            Novelty.name,
            ExpectedRankSensitiveNovelty.name,
            ExpectedRankRelevanceSensitiveNovelty.name,
        ):
            metric.add(preds, labels, preds_norm_pop)
        else:
            metric.add(preds, labels)


def compute_metrics_results(
    streaming_metrics: List[StreamingMetric], recommender: str = ""
) -> Dict[str, float]:
    """Format result keys (reference evaluation.py:28-46)."""
    results: Dict[str, float] = {}
    for metric in streaming_metrics:
        if metric.name == HitRateBySessionPosition.name:
            hitrate_by_pos, avg_pop_by_pos, total_by_pos = metric.result()
            for key in hitrate_by_pos:
                results[f"{metric.name}_{recommender}_{key:02d}"] = hitrate_by_pos[key]
                if recommender == "chameleon":
                    results[f"clicks_at_pos_{recommender}_{key:02d}"] = total_by_pos[key]
                    results[f"avg_norm_pop_by_pos_{recommender}_{key:02d}"] = (
                        avg_pop_by_pos[key]
                    )
        else:
            results[f"{metric.name}_{recommender}"] = metric.result()
    return results


def create_eval_metrics(
    top_n: int,
    eval_negative_sample_relevance: float,
    eval_metrics_by_session_position: bool,
    content_article_embeddings_matrix,
    recent_clicks_buffer,
) -> List[StreamingMetric]:
    """Standard metric set per recommender
    (reference nar_model.py:1695-1721)."""
    relevance_positive = 1.0
    relevance_negative = eval_negative_sample_relevance
    metrics: List[StreamingMetric] = [
        HitRate(top_n),
        MRR(top_n),
        NDCG(top_n),
        ItemCoverage(top_n, recent_clicks_buffer),
        ExpectedRankSensitiveNovelty(top_n),
        ExpectedRankRelevanceSensitiveNovelty(
            top_n, relevance_positive, relevance_negative
        ),
        ContentExpectedRankRelativeSensitiveIntraListDiversity(
            top_n, content_article_embeddings_matrix
        ),
        ContentExpectedRankRelativeRelevanceSensitiveIntraListDiversity(
            top_n,
            content_article_embeddings_matrix,
            relevance_positive,
            relevance_negative,
        ),
    ]
    if eval_metrics_by_session_position:
        metrics.append(HitRateBySessionPosition(top_n))
    return metrics


class ColdStartAnalysisState:
    """Steps-until-first-recommendation tracking
    (reference evaluation.py:50-91)."""

    def __init__(self):
        self.items_num_steps_before_first_rec: Dict[int, int] = {}
        self.unique_clicked_items_count = 0

    def update_items_num_steps_before_first_rec(
        self, batch_rec_items, items_first_click_step, step
    ):
        flat = np.asarray(batch_rec_items).reshape(-1)
        rec_ids = set(flat[np.nonzero(flat)].tolist())
        self.unique_clicked_items_count = len(items_first_click_step)
        for item_id in rec_ids:
            if (
                item_id in items_first_click_step
                and item_id not in self.items_num_steps_before_first_rec
            ):
                elapsed = step - items_first_click_step[item_id]
                assert elapsed >= 0
                self.items_num_steps_before_first_rec[item_id] = elapsed

    def get_statistics(self) -> Dict[str, float]:
        if not self.items_num_steps_before_first_rec:
            return {"uniqueClickedItemsCount": 0}
        values = np.array(list(self.items_num_steps_before_first_rec.values()))
        return {
            "min": np.min(values),
            "01%": np.percentile(values, 1),
            "10%": np.percentile(values, 10),
            "25%": np.percentile(values, 25),
            "50%": np.percentile(values, 50),
            "75%": np.percentile(values, 75),
            "90%": np.percentile(values, 90),
            "99%": np.percentile(values, 99),
            "max": np.max(values),
            "mean": np.mean(values),
            "std": np.std(values),
            "uniqueRecommendedItemsCount": len(values),
            "uniqueClickedItemsCount": self.unique_clicked_items_count,
        }

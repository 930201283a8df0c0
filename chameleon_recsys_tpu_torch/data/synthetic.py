"""Synthetic news-session corpus (numpy), for the chip smoke run and tests.

Copies of ``make_synthetic_corpus`` and ``synthetic_hour_sessions`` from
``chameleon_recsys_tpu/data/synthetic.py``: the same seed gives bit-equal
output.  A Zipf-popularity article catalog with creation timestamps and
categorical metadata, plus hourly session streams with context features.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..config import ArticleFeaturesSchema, SECONDS_PER_HOUR, SessionFeaturesSchema
from .collate import Session


@dataclass
class SyntheticCorpus:
    num_items: int
    metadata: Dict[str, np.ndarray]  # column -> [num_items]
    ace_matrix: np.ndarray  # [num_items, ace_dim] in [-0.1, 0.1]
    item_popularity: np.ndarray  # unnormalized sampling weights, weight 0 for id 0


def make_synthetic_corpus(
    article_schema: ArticleFeaturesSchema,
    ace_dim: int = 64,
    seed: int = 42,
    catalog_age_hours: float = 72.0,
) -> SyntheticCorpus:
    rng = np.random.RandomState(seed)
    num_items = article_schema.num_items

    metadata: Dict[str, np.ndarray] = {}
    for spec in article_schema.features:
        if spec.name == "article_id":
            continue
        if spec.name == "created_at_ts":
            created = rng.randint(
                0, int(catalog_age_hours * SECONDS_PER_HOUR), size=num_items
            ).astype(np.int64)
            created[0] = 0
            metadata[spec.name] = created
        elif spec.kind == "categorical":
            col = rng.randint(1, spec.cardinality, size=num_items).astype(np.int64)
            col[0] = 0
            metadata[spec.name] = col
        else:
            metadata[spec.name] = rng.randn(num_items).astype(np.float32)

    # ACE rows scaled to norm 0.1, the NAR handoff's compatibility range
    ace = rng.randn(num_items, ace_dim).astype(np.float32)
    ace /= np.maximum(np.linalg.norm(ace, axis=1, keepdims=True), 1e-9)
    ace *= 0.1
    ace[0] = 0.0

    pop = 1.0 / np.arange(1, num_items + 1) ** 1.1
    rng.shuffle(pop)
    pop[0] = 0.0
    return SyntheticCorpus(num_items, metadata, ace, pop)


def synthetic_hour_sessions(
    corpus: SyntheticCorpus,
    session_schema: SessionFeaturesSchema,
    hour_index: int,
    num_sessions: int,
    max_session_length: int = 20,
    base_epoch: int = 72 * SECONDS_PER_HOUR,
    seed: int = 42,
    length_distribution: str = "uniform",
) -> List[Session]:
    """One hour of sessions; later hours drift popularity toward fresher
    articles.  ``length_distribution``: 'uniform' draws lengths U(2, max),
    'g1' draws 2+geometric(0.55)-1 capped at max (mean about 2.9 clicks)."""
    rng = np.random.RandomState(seed + 1000 * hour_index)
    hour_start = base_epoch + hour_index * SECONDS_PER_HOUR

    created = corpus.metadata["created_at_ts"].astype(np.float64)
    freshness = np.exp(-(hour_start - created) / (24.0 * SECONDS_PER_HOUR))
    weights = corpus.item_popularity * (0.3 + freshness)
    weights[0] = 0.0
    probs = weights / weights.sum()

    ctx_specs = session_schema.context_sequence_features()
    sessions = []
    for i in range(num_sessions):
        if length_distribution == "g1":
            n = int(min(1 + rng.geometric(0.55), max_session_length))
            n = max(n, 2)
        else:
            n = int(rng.randint(2, max_session_length + 1))
        items = rng.choice(corpus.num_items, size=n, replace=False, p=probs)
        start = hour_start + int(rng.randint(0, SECONDS_PER_HOUR - n * 30))
        ts = start + np.cumsum(rng.randint(5, 30, size=n))
        context = {}
        for spec in ctx_specs:
            if spec.kind == "categorical":
                context[spec.name] = rng.randint(
                    1, spec.cardinality, size=n
                ).tolist()
            else:
                context[spec.name] = rng.uniform(-1, 1, size=n).astype(
                    np.float32
                ).tolist()
        sessions.append(
            Session(
                session_id=hour_index * 10_000_000 + i,
                user_id=int(rng.randint(1, 100000)),
                session_start=int(start),
                item_ids=items.tolist(),
                timestamps=ts.astype(np.int64).tolist(),
                context=context,
            )
        )
    sessions.sort(key=lambda s: s.session_start)
    return sessions

"""Synthetic news-session corpora and streams (numpy), for the quality
example (``cli/train_nar_synthetic.py``), the chip smoke run and tests.

Copies of ``chameleon_recsys_tpu/data/synthetic.py``: the same seeds and the
same order of draws give bit-equal corpora, graphs and sessions.  A
Zipf-popularity article catalog with creation timestamps and categorical
metadata, plus hourly session streams with context features: uniform
(``synthetic_hour_sessions``) and three that a model can learn from, a
Markov walk over a sparse transition graph, transitions conditioned on a
context feature, and a churning catalog whose ACEs carry the category.
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


def make_churn_corpus(
    article_schema: ArticleFeaturesSchema,
    ace_dim: int = 64,
    stream_hours: int = 12,
    item_lifetime_hours: float = 4.0,
    category_signal: float = 0.8,
    seed: int = 42,
    base_epoch: int = 72 * SECONDS_PER_HOUR,
) -> SyntheticCorpus:
    """News-like corpus with ARTICLE CHURN and CONTENT SIGNAL.

    Articles are born throughout the stream (``created_at_ts`` spread over
    ``[-lifetime, stream_hours]`` relative to the stream start) and readers
    only click articles younger than ``item_lifetime_hours`` — the item
    cold-start regime of real news (reference README.md:38-44): by the time
    a co-occurrence pair is counted, its items are dying.  ACE rows are
    ``category_signal``-correlated with the category id, so content
    similarity (which the NAR fuses via the ACE features) carries
    generalizable next-click signal that pure counting cannot reach.
    """
    rng = np.random.RandomState(seed)
    num_items = article_schema.num_items
    lifetime_s = int(item_lifetime_hours * SECONDS_PER_HOUR)

    metadata: Dict[str, np.ndarray] = {}
    births = base_epoch + rng.randint(
        -lifetime_s, stream_hours * SECONDS_PER_HOUR, size=num_items
    ).astype(np.int64)
    births[0] = 0
    cat_spec = next(
        (s for s in article_schema.features
         if s.kind == "categorical" and s.name != "article_id"),
        None,
    )
    num_categories = cat_spec.cardinality if cat_spec else 8
    for spec in article_schema.features:
        if spec.name == "article_id":
            continue
        if spec.name == "created_at_ts":
            metadata[spec.name] = births
        elif spec.kind == "categorical":
            col = rng.randint(1, spec.cardinality, size=num_items).astype(np.int64)
            col[0] = 0
            metadata[spec.name] = col
        else:
            metadata[spec.name] = rng.randn(num_items).astype(np.float32)

    categories = (
        metadata[cat_spec.name] if cat_spec
        else rng.randint(1, num_categories, size=num_items)
    )
    centroids = rng.randn(num_categories + 1, ace_dim).astype(np.float32)
    noise = rng.randn(num_items, ace_dim).astype(np.float32)
    ace = category_signal * centroids[categories] + (1.0 - category_signal) * noise
    ace /= np.maximum(np.linalg.norm(ace, axis=1, keepdims=True), 1e-9)
    # per-item identity wobble so same-category items stay distinguishable
    ace += 0.15 * noise / np.maximum(
        np.linalg.norm(noise, axis=1, keepdims=True), 1e-9
    )
    ace /= np.maximum(np.linalg.norm(ace, axis=1, keepdims=True), 1e-9)
    ace *= 0.1
    ace[0] = 0.0

    pop = rng.lognormal(0.0, 1.0, size=num_items)
    pop[0] = 0.0
    return SyntheticCorpus(num_items, metadata, ace, pop)


def synthetic_churn_hour_sessions(
    corpus: SyntheticCorpus,
    session_schema: SessionFeaturesSchema,
    hour_index: int,
    num_sessions: int,
    category_column: str = "category_id",
    item_lifetime_hours: float = 4.0,
    follow_category_prob: float = 0.75,
    max_session_length: int = 20,
    base_epoch: int = 72 * SECONDS_PER_HOUR,
    freshness_halflife_hours: float = 1.5,
    seed: int = 42,
) -> List[Session]:
    """One hour of sessions over the churning catalog: clicks land only on
    LIVE articles (age in [0, lifetime)), weighted by freshness × base
    popularity; the next click stays in the current article's CATEGORY with
    probability ``follow_category_prob``.  The generalizable predictors are
    content similarity + recency — exactly the NAR's ACE/recency features —
    while item-id co-occurrence pairs die with the articles."""
    rng = np.random.RandomState(seed + 1000 * hour_index)
    hour_start = base_epoch + hour_index * SECONDS_PER_HOUR
    created = corpus.metadata["created_at_ts"].astype(np.int64)
    categories = corpus.metadata[category_column].astype(np.int64)
    lifetime_s = int(item_lifetime_hours * SECONDS_PER_HOUR)

    age = hour_start - created
    live = (age >= 0) & (age < lifetime_s)
    live[0] = False
    if live.sum() < 3:
        raise ValueError(f"too few live items at hour {hour_index}")
    freshness = np.exp(
        -age / (freshness_halflife_hours * SECONDS_PER_HOUR * 1.4427)
    )
    weights = np.where(live, corpus.item_popularity * freshness, 0.0)
    probs = weights / weights.sum()

    # per-category live-item samplers
    cat_probs = {}
    for cat in np.unique(categories[live]):
        w = np.where(live & (categories == cat), weights, 0.0)
        cat_probs[int(cat)] = w / w.sum()

    ctx_specs = session_schema.context_sequence_features()
    sessions = []
    for i in range(num_sessions):
        n = int(rng.randint(2, max_session_length + 1))
        items = [int(rng.choice(corpus.num_items, p=probs))]
        while len(items) < n:
            cat = int(categories[items[-1]])
            if rng.rand() < follow_category_prob and cat in cat_probs:
                nxt = int(rng.choice(corpus.num_items, p=cat_probs[cat]))
            else:
                nxt = int(rng.choice(corpus.num_items, p=probs))
            items.append(max(nxt, 1))
        start = hour_start + int(rng.randint(0, SECONDS_PER_HOUR - n * 30))
        ts = start + np.cumsum(rng.randint(5, 30, size=n))
        context = {}
        for spec in ctx_specs:
            if spec.kind == "categorical":
                context[spec.name] = rng.randint(1, spec.cardinality, size=n).tolist()
            else:
                context[spec.name] = rng.uniform(-1, 1, size=n).astype(
                    np.float32
                ).tolist()
        sessions.append(
            Session(
                session_id=hour_index * 10_000_000 + i,
                user_id=int(rng.randint(1, 100000)),
                session_start=int(start),
                item_ids=items,
                timestamps=ts.astype(np.int64).tolist(),
                context=context,
            )
        )
    sessions.sort(key=lambda s: s.session_start)
    return sessions


def make_transition_graph(
    num_items: int, successors_per_item: int = 5, seed: int = 42
) -> np.ndarray:
    """Sparse next-click graph: item → ``successors_per_item`` likely
    successors.  Gives the stream real sequential structure so next-click
    accuracy is learnable (and the session models can beat popularity)."""
    rng = np.random.RandomState(seed + 7)
    succ = rng.randint(1, num_items, size=(num_items, successors_per_item))
    succ[0] = 0
    return succ


def synthetic_markov_hour_sessions(
    corpus: SyntheticCorpus,
    session_schema: SessionFeaturesSchema,
    transition_graph: np.ndarray,
    hour_index: int,
    num_sessions: int,
    max_session_length: int = 20,
    base_epoch: int = 72 * SECONDS_PER_HOUR,
    follow_prob: float = 0.8,
    seed: int = 42,
) -> List[Session]:
    """Sessions walking the transition graph: with probability
    ``follow_prob`` the next click is one of the current item's successors,
    otherwise a popularity-weighted jump."""
    rng = np.random.RandomState(seed + 1000 * hour_index)
    hour_start = base_epoch + hour_index * SECONDS_PER_HOUR
    weights = corpus.item_popularity.copy()
    weights[0] = 0.0
    probs = weights / weights.sum()
    ctx_specs = session_schema.context_sequence_features()

    sessions = []
    for i in range(num_sessions):
        n = int(rng.randint(2, max_session_length + 1))
        items = [int(rng.choice(corpus.num_items, p=probs))]
        while len(items) < n:
            if rng.rand() < follow_prob:
                nxt = int(rng.choice(transition_graph[items[-1]]))
            else:
                nxt = int(rng.choice(corpus.num_items, p=probs))
            if nxt == 0:
                nxt = 1
            items.append(nxt)
        start = hour_start + int(rng.randint(0, SECONDS_PER_HOUR - n * 30))
        ts = start + np.cumsum(rng.randint(5, 30, size=n))
        context = {}
        for spec in ctx_specs:
            if spec.kind == "categorical":
                context[spec.name] = rng.randint(1, spec.cardinality, size=n).tolist()
            else:
                context[spec.name] = rng.uniform(-1, 1, size=n).astype(
                    np.float32
                ).tolist()
        sessions.append(
            Session(
                session_id=hour_index * 10_000_000 + i,
                user_id=int(rng.randint(1, 100000)),
                session_start=int(start),
                item_ids=items,
                timestamps=ts.astype(np.int64).tolist(),
                context=context,
            )
        )
    sessions.sort(key=lambda s: s.session_start)
    return sessions


def synthetic_contextual_hour_sessions(
    corpus: SyntheticCorpus,
    session_schema: SessionFeaturesSchema,
    hour_index: int,
    num_sessions: int,
    context_feature: str = "device",
    num_context_values: int = 4,
    successors_per_context: int = 2,
    max_session_length: int = 20,
    base_epoch: int = 72 * SECONDS_PER_HOUR,
    follow_prob: float = 0.85,
    seed: int = 42,
) -> List[Session]:
    """Sessions whose next click depends on (current item, current CONTEXT):
    each (item, context-value) pair has its own successor set.  Counting
    baselines (co-occurrence, sequential rules) marginalize over context and
    top out; a model that fuses the context feature — the NAR's user-context
    towers — can separate the regimes."""
    graph_rng = np.random.RandomState(seed + 99)
    succ = graph_rng.randint(
        1, corpus.num_items,
        size=(corpus.num_items, num_context_values + 1, successors_per_context),
    )
    rng = np.random.RandomState(seed + 1000 * hour_index)
    hour_start = base_epoch + hour_index * SECONDS_PER_HOUR
    weights = corpus.item_popularity.copy()
    weights[0] = 0.0
    probs = weights / weights.sum()
    ctx_specs = session_schema.context_sequence_features()

    sessions = []
    for i in range(num_sessions):
        n = int(rng.randint(2, max_session_length + 1))
        ctx_vals = rng.randint(1, num_context_values + 1, size=n)
        items = [int(rng.choice(corpus.num_items, p=probs))]
        while len(items) < n:
            t = len(items) - 1
            if rng.rand() < follow_prob:
                nxt = int(rng.choice(succ[items[-1], ctx_vals[t]]))
            else:
                nxt = int(rng.choice(corpus.num_items, p=probs))
            items.append(max(nxt, 1))
        start = hour_start + int(rng.randint(0, SECONDS_PER_HOUR - n * 30))
        ts = start + np.cumsum(rng.randint(5, 30, size=n))
        context = {}
        for spec in ctx_specs:
            if spec.name == context_feature:
                context[spec.name] = ctx_vals.tolist()
            elif spec.kind == "categorical":
                context[spec.name] = rng.randint(1, spec.cardinality, size=n).tolist()
            else:
                context[spec.name] = rng.uniform(-1, 1, size=n).astype(
                    np.float32
                ).tolist()
        sessions.append(
            Session(
                session_id=hour_index * 10_000_000 + i,
                user_id=int(rng.randint(1, 100000)),
                session_start=int(start),
                item_ids=items,
                timestamps=ts.astype(np.int64).tolist(),
                context=context,
            )
        )
    sessions.sort(key=lambda s: s.session_start)
    return sessions


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

"""The one traffic generator: articles, ACEs and sessions from a traffic
mix's parameters, a configuration's schema and the run's seed.

Every seed gets the same multiset of session lengths (the mix's law at
fixed quantiles), in another order, so the work of a run does not move with
the seed; articles, clicks, times and context features are drawn.  Sessions
come as arrays (``Sessions``); ``serving_sessions`` gives the dicts that
both the system's ``Session`` and the reference's collations are made
from."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

HOUR = 3600
EPOCH = 7 * 24 * HOUR  # the first traffic hour starts a week into the data's clock


@dataclass
class Corpus:
    num_items: int
    metadata: Dict[str, np.ndarray]  # column -> [num_items]
    ace: np.ndarray  # [num_items, ace_dim] f32
    popularity: np.ndarray  # [num_items] weights, 0 for article 0


@dataclass
class Sessions:
    lengths: np.ndarray  # [n] clicks
    items: np.ndarray  # [n, L] int64, 0 past the end
    ts: np.ndarray  # [n, L] int64 seconds
    ctx: Dict[str, np.ndarray]  # [n, L] per context feature
    session_id: np.ndarray
    user_id: np.ndarray
    start: np.ndarray


def rngs(seed: int, n: int) -> List[np.random.Generator]:
    return [np.random.default_rng(s) for s in np.random.SeedSequence(seed).spawn(n)]


def make_corpus(config: dict, rng: np.random.Generator, zipf: float) -> Corpus:
    n = int(config["num_items"])
    meta = {}
    for name, kind, arg in config["article_features"]:
        if name == "article_id":
            continue
        if name == "created_at_ts":
            col = EPOCH - rng.integers(0, int(config["catalog_age_hours"] * HOUR), n)
        elif kind == "categorical":
            col = rng.integers(1, int(arg), n)
        else:
            col = rng.standard_normal(n).astype(np.float32)
        col[0] = 0
        meta[name] = col
    ace = rng.standard_normal((n, int(config["ace_dim"])), dtype=np.float32)
    ace *= np.float32(config["ace_row_norm"]) / np.linalg.norm(ace, axis=1, keepdims=True)
    ace[0] = 0.0
    pop = 1.0 / np.arange(1, n + 1) ** zipf
    rng.shuffle(pop)
    pop[0] = 0.0
    return Corpus(n, meta, ace, pop)


def session_lengths(law: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths in [min, max] with P(len) ~ (len - 1) ** -power, the
    law's quantiles at (i + 1/2) / n, shuffled."""
    lens = np.arange(int(law["min"]), int(law["max"]) + 1)
    p = (lens - 1.0) ** -float(law["power"])
    cdf = np.cumsum(p / p.sum())
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(lens[np.searchsorted(cdf, q)])


def hour_sessions(corpus: Corpus, config: dict, mix: dict, rng: np.random.Generator,
                  n: int, hour: int, first_id: int) -> Sessions:
    """``n`` sessions starting inside traffic hour ``hour`` (0 is the first
    hour after the history), sorted by start; clicks follow the articles'
    popularity, weighted towards fresh ones."""
    law = mix["session_length"]
    lmax = int(law["max"])
    lengths = session_lengths(law, n, rng)
    hour_start = EPOCH + hour * HOUR
    created = corpus.metadata["created_at_ts"].astype(np.float64)
    fresh = np.exp(-np.maximum(hour_start - created, 0) / (mix["freshness_hours"] * HOUR))
    w = corpus.popularity * (0.3 + fresh)
    items = rng.choice(corpus.num_items, size=(n, lmax), p=w / w.sum())
    col = np.arange(lmax)[None, :]
    live = col < lengths[:, None]
    items = np.where(live, items, 0)
    g0, g1 = mix["click_gap_s"]
    start = hour_start + rng.integers(0, HOUR - g1 * lmax, n)
    ts = start[:, None] + np.cumsum(rng.integers(g0, g1, (n, lmax)), 1)
    ts = np.where(live, ts, 0)
    ctx = {}
    for name, kind, arg in config["session_sequence"]:
        if name in ("event_timestamp", "item_clicked"):
            continue
        if kind == "categorical":
            v = rng.integers(1, int(arg), (n, lmax))
        else:
            v = rng.uniform(-1, 1, (n, lmax)).astype(np.float32)
        ctx[name] = np.where(live, v, 0).astype(v.dtype)
    order = np.argsort(start, kind="stable")
    return Sessions(lengths[order], items[order], ts[order],
                    {k: v[order] for k, v in ctx.items()},
                    first_id + np.arange(n, dtype=np.int64),
                    rng.integers(1, 100_000, n).astype(np.int64), start[order])


def history_clicks(s: Sessions):
    """The sessions' clicks as one [n, L] batch for the click stream."""
    return s.items.astype(np.int32), s.ts.astype(np.int32)


def serving_sessions(s: Sessions) -> List[dict]:
    """One dict per session: ``items``, ``ts``, ``ctx``, ``id``, ``user``,
    ``start``, each click list as long as the session."""
    items, ts = s.items.tolist(), s.ts.tolist()
    ctx = {k: v.tolist() for k, v in s.ctx.items()}
    out = []
    for i, n in enumerate(s.lengths.tolist()):
        out.append({
            "id": int(s.session_id[i]), "user": int(s.user_id[i]),
            "start": int(s.start[i]),
            "items": items[i][:n], "ts": ts[i][:n],
            "ctx": {k: v[i][:n] for k, v in ctx.items()},
        })
    return out

"""Full-scale pseudo-G1 bundle generator (Kaggle schema).

The port's copy of ``chameleon_recsys_tpu/data/pseudo_g1.py``: for the same
``PseudoG1Spec`` it writes the same bytes, at any worker count.  The real G1
dataset (news-portal-user-interactions-by-globocom) is proprietary, so this
module fabricates a *pseudo-G1* stream at the real shape (46,033 clicked
articles, 385 hourly click CSVs, ~1M sessions / ~2.9M clicks) in the exact
Kaggle file layout the CLIs consume (docs/G1_RECIPE.md; reference
nar_trainer_gcom.py:131-139 reads the same three artifacts).

Stream semantics (the regime the reference was built for, README.md:38-44):

- articles are BORN throughout the stream and die within ~36 h (news
  churn): click probability = base lognormal popularity × an exponential
  freshness decay (half-life 8 h), zero outside the live window;
- ~120 categories with Zipf-distributed sizes; the next click stays in the
  current article's category with p=0.75 (content signal), otherwise
  follows global popularity (recency signal);
- ACE rows are category-centroid correlated (0.8) with per-item wobble, so
  content similarity generalizes across the churning ids while item-id
  co-occurrence pairs die with the articles;
- session volume follows a São Paulo-local day/night curve; session length
  is 2 + geometric (mean ≈ 2.9, max 20), matching G1's short sessions.

Everything is vectorized: the per-category weighted draw is a searchsorted
into a per-hour cumulative-weight table laid out in category-sorted order,
so generating an hour costs O(items + clicks·log items), and hours are
independently seeded (hour h uses RandomState(seed + 1000 + h)) so a process
pool gives byte-identical files in any worker arrangement.
"""
from __future__ import annotations

import csv
import os
import pickle
from dataclasses import dataclass

import numpy as np

HOUR_MS = 3_600_000
# 2017-10-01 00:00:00 America/Sao_Paulo (-03:00) in ms — pseudo stream start
T0_MS = 1_506_826_800_000


@dataclass(frozen=True)
class PseudoG1Spec:
    num_articles: int = 46_033      # clicked catalog of the real G1
    num_categories: int = 120
    ace_dim: int = 250
    hours: int = 385                # real G1 ships 385 hourly click files
    mean_sessions_per_hour: int = 2_600   # ≈1.0M sessions over the stream
    num_users: int = 322_897
    live_window_hours: float = 36.0
    freshness_halflife_hours: float = 8.0
    follow_category_prob: float = 0.75
    max_session_length: int = 20
    seed: int = 7
    # --- mixed-behavior regime (round-5 hardening) -----------------------
    # With the legacy defaults below the stream is bit-identical to the
    # published round-4 campaigns.  The "mixed" preset makes the stream
    # discriminative between single-signal recommenders and the fused
    # model: next-click then depends on (a) a category-level Markov hop
    # structure no pure item-similarity recommender can express, (b) a
    # fraction of popularity-only sessions, and (c) ACE rows whose
    # category correlation carries extra noise.
    popularity_only_user_frac: float = 0.0  # sessions ignoring categories
    category_selfloop_prob: float = 1.0     # within "stay": P(next cat == cur)
    category_hops: int = 0                  # preferred next-cats per category
    ace_extra_noise: float = 0.0            # extra per-item ACE noise scale

    @classmethod
    def mixed(cls, **overrides) -> "PseudoG1Spec":
        """The hardened mixed-behavior preset (RESULTS.md round-5 streams)."""
        base = dict(
            popularity_only_user_frac=0.25,
            category_selfloop_prob=0.5,
            category_hops=3,
            ace_extra_noise=0.5,
        )
        base.update(overrides)
        return cls(**base)

    @property
    def is_mixed(self) -> bool:
        return (
            self.popularity_only_user_frac > 0
            or self.category_selfloop_prob < 1.0
            or self.category_hops > 0
        )


@dataclass
class PseudoG1Articles:
    categories: np.ndarray      # [A+1] int64, row 0 = padding
    created_at_ms: np.ndarray   # [A+1] int64
    popularity: np.ndarray      # [A+1] float64, row 0 = 0
    ace: np.ndarray             # [A+1, D] float32, row 0 = 0
    cat_order: np.ndarray       # article ids sorted by category
    cat_bounds: np.ndarray      # [num_categories+2] segment starts in cat_order
    cat_hops: np.ndarray = None  # [C+1, hops] preferred next-categories


def make_pseudo_g1_articles(spec: PseudoG1Spec) -> PseudoG1Articles:
    rng = np.random.RandomState(spec.seed)
    n = spec.num_articles + 1  # id 0 = padding row, like the Kaggle pickle

    # Zipf-sized categories (a few huge sections, a long tail) in 1..C
    cat_w = 1.0 / np.arange(1, spec.num_categories + 1) ** 1.1
    cat_w /= cat_w.sum()
    categories = rng.choice(
        np.arange(1, spec.num_categories + 1), size=n, p=cat_w
    ).astype(np.int64)
    categories[0] = 0

    # births spread from 48h before the stream through its whole length so
    # every hour has fresh arrivals and dying veterans
    created_at_ms = (
        T0_MS
        + rng.randint(-48 * HOUR_MS, spec.hours * HOUR_MS, size=n).astype(np.int64)
    )
    created_at_ms[0] = 0

    popularity = rng.lognormal(0.0, 1.2, size=n)
    popularity[0] = 0.0

    centroids = rng.randn(spec.num_categories + 1, spec.ace_dim).astype(np.float32)
    noise = rng.randn(n, spec.ace_dim).astype(np.float32)
    noise /= np.maximum(np.linalg.norm(noise, axis=1, keepdims=True), 1e-9)
    # Effective mix is 0.8·centroid + 0.35·noise (pre-normalization); the
    # two adds of the SAME unit-noise draw are kept as-is so the generated
    # stream stays bit-identical to the published campaign runs
    # (RESULTS.md round 4 — g1data/full_run*).
    ace = 0.8 * centroids[categories] + 0.2 * noise
    ace += 0.15 * noise
    ace /= np.maximum(np.linalg.norm(ace, axis=1, keepdims=True), 1e-9)
    if spec.ace_extra_noise > 0:
        # mixed regime: decorrelate content similarity from category (drawn
        # AFTER the legacy draws so legacy streams stay bit-identical)
        extra = rng.randn(n, spec.ace_dim).astype(np.float32)
        extra /= np.maximum(np.linalg.norm(extra, axis=1, keepdims=True), 1e-9)
        ace = ace + spec.ace_extra_noise * extra
        ace /= np.maximum(np.linalg.norm(ace, axis=1, keepdims=True), 1e-9)
    ace[0] = 0.0

    cat_order = np.argsort(categories, kind="stable")
    cat_bounds = np.searchsorted(
        categories[cat_order], np.arange(spec.num_categories + 2)
    )
    cat_hops = None
    if spec.category_hops > 0:
        # per-category preferred next-categories: a sparse category-level
        # Markov structure that a content-aware SEQUENCE model can learn
        # from ACE signatures but pure item-similarity cannot express
        hop_rng = np.random.RandomState(spec.seed + 777)
        cat_hops = hop_rng.randint(
            1, spec.num_categories + 1,
            size=(spec.num_categories + 1, spec.category_hops),
        ).astype(np.int64)
        cat_hops[0] = 0
    return PseudoG1Articles(
        categories, created_at_ms, popularity, ace, cat_order, cat_bounds,
        cat_hops,
    )


def _volume_factor(hour_index: int) -> float:
    """São Paulo-local day/night curve (mean exactly 1.0 over a day so
    ``mean_sessions_per_hour`` is the true average); T0 is local midnight."""
    hod = np.arange(24)
    base = 0.5 - 0.5 * np.cos(2 * np.pi * (hod - 3.0) / 24.0)
    curve = 0.22 + 1.35 * base ** 1.5
    curve /= curve.mean()
    return float(curve[hour_index % 24])


def generate_hour_clicks(
    spec: PseudoG1Spec, arts: PseudoG1Articles, hour_index: int
) -> dict:
    """One hour of Kaggle-schema click rows, fully vectorized.

    Returns dict of equal-length numpy columns (one element per click).
    """
    rng = np.random.RandomState(spec.seed + 1_000 + hour_index)
    hour_start_ms = T0_MS + hour_index * HOUR_MS

    age_h = (hour_start_ms - arts.created_at_ms) / HOUR_MS
    live = (age_h >= 0) & (age_h < spec.live_window_hours)
    live[0] = False
    freshness = np.exp2(-age_h / spec.freshness_halflife_hours)
    weights = np.where(live, arts.popularity * freshness, 0.0)

    # global sampler: padded cumsum + searchsorted
    cw = np.concatenate([[0.0], np.cumsum(weights)])
    total_w = cw[-1]
    if total_w <= 0:
        raise ValueError(f"no live articles at hour {hour_index}")

    # per-category sampler: the same cumsum trick in category-sorted layout
    w_sorted = weights[arts.cat_order]
    cwc = np.concatenate([[0.0], np.cumsum(w_sorted)])
    lo = arts.cat_bounds[:-1]
    hi = arts.cat_bounds[1:]
    cat_total = cwc[hi] - cwc[lo]   # [num_categories+1] live weight per cat

    def draw_global(k: int) -> np.ndarray:
        u = rng.random_sample(k) * total_w
        return np.searchsorted(cw, u, side="right") - 1

    n_sessions = int(
        rng.poisson(spec.mean_sessions_per_hour * _volume_factor(hour_index))
    )
    n_sessions = max(n_sessions, 8)
    lengths = np.minimum(
        2 + rng.geometric(0.55, size=n_sessions) - 1, spec.max_session_length
    )

    # step-synchronous walk: one vectorized draw per step over all sessions
    # still active at that step
    mixed = spec.is_mixed
    if mixed:
        pop_only = rng.random_sample(n_sessions) < spec.popularity_only_user_frac
    items = np.zeros((n_sessions, spec.max_session_length), dtype=np.int64)
    items[:, 0] = draw_global(n_sessions)
    for step in range(1, int(lengths.max())):
        active = np.nonzero(lengths > step)[0]
        if active.size == 0:
            break
        cur = items[active, step - 1]
        cats = arts.categories[cur]
        stay = rng.random_sample(active.size) < spec.follow_category_prob
        if mixed:
            stay &= ~pop_only[active]
            # category-level Markov hop: with p = 1 - selfloop the "stay"
            # branch moves to one of the category's preferred next-cats
            if arts.cat_hops is not None:
                hop = rng.random_sample(active.size) >= spec.category_selfloop_prob
                choice = rng.randint(0, spec.category_hops, size=active.size)
                hop &= stay
                cats = np.where(hop, arts.cat_hops[cats, choice], cats)
        stay &= cat_total[cats] > 0
        nxt = np.empty(active.size, dtype=np.int64)
        if (~stay).any():
            nxt[~stay] = draw_global(int((~stay).sum()))
        if stay.any():
            sc = cats[stay]
            u = cwc[lo[sc]] + rng.random_sample(int(stay.sum())) * cat_total[sc]
            nxt[stay] = arts.cat_order[np.searchsorted(cwc, u, side="right") - 1]
        items[active, step] = nxt

    session_start = hour_start_ms + rng.randint(
        0, HOUR_MS - 1, size=n_sessions
    ).astype(np.int64)
    order = np.argsort(session_start, kind="stable")
    session_start = session_start[order]
    lengths = lengths[order]
    items = items[order]

    sids = hour_index * 10_000_000 + np.arange(n_sessions, dtype=np.int64)
    # Zipf-ish user draw over the real user count
    users = (
        rng.zipf(1.4, size=n_sessions).astype(np.int64) % (spec.num_users - 1)
    ) + 1

    # explode to click rows
    n_clicks = int(lengths.sum())
    row_sess = np.repeat(np.arange(n_sessions), lengths)
    click_idx = np.concatenate([np.arange(k) for k in lengths])
    gaps = rng.randint(8_000, 45_000, size=n_clicks).astype(np.int64)
    # per-session cumulative gap (cumsum reset at session starts): the first
    # click lands exactly on session_start, later ones are 8-45s apart
    cum = np.cumsum(gaps)
    sess_first = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    click_ts = session_start[row_sess] + (cum - np.repeat(cum[sess_first], lengths))

    return {
        "user_id": users[row_sess],
        "session_id": sids[row_sess],
        "session_start": session_start[row_sess],
        "session_size": lengths[row_sess],
        "click_article_id": items[row_sess, click_idx],
        "click_timestamp": click_ts,
        "click_environment": rng.randint(1, 5, size=n_clicks),
        "click_deviceGroup": rng.randint(1, 6, size=n_clicks),
        "click_os": rng.randint(1, 23, size=n_clicks),
        "click_country": rng.randint(1, 12, size=n_clicks),
        "click_region": rng.randint(1, 29, size=n_clicks),
        "click_referrer_type": rng.randint(1, 8, size=n_clicks),
    }


_COLUMNS = [
    "user_id", "session_id", "session_start", "session_size",
    "click_article_id", "click_timestamp", "click_environment",
    "click_deviceGroup", "click_os", "click_country", "click_region",
    "click_referrer_type",
]


def write_hour_csv(spec: PseudoG1Spec, arts: PseudoG1Articles,
                   hour_index: int, path: str) -> tuple:
    """Returns (n_sessions, n_clicks) for the hour."""
    cols = generate_hour_clicks(spec, arts, hour_index)
    n = len(cols["session_id"])
    n_sessions = int(np.unique(cols["session_id"]).size)
    mat = np.stack([cols[c].astype(np.int64) for c in _COLUMNS], axis=1)
    with open(path, "w", newline="") as f:
        f.write(",".join(_COLUMNS) + "\n")
        np.savetxt(f, mat, fmt="%d", delimiter=",")
    return n_sessions, n


def write_bundle(spec: PseudoG1Spec, out_dir: str, num_workers: int = 1,
                 verbose: bool = True) -> dict:
    """Write the full Kaggle-shaped bundle; returns summary counts."""
    os.makedirs(os.path.join(out_dir, "clicks"), exist_ok=True)
    arts = make_pseudo_g1_articles(spec)

    with open(os.path.join(out_dir, "articles_metadata.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["article_id", "category_id", "created_at_ts",
                    "publisher_id", "words_count"])
        rng = np.random.RandomState(spec.seed + 99)
        words = rng.randint(80, 1200, size=spec.num_articles + 1)
        for i in range(spec.num_articles + 1):
            w.writerow([i, int(arts.categories[i]), int(arts.created_at_ms[i]),
                        0, int(words[i])])

    with open(os.path.join(out_dir, "articles_embeddings.pickle"), "wb") as f:
        pickle.dump(arts.ace, f)

    def path_for(h):
        return os.path.join(out_dir, "clicks", f"clicks_hour_{h:03d}.csv")

    totals = {"sessions": 0, "clicks": 0}
    if num_workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
            max_workers=num_workers, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            futs = {
                pool.submit(write_hour_csv, spec, arts, h, path_for(h)): h
                for h in range(spec.hours)
            }
            for fut in futs:
                ns, nc = fut.result()
                totals["sessions"] += ns
                totals["clicks"] += nc
    else:
        for h in range(spec.hours):
            ns, nc = write_hour_csv(spec, arts, h, path_for(h))
            totals["sessions"] += ns
            totals["clicks"] += nc
            if verbose and h % 50 == 0:
                print(f"wrote hour {h}")
    return totals

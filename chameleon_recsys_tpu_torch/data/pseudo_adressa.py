"""Full-scale pseudo-Adressa bundle generator (raw-input schema).

The port's copy of ``chameleon_recsys_tpu/data/pseudo_adressa.py``: for the
same ``PseudoAdressaSpec`` it writes the same bytes.  The real Adressa
dataset (SmartMedia, adressa.no) is licence-gated, so the Adressa chain runs
on a *pseudo-Adressa* stream generated here at the real shape (~13k
articles, 16 days (384 hours) of clicks, ~1M sessions) in the raw input
formats the CLI chain consumes end to end:

  * per-article JSON lines (title/body text, category0/category1, author,
    keywords, createtime) -> ``cli.acr_preprocess_adressa``
    (reference acr_module/acr/preprocessing/acr_preprocess_adressa.py:92-134
    parses the same fields from the Adressa "contentdata" records);
  * a word2vec text file for the vocabulary -> the same CLI (the reference
    uses the Norwegian NLPL word2vec model, README.md:154-160);
  * a click-log JSON lines file (userId, id, time, context ints,
    activeTime) -> ``cli.nar_preprocess_adressa``, which sessionizes it
    with the reference's 30-min-idle rule (the Dataproc notebook's job,
    nar_preprocessing_addressa_01_dataproc.ipynb).

Unlike G1 (which ships precomputed article embeddings), this exercises the
complete two-module pipeline: ACR preprocessing -> ACR training -> ACE
export -> NAR preprocessing -> NAR temporal training.

Stream semantics reuse the pseudo-G1 engine (data/pseudo_g1.py: article
churn with freshness decay, Zipf categories, 0.75 category-stay
transitions, day/night volume) with an Adressa-shaped spec.  Article text
carries the category signal the ACR classifier is trained on: 70% of each
article's tokens draw from its category's 250-token band, 30% from a
global Zipf tail, so a working text encoder separates categories and a
broken one does not.

userId is unique per session, which makes the 30-min-idle sessionization
reproduce the generated sessions exactly (within-session gaps are 8-45 s;
the reference's real stream has mostly-single-session users too: ~2M
users for the 16-day window).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from .pseudo_g1 import (
    PseudoG1Articles,
    PseudoG1Spec,
    generate_hour_clicks,
    make_pseudo_g1_articles,
)


@dataclass(frozen=True)
class PseudoAdressaSpec:
    num_articles: int = 13_000
    num_categories: int = 80
    hours: int = 384                      # 16 days
    mean_sessions_per_hour: int = 2_600   # ≈1M sessions over the stream
    vocab_size: int = 20_000
    word_dim: int = 100                   # the NLPL Norwegian w2v dim
    category_band: int = 250              # tokens preferred per category
    title_words: int = 8
    body_words: int = 120
    words_per_sentence: int = 12
    num_authors: int = 500
    seed: int = 11
    # mixed-behavior regime passthrough (data/pseudo_g1.py; the legacy
    # defaults keep the published streams bit-identical)
    popularity_only_user_frac: float = 0.0
    category_selfloop_prob: float = 1.0
    category_hops: int = 0
    ace_extra_noise: float = 0.0

    @classmethod
    def mixed(cls, **overrides) -> "PseudoAdressaSpec":
        base = dict(
            popularity_only_user_frac=0.25,
            category_selfloop_prob=0.5,
            category_hops=3,
            ace_extra_noise=0.5,
        )
        base.update(overrides)
        return cls(**base)

    def g1_spec(self) -> PseudoG1Spec:
        return PseudoG1Spec(
            num_articles=self.num_articles,
            num_categories=self.num_categories,
            hours=self.hours,
            mean_sessions_per_hour=self.mean_sessions_per_hour,
            seed=self.seed,
            popularity_only_user_frac=self.popularity_only_user_frac,
            category_selfloop_prob=self.category_selfloop_prob,
            category_hops=self.category_hops,
            ace_extra_noise=self.ace_extra_noise,
        )


def _category_tokens(rng, spec: PseudoAdressaSpec, category: int, k: int):
    """70% category-band tokens, 30% global Zipf tail (token 0 reserved)."""
    band_lo = 1 + (category * spec.category_band) % (spec.vocab_size - 1 - spec.category_band)
    from_band = rng.random_sample(k) < 0.7
    toks = np.empty(k, dtype=np.int64)
    toks[from_band] = band_lo + rng.randint(
        0, spec.category_band, size=int(from_band.sum())
    )
    tail = rng.zipf(1.3, size=int((~from_band).sum()))
    toks[~from_band] = 1 + (tail % (spec.vocab_size - 1))
    return toks


def write_word_embeddings(spec: PseudoAdressaSpec, path: str) -> None:
    """word2vec text format: header line then ``word v1 .. vD`` rows."""
    rng = np.random.RandomState(spec.seed + 5)
    with open(path, "w") as f:
        f.write(f"{spec.vocab_size} {spec.word_dim}\n")
        for i in range(spec.vocab_size):
            vec = rng.randn(spec.word_dim) * 0.1
            f.write(
                f"w{i} " + " ".join(f"{x:.4f}" for x in vec) + "\n"
            )


def write_articles_json(
    spec: PseudoAdressaSpec, arts: PseudoG1Articles, path: str
) -> int:
    """Per-article JSON lines in the acr_preprocess_adressa input schema."""
    rng = np.random.RandomState(spec.seed + 6)
    n = spec.num_articles
    with open(path, "w") as f:
        for i in range(1, n + 1):
            cat = int(arts.categories[i])
            title = _category_tokens(rng, spec, cat, spec.title_words)
            body = _category_tokens(rng, spec, cat, spec.body_words)
            # sentence structure for the first-12-sentences tokenizer
            words = [f"w{t}" for t in body]
            sentences = [
                " ".join(words[j:j + spec.words_per_sentence])
                for j in range(0, len(words), spec.words_per_sentence)
            ]
            rec = {
                "id": str(i),
                "title": " ".join(f"w{t}" for t in title),
                "body": ". ".join(sentences) + ".",
                "category0": f"c{cat}",
                "category1": f"c{cat}_s{int(rng.randint(0, 3))}",
                "author": f"a{int(rng.randint(0, spec.num_authors))}",
                "createtime": int(arts.created_at_ms[i] // 1000),
                "keywords": [f"kw{cat}", f"kw{(cat * 7 + 3) % 200}"],
            }
            f.write(json.dumps(rec) + "\n")
    return n


def write_clicks_json(
    spec: PseudoAdressaSpec, arts: PseudoG1Articles, path: str,
    verbose: bool = True,
) -> dict:
    """Click-log JSON lines (nar_preprocess_adressa input schema), in
    timestamp order within each hour.  Returns summary counts."""
    g1 = spec.g1_spec()
    totals = {"sessions": 0, "clicks": 0}
    with open(path, "w") as f:
        for h in range(spec.hours):
            cols = generate_hour_clicks(g1, arts, h)
            rng = np.random.RandomState(spec.seed + 50_000 + h)
            n = len(cols["click_article_id"])
            order = np.argsort(cols["click_timestamp"], kind="stable")
            city = rng.randint(1, 100, size=n)
            region = rng.randint(1, 20, size=n)
            country = rng.randint(1, 3, size=n)
            device = rng.randint(1, 5, size=n)
            oss = rng.randint(1, 8, size=n)
            ref = rng.randint(1, 7, size=n)
            active = rng.randint(5, 600, size=n)
            for j in order:
                rec = {
                    "userId": f"u{int(cols['session_id'][j])}",
                    "id": int(cols["click_article_id"][j]),
                    "time": int(cols["click_timestamp"][j] // 1000),
                    "city": int(city[j]),
                    "region": int(region[j]),
                    "country": int(country[j]),
                    "deviceType": int(device[j]),
                    "os": int(oss[j]),
                    "referrerClass": int(ref[j]),
                    "activeTime": int(active[j]),
                }
                f.write(json.dumps(rec) + "\n")
            totals["sessions"] += int(np.unique(cols["session_id"]).size)
            totals["clicks"] += n
            if verbose and h % 50 == 0:
                print(f"wrote clicks hour {h}")
    return totals


def write_bundle(spec: PseudoAdressaSpec, out_dir: str,
                 verbose: bool = True) -> dict:
    """Write the full raw bundle: articles.jsonl, w2v.txt, clicks.jsonl."""
    os.makedirs(out_dir, exist_ok=True)
    arts = make_pseudo_g1_articles(spec.g1_spec())
    n_articles = write_articles_json(
        spec, arts, os.path.join(out_dir, "articles.jsonl")
    )
    write_word_embeddings(spec, os.path.join(out_dir, "w2v.txt"))
    totals = write_clicks_json(
        spec, arts, os.path.join(out_dir, "clicks.jsonl"), verbose=verbose
    )
    totals["articles"] = n_articles
    return totals

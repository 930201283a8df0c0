"""Helpers of the G1/Globo.com ACR preprocessing that the Adressa ACR
preprocessing shares: the word2vec text reader, the label encoder and the
article record.

The port's copy of ``load_word2vec_text``, ``encode_labels`` and
``make_article_record`` of ``chameleon_recsys_tpu/cli/acr_preprocess_gcom.py``
(twin of the reference acr_module/acr/preprocessing/
acr_preprocess_gcom.py:15-224).  The CLI itself (``main``) comes with the
G1 ACR slice.
"""
from __future__ import annotations

import numpy as np

from ..data.example_proto import encode_sequence_example


def load_word2vec_text(path, limit=None):
    """word2vec text format -> dict word->vector (keeps gensim optional)."""
    vectors = {}
    with open(path, encoding="utf-8", errors="ignore") as f:
        first = f.readline().split()
        dim = int(first[1]) if len(first) == 2 else len(first) - 1
        if len(first) != 2:  # no header line: first line is a vector
            vectors[first[0]] = np.asarray(first[1:], np.float32)
        for i, line in enumerate(f):
            if limit and i >= limit:
                break
            parts = line.rstrip().split(" ")
            if len(parts) == dim + 1:
                vectors[parts[0]] = np.asarray(parts[1:], np.float32)
    return vectors, dim


def encode_labels(values):
    """value -> contiguous id starting at 1 (0 reserved for padding)."""
    encoder = {}
    encoded = []
    for v in values:
        if v not in encoder:
            encoder[v] = len(encoder) + 1
        encoded.append(encoder[v])
    return encoder, np.asarray(encoded, np.int64)


def make_article_record(article_id, category_id, created_at_ts, token_ids):
    return encode_sequence_example(
        context={
            "article_id": [int(article_id)],
            "category_id": [int(category_id)],
            "created_at_ts": [int(created_at_ts)],
            "text_length": [int(sum(1 for t in token_ids if t != 0))],
        },
        sequences={"text": [[int(t)] for t in token_ids]},
    )

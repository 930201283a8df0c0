"""Adressa ACR preprocessing: per-article JSON → tokenized arrays, encoders
with frequency thresholds + class weights, word-embedding matrix, TFRecords.

Twin of acr_module/acr/preprocessing/acr_preprocess_adressa.py:92-410:
  * parses article JSON records (title/teaser/body + NLP annotation fields —
    concepts/entities/locations/persons/keywords);
  * builds frequency-thresholded label encoders with <PAD>/<UNF> slots;
  * balanced class weights for the weighted classification heads
    (sklearn 'balanced' semantics: n / (n_classes · count));
  * Norwegian-style tokenization: first 12 sentences, ≤1000 words.

The port's copy of ``chameleon_recsys_tpu/cli/acr_preprocess_adressa.py``:
the same flags and the same output bytes (articles TFRecords, label encoders
with class weights, word-vocab embeddings).  Preprocessing never touches a
device: ``--platform`` takes ``cpu`` or ``cuda`` and ignores both.

Input: JSON lines, one article per line, with fields
  {"id": str, "title": str, "body": str, "category0": str, "category1": str,
   "author": str, "createtime": unix-seconds, "keywords": [str, ...]}
"""
from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

import numpy as np

from ..config import PAD_TOKEN
from ..data.example_proto import encode_sequence_example
from ..data.preprocessing.tokenization import (
    build_vocabulary,
    convert_tokens_to_int,
    tokenize_articles,
)
from ..data.preprocessing.word_embeddings import build_embedding_matrix_for_vocab
from ..data.tfrecord import write_tfrecord_file
from ..utils.io import serialize
from .acr_preprocess_gcom import load_word2vec_text

UNFREQ_TOKEN = "<UNF>"


def build_thresholded_encoder(values, min_freq: int = 1):
    """value → id with <PAD>=0 and <UNF>=1 for under-threshold values
    (reference process_cat_features, acr_preprocess_adressa.py:228-299)."""
    counts = Counter(v for v in values if v)
    encoder = {PAD_TOKEN: 0, UNFREQ_TOKEN: 1}
    for value, count in counts.most_common():
        if count >= min_freq:
            encoder[value] = len(encoder)
    encoded = [encoder.get(v, 1) if v else 0 for v in values]
    return encoder, np.asarray(encoded, np.int64)


def balanced_class_weights(encoded: np.ndarray, cardinality: int) -> np.ndarray:
    """sklearn 'balanced' class weights: n_samples/(n_classes·count)."""
    counts = np.bincount(encoded, minlength=cardinality).astype(np.float64)
    present = counts > 0
    weights = np.ones(cardinality, np.float64)
    weights[present] = len(encoded) / (present.sum() * counts[present])
    return weights.astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_articles_json_path", required=True)
    p.add_argument("--input_word_embeddings_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--vocab_most_freq_words", type=int, default=50000)
    p.add_argument("--max_sentences", type=int, default=12)
    p.add_argument("--max_words_length", type=int, default=1000)
    p.add_argument("--truncate_tokens_length", type=int, default=300)
    p.add_argument("--min_label_freq", type=int, default=2)
    p.add_argument("--articles_by_tfrecord", type=int, default=5000)
    p.add_argument(
        "--platform", default="", choices=("", "cpu", "cuda", "gpu"),
        help="accepted for the trainer's flag set and ignored: preprocessing "
        "runs on the host",
    )
    args = p.parse_args(argv)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    rows = []
    with open(args.input_articles_json_path) as f:
        for line in f:
            rows.append(json.loads(line))
    print(f"Loaded {len(rows)} articles")

    texts = [
        " ".join(
            str(r.get(k, "")) for k in ("title", "teaser", "body") if r.get(k)
        )
        for r in rows
    ]
    tokenized = tokenize_articles(
        texts,
        first_n_sentences=args.max_sentences,
        max_words=args.max_words_length,
    )

    # article ids are contiguous from 1 with <PAD>=0 and NO <UNF> slot — the
    # encoder must match the TFRecord ids / ACE rows exactly (an <UNF> slot
    # would shift every lookup off by one)
    id_encoder = {PAD_TOKEN: 0}
    for r in rows:
        id_encoder[r.get("id")] = len(id_encoder)
    article_ids = np.arange(1, len(rows) + 1)

    encoders = {"article_id": id_encoder}
    encoded_labels = {}
    class_weights = {}
    for label in ("category0", "category1", "author"):
        enc, vals = build_thresholded_encoder(
            [r.get(label) for r in rows], min_freq=args.min_label_freq
        )
        encoders[label] = enc
        encoded_labels[label] = vals
        class_weights[label] = balanced_class_weights(vals, len(enc))
    # multilabel keywords head (acr_trainer_adressa.py:83-88)
    kw_enc, _ = build_thresholded_encoder(
        [k for r in rows for k in (r.get("keywords") or [])],
        min_freq=args.min_label_freq,
    )
    encoders["keywords"] = kw_enc
    keywords_encoded = [
        [kw_enc.get(k, 1) for k in (r.get("keywords") or [])] for r in rows
    ]

    vocab_counts = build_vocabulary(tokenized, args.vocab_most_freq_words)
    pretrained, dim = load_word2vec_text(args.input_word_embeddings_path)
    vocab, emb_matrix = build_embedding_matrix_for_vocab(
        [w for w in vocab_counts if w not in (PAD_TOKEN, "<UNK>")],
        pretrained,
        embedding_size=dim,
        max_words=args.vocab_most_freq_words,
    )
    serialize(out / "acr_word_vocab_embeddings.pickle", (vocab, emb_matrix))
    serialize(
        out / "acr_label_encoders.pickle",
        {"encoders": encoders, "class_weights": class_weights},
    )

    records, chunk = [], 0
    created = [int(r.get("createtime", 0)) * 1000 for r in rows]
    for i in range(len(rows)):
        token_ids = convert_tokens_to_int(
            tokenized[i], vocab, args.truncate_tokens_length
        )
        records.append(
            encode_sequence_example(
                context={
                    "article_id": [int(article_ids[i])],
                    "category0": [int(encoded_labels["category0"][i])],
                    "category1": [int(encoded_labels["category1"][i])],
                    "author": [int(encoded_labels["author"][i])],
                    "created_at_ts": [created[i]],
                    "text_length": [sum(1 for t in token_ids if t != 0)],
                    "keywords": [int(k) for k in keywords_encoded[i]] or [0],
                },
                sequences={"text": [[int(t)] for t in token_ids]},
            )
        )
        if len(records) >= args.articles_by_tfrecord:
            write_tfrecord_file(
                out / f"articles_tokenized_{chunk:04d}.tfrecord.gz", records
            )
            records, chunk = [], chunk + 1
    if records:
        write_tfrecord_file(
            out / f"articles_tokenized_{chunk:04d}.tfrecord.gz", records
        )
    print("Preprocessing finalized")


if __name__ == "__main__":
    main()

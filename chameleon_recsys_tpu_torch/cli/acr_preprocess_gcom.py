"""G1/Globo.com ACR preprocessing: articles CSV -> tokenised article
TFRecords, the vocabulary/word-embedding pickle and the label-encoder pickle.

The port's copy of ``chameleon_recsys_tpu/cli/acr_preprocess_gcom.py``
(twin of the reference acr_module/acr/preprocessing/
acr_preprocess_gcom.py:15-224), with the same flags and byte-equal outputs:
clean the text (its first sentences), tokenise, label-encode the categories
and article ids, keep the vocabulary's words that the pretrained word2vec
has, and write the article records.  ``load_word2vec_text``,
``encode_labels`` and ``make_article_record`` also serve the Adressa ACR
preprocessing.  ``--platform`` is accepted and unused: nothing here runs on
a device.

Usage (mirrors run_acr_preprocessing_gcom.sh):
  python -m chameleon_recsys_tpu_torch.cli.acr_preprocess_gcom \
    --input_articles_csv_path articles.csv \
    --input_word_embeddings_path word2vec.txt \
    --output_dir acr_preprocessed/
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from ..data.example_proto import encode_sequence_example
from ..data.preprocessing.tokenization import (
    build_vocabulary,
    convert_tokens_to_int,
    tokenize_articles,
)
from ..data.preprocessing.word_embeddings import build_embedding_matrix_for_vocab
from ..data.tfrecord import write_tfrecord_file
from ..utils.io import serialize


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


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_articles_csv_path", required=True)
    parser.add_argument("--input_word_embeddings_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--vocab_most_freq_words", type=int, default=50000)
    parser.add_argument("--max_words_length", type=int, default=1000)
    parser.add_argument("--first_sentences", type=int, default=8)
    parser.add_argument("--truncate_tokens_length", type=int, default=300)
    parser.add_argument("--articles_by_tfrecord", type=int, default=5000)
    parser.add_argument("--platform", default="", help="accepted, unused")
    args = parser.parse_args(argv)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    with open(args.input_articles_csv_path) as f:
        rows = list(csv.DictReader(f))
    print(f"Loaded {len(rows)} articles")

    texts = [r.get("text_highlights", r.get("text", "")) for r in rows]
    tokenized = tokenize_articles(
        texts, first_n_sentences=args.first_sentences, max_words=args.max_words_length
    )

    cat_encoder, category_ids = encode_labels([r["category_id"] for r in rows])
    id_encoder, article_ids = encode_labels([r["article_id"] for r in rows])
    created = np.asarray([int(r.get("created_at_ts", 0)) for r in rows], np.int64)

    vocab_counts = build_vocabulary(tokenized, args.vocab_most_freq_words)
    pretrained, dim = load_word2vec_text(args.input_word_embeddings_path)
    vocab, emb_matrix = build_embedding_matrix_for_vocab(
        [w for w in vocab_counts if w not in ("<PAD>", "<UNK>")],
        pretrained,
        embedding_size=dim,
        max_words=args.vocab_most_freq_words,
    )
    serialize(out / "acr_word_vocab_embeddings.pickle", (vocab, emb_matrix))
    serialize(
        out / "acr_label_encoders.pickle",
        {"category_id": cat_encoder, "article_id": id_encoder},
    )
    print(f"Vocab size {len(vocab)}, embedding dim {dim}")

    records, chunk = [], 0
    for i in range(len(rows)):
        token_ids = convert_tokens_to_int(tokenized[i], vocab, args.truncate_tokens_length)
        records.append(
            make_article_record(article_ids[i], category_ids[i], created[i], token_ids)
        )
        if len(records) >= args.articles_by_tfrecord:
            write_tfrecord_file(out / f"articles_tokenized_{chunk:04d}.tfrecord.gz", records)
            records, chunk = [], chunk + 1
    if records:
        write_tfrecord_file(out / f"articles_tokenized_{chunk:04d}.tfrecord.gz", records)
    print("Preprocessing finalized")


if __name__ == "__main__":
    main()

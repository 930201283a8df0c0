"""Unsupervised ACE baselines CLI: the reference's six per-dataset scripts
(acr_module/acr/preprocessing/{lsa,doc2vec,w2v_tfidf}_{gcom,adressa}.py) as
one entry point over the shared preprocessed-article artifacts.

The port's copy of ``chameleon_recsys_tpu/cli/ace_baselines_cli.py``, with
the same flags.  It reads the ACR preprocessing outputs (tokenised-article
TFRecords, the vocabulary/word-embedding and label-encoder pickles) and
exports the ``(label_encoders, metadata, ace_matrix)`` handoff pickle the
neural ACR trainer writes (acr_trainer_adressa.py:250-254), so any ACE
source is a drop-in for the NAR trainers.  LSA runs on the token stream
rebuilt through the vocabulary (the reference re-vectorises the raw cleaned
text, lsa_gcom.py:141-166): equal up to the preprocessing vocabulary's
cut-off, and no raw-dataset input.

``--platform`` picks doc2vec's device: empty, ``cuda`` or ``gpu`` the card,
``cpu`` the CPU; without a card and without ``--platform cpu`` the CLI
exits with an error.  LSA and W2V-TF-IDF run on the host.

    python -m chameleon_recsys_tpu_torch.cli.ace_baselines_cli \
      --method lsa \
      --train_set_path_regex 'acr_preprocessed/articles_tokenized_*.tfrecord.gz' \
      --input_word_vocab_embeddings_path acr_preprocessed/acr_word_vocab_embeddings.pickle \
      --input_label_encoders_path acr_preprocessed/acr_label_encoders.pickle \
      --output_acr_metadata_embeddings_path ace_lsa.pickle
"""
from __future__ import annotations

import argparse
import glob

import numpy as np

from ..acr.ace_baselines import doc2vec_ace, lsa_ace, w2v_tfidf_ace
from ..acr.trainer import export_ace_pickle
from ..utils.io import deserialize
from .acr_trainer_gcom import load_article_arrays
from .nar_trainer_gcom import select_device

METHODS = ("lsa", "w2v_tfidf", "doc2vec")


def build_baseline_ace(
    method: str,
    token_ids: np.ndarray,
    vocab: dict,
    word_embeddings: np.ndarray,
    dim: int,
    epochs: int,
    seed: int,
    device="cuda",
) -> np.ndarray:
    """[N + 1, dim (or the word dim)] ACE matrix (padding row 0 = the mean)
    for articles sorted by id."""
    if method == "lsa":
        inv_vocab = {i: w for w, i in vocab.items()}
        texts = [
            " ".join(inv_vocab.get(int(t), "") for t in row if t != 0)
            for row in token_ids
        ]
        return lsa_ace(texts, dim=dim, seed=seed)
    if method == "w2v_tfidf":
        return w2v_tfidf_ace(token_ids, word_embeddings)
    if method == "doc2vec":
        return doc2vec_ace(token_ids, vocab_size=word_embeddings.shape[0], dim=dim,
                           epochs=epochs, seed=seed, device=device)
    raise ValueError(f"unknown --method {method!r}; choose from {METHODS}")


def create_args_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--method", required=True, choices=METHODS)
    p.add_argument("--train_set_path_regex", required=True)
    p.add_argument("--input_word_vocab_embeddings_path", required=True)
    p.add_argument("--input_label_encoders_path", required=True)
    p.add_argument("--output_acr_metadata_embeddings_path", required=True)
    p.add_argument("--acr_embeddings_size", type=int, default=250)
    p.add_argument("--training_epochs", type=int, default=30)
    p.add_argument("--truncate_tokens_length", type=int, default=300)
    p.add_argument("--random_seed", type=int, default=42)
    p.add_argument("--platform", default="", choices=("", "cuda", "gpu", "cpu"),
                   help="doc2vec's device: empty, cuda or gpu = the card, cpu = the CPU")
    return p


def main(argv=None):
    args = create_args_parser().parse_args(argv)
    device = select_device(args.platform)

    files = sorted(glob.glob(args.train_set_path_regex))
    if not files:
        raise FileNotFoundError(args.train_set_path_regex)
    articles = load_article_arrays(files, args.truncate_tokens_length)
    vocab, word_embeddings = deserialize(args.input_word_vocab_embeddings_path)
    label_encoders = deserialize(args.input_label_encoders_path)
    # The Adressa preprocessing pickle wraps the per-feature encoders as
    # {"encoders": {...}, "class_weights": {...}}; the NAR handoff contract
    # stores the flat encoders dict (the NAR trainer sizes the article
    # feature tables from its keys)
    if isinstance(label_encoders, dict) and "encoders" in label_encoders:
        label_encoders = label_encoders["encoders"]

    # ACE row i must be article id i: sort, and check the contiguity
    # invariant as the neural trainer does (acr/trainer.py::build_ace_matrix)
    ids = np.asarray(articles["article_id"])
    order = np.argsort(ids)
    if not np.array_equal(ids[order], np.arange(1, len(ids) + 1)):
        raise AssertionError(
            "article ids must be contiguous starting from 1 "
            "(reference invariant, acr_trainer_adressa.py:264-275)"
        )
    token_ids = np.asarray(articles["text"])[order]

    ace_matrix = build_baseline_ace(
        args.method, token_ids, vocab, np.asarray(word_embeddings),
        dim=args.acr_embeddings_size, epochs=args.training_epochs,
        seed=args.random_seed, device=device,
    )
    metadata = {
        key: np.concatenate([[0], np.asarray(vals)[order]])
        for key, vals in articles.items()
        if key not in ("text", "text_length")
    }
    export_ace_pickle(
        args.output_acr_metadata_embeddings_path, label_encoders, metadata,
        ace_matrix,
    )
    print(
        f"Exported {args.method} ACE matrix {ace_matrix.shape} to "
        f"{args.output_acr_metadata_embeddings_path}"
    )


if __name__ == "__main__":
    main()

"""ACR training CLI for G1/Globo.com: train the ACE side task on tokenised
article TFRecords and export the NAR handoff pickle.

The port's copy of ``chameleon_recsys_tpu/cli/acr_trainer_gcom.py`` (twin
of acr_module/acr/acr_trainer_gcom.py:1-352), with the same flags and
defaults and both tasks: ``metadata_classification`` (one multiclass head on
``category_id``) and ``autoencoder`` (the GRU denoising autoencoder, no
head).  ``load_article_arrays`` also serves ``ace_baselines_cli``.

``--platform`` picks the device: empty, ``cuda`` or ``gpu`` the card,
``cpu`` the CPU; without a card and without ``--platform cpu`` the CLI
exits with an error.

Usage (mirrors run_acr_training_gcom_autoencoder.sh):
  python -m chameleon_recsys_tpu_torch.cli.acr_trainer_gcom \
    --train_set_path_regex "acr_preprocessed/articles_tokenized_*.tfrecord.gz" \
    --input_word_vocab_embeddings_path acr_preprocessed/acr_word_vocab_embeddings.pickle \
    --input_label_encoders_path acr_preprocessed/acr_label_encoders.pickle \
    --output_acr_metadata_embeddings_path acr_articles_metadata_embeddings.pickle \
    --training_task autoencoder --text_feature_extractor GRU
"""
from __future__ import annotations

import argparse
import glob
import pickle

import numpy as np

from ..acr.trainer import ACRTrainer, export_ace_pickle
from ..config import ACRConfig
from ..data.example_proto import decode_sequence_example
from ..data.tfrecord import read_tfrecord_file
from ..models.acr import ACRLabelSpec
from .nar_trainer_gcom import select_device


def load_article_arrays(tfrecord_paths, truncate_tokens_length):
    ids, cats, created, lengths, texts = [], [], [], [], []
    extras = {}
    for path in tfrecord_paths:
        for record in read_tfrecord_file(path):
            context, sequences = decode_sequence_example(record)
            ids.append(context["article_id"][0])
            cats.append(context.get("category_id", [0])[0])
            created.append(context.get("created_at_ts", [0])[0])
            # dataset-specific scalar metadata (e.g. Adressa's category0/
            # category1/author) rides along for the handoff metadata
            for key, vals in context.items():
                if (
                    key not in ("article_id", "category_id", "created_at_ts")
                    and len(vals) == 1
                    and isinstance(vals[0], (int, np.integer))
                ):
                    extras.setdefault(key, []).append(int(vals[0]))
            tokens = [int(step[0]) if step else 0 for step in sequences["text"]]
            tokens = tokens[:truncate_tokens_length]
            tokens += [0] * (truncate_tokens_length - len(tokens))
            texts.append(tokens)
            lengths.append(sum(1 for t in tokens if t != 0))
    arrays = {
        "article_id": np.asarray(ids, np.int64),
        "category_id": np.asarray(cats, np.int64),
        "created_at_ts": np.asarray(created, np.int64),
        "text": np.asarray(texts, np.int32),
        "text_length": np.asarray(lengths, np.int32),
    }
    for key, vals in extras.items():
        if len(vals) == len(ids):  # only fields present on every article
            arrays[key] = np.asarray(vals, np.int64)
    return arrays


def create_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--train_set_path_regex", required=True)
    p.add_argument("--input_word_vocab_embeddings_path", required=True)
    p.add_argument("--input_label_encoders_path", required=True)
    p.add_argument("--output_acr_metadata_embeddings_path", required=True)
    p.add_argument("--training_task", default="metadata_classification")
    p.add_argument("--text_feature_extractor", default="CNN")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--training_epochs", type=int, default=5)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--dropout_keep_prob", type=float, default=1.0)
    p.add_argument("--l2_reg_lambda", type=float, default=7e-4)
    p.add_argument("--acr_embeddings_size", type=int, default=250)
    p.add_argument("--cnn_filter_sizes", default="3,4,5")
    p.add_argument("--cnn_num_filters", type=int, default=128)
    p.add_argument("--rnn_units", type=int, default=250)
    p.add_argument("--rnn_layers", type=int, default=1)
    p.add_argument("--rnn_direction", default="unidirectional",
                   choices=["unidirectional", "bidirectional"])
    p.add_argument("--truncate_tokens_length", type=int, default=300)
    p.add_argument("--autoencoder_noise", type=float, default=0.0)
    p.add_argument("--platform", default="", choices=("", "cuda", "gpu", "cpu"),
                   help="the device: empty, cuda or gpu = the card, cpu = the CPU")
    return p


def main(argv=None):
    args = create_args_parser().parse_args(argv)
    device = select_device(args.platform)

    with open(args.input_word_vocab_embeddings_path, "rb") as f:
        vocab, word_embeddings = pickle.load(f)
    with open(args.input_label_encoders_path, "rb") as f:
        label_encoders = pickle.load(f)

    files = sorted(glob.glob(args.train_set_path_regex))
    if not files:
        raise SystemExit(f"no article files match {args.train_set_path_regex}")
    articles = load_article_arrays(files, args.truncate_tokens_length)
    print(f"Loaded {len(articles['article_id'])} articles")

    cfg = ACRConfig(
        training_task=args.training_task,
        text_feature_extractor=args.text_feature_extractor,
        word_embedding_size=word_embeddings.shape[1],
        vocab_size=word_embeddings.shape[0],
        truncate_tokens_length=args.truncate_tokens_length,
        acr_embeddings_size=args.acr_embeddings_size,
        cnn_filter_sizes=tuple(int(x) for x in args.cnn_filter_sizes.split(",")),
        cnn_num_filters=args.cnn_num_filters,
        rnn_units=args.rnn_units,
        rnn_layers=args.rnn_layers,
        rnn_direction=args.rnn_direction,
        learning_rate=args.learning_rate,
        dropout_keep_prob=args.dropout_keep_prob,
        l2_reg_lambda=args.l2_reg_lambda,
        autoencoder_noise=args.autoencoder_noise,
        batch_size=args.batch_size,
        training_epochs=args.training_epochs,
    )

    label_specs = ()
    if args.training_task == "metadata_classification":
        num_categories = int(articles["category_id"].max()) + 1
        label_specs = (ACRLabelSpec("category_id", num_categories, "multiclass"),)

    trainer = ACRTrainer(cfg, word_embeddings, label_specs, device=device)
    trainer.fit(articles)
    # evaluate on the train set: the reference's deliberate-overfit check
    # (acr_trainer_adressa.py:368-375)
    train_metrics = trainer.evaluate(articles)
    if train_metrics:
        print(f"Train-set metrics: {train_metrics}")
    ace_matrix = trainer.build_ace_matrix(articles)

    metadata = {
        "article_id": np.concatenate([[0], articles["article_id"]]),
        "category_id": np.concatenate([[0], articles["category_id"]]),
        "created_at_ts": np.concatenate([[0], articles["created_at_ts"]]),
    }
    export_ace_pickle(
        args.output_acr_metadata_embeddings_path, label_encoders, metadata,
        ace_matrix,
    )
    print(f"Exported ACE matrix {ace_matrix.shape} to "
          f"{args.output_acr_metadata_embeddings_path}")


if __name__ == "__main__":
    main()

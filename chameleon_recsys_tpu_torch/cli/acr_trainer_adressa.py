"""ACR training CLI for Adressa: the multi-head ACE side task.

The port's copy of ``chameleon_recsys_tpu/cli/acr_trainer_adressa.py``
(twin of acr_module/acr/acr_trainer_adressa.py:1-408), with the same flags
and defaults: two label heads (``category0`` weighted multiclass +
``keywords`` multilabel, reference :83-88), class weights from the
preprocessing, and the metadata exported with the extra columns.

``--platform`` picks the device: empty, ``cuda`` or ``gpu`` the card,
``cpu`` the CPU; without a card and without ``--platform cpu`` the CLI
exits with an error.  The flags of features not ported yet
(``--training_task autoencoder``, ``--dropout_keep_prob`` < 1) exit at parse
time, before any file is read, naming the slice they wait for.

Usage (mirrors run_acr_training_adressa_local.sh):
  python -m chameleon_recsys_tpu_torch.cli.acr_trainer_adressa \
    --train_set_path_regex "acr_pre/articles_tokenized_*.tfrecord.gz" \
    --input_word_vocab_embeddings_path acr_pre/acr_word_vocab_embeddings.pickle \
    --input_label_encoders_path acr_pre/acr_label_encoders.pickle \
    --output_acr_metadata_embeddings_path acr_articles_metadata_embeddings.pickle
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
from .nar_trainer_gcom import refuse_not_ported, select_device

MAX_KEYWORDS = 10


def load_article_arrays(tfrecord_paths, truncate_tokens_length):
    cols = {k: [] for k in (
        "article_id", "category0", "category1", "author", "created_at_ts",
    )}
    texts, lengths, keywords = [], [], []
    for path in tfrecord_paths:
        for record in read_tfrecord_file(path):
            context, sequences = decode_sequence_example(record)
            for k in cols:
                cols[k].append(context.get(k, [0])[0])
            tokens = [int(s[0]) if s else 0 for s in sequences["text"]]
            tokens = tokens[:truncate_tokens_length]
            tokens += [0] * (truncate_tokens_length - len(tokens))
            texts.append(tokens)
            lengths.append(sum(1 for t in tokens if t != 0))
            kw = list(context.get("keywords", []))[:MAX_KEYWORDS]
            kw += [0] * (MAX_KEYWORDS - len(kw))
            keywords.append(kw)
    arrays = {k: np.asarray(v, np.int64) for k, v in cols.items()}
    arrays["text"] = np.asarray(texts, np.int32)
    arrays["text_length"] = np.asarray(lengths, np.int32)
    arrays["keywords"] = np.asarray(keywords, np.int64)
    return arrays


def create_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--train_set_path_regex", required=True)
    p.add_argument("--input_word_vocab_embeddings_path", required=True)
    p.add_argument("--input_label_encoders_path", required=True)
    p.add_argument("--output_acr_metadata_embeddings_path", required=True)
    p.add_argument("--training_task", default="metadata_classification")
    p.add_argument("--text_feature_extractor", default="GRU")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--training_epochs", type=int, default=5)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--dropout_keep_prob", type=float, default=1.0)
    p.add_argument("--l2_reg_lambda", type=float, default=7e-4)
    p.add_argument("--acr_embeddings_size", type=int, default=250)
    p.add_argument("--rnn_units", type=int, default=250)
    p.add_argument("--rnn_layers", type=int, default=1)
    p.add_argument("--rnn_direction", default="unidirectional",
                   choices=["unidirectional", "bidirectional"])
    p.add_argument("--truncate_tokens_length", type=int, default=300)
    p.add_argument("--autoencoder_noise", type=float, default=0.0)
    p.add_argument("--keywords_weight_on_loss", type=float, default=1.0)
    p.add_argument("--platform", default="", choices=("", "cuda", "gpu", "cpu"),
                   help="the device: empty, cuda or gpu = the card, cpu = the CPU")
    return p


# flag -> (is it set to a feature not ported yet, the slice it waits for)
_NOT_PORTED = {
    "--training_task": (lambda a: a.training_task == "autoencoder", "G1 ACR"),
    "--dropout_keep_prob": (lambda a: a.dropout_keep_prob < 1.0,
                            "dropout and dense grid path"),
}


def parse_args(argv=None):
    """The parsed flags; exits (status 2) on a flag set to a feature that is
    not ported yet, before anything is read."""
    return refuse_not_ported(create_args_parser(), _NOT_PORTED, argv)


def main(argv=None):
    args = parse_args(argv)
    device = select_device(args.platform)

    with open(args.input_word_vocab_embeddings_path, "rb") as f:
        vocab, word_embeddings = pickle.load(f)
    with open(args.input_label_encoders_path, "rb") as f:
        enc_payload = pickle.load(f)
    encoders = enc_payload["encoders"]
    class_weights = enc_payload.get("class_weights", {})

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

    label_specs = (
        ACRLabelSpec("category0", len(encoders["category0"]), "multiclass"),
        ACRLabelSpec(
            "keywords", len(encoders["keywords"]), "multilabel",
            feature_weight_on_loss=args.keywords_weight_on_loss,
        ),
    )
    trainer_class_weights = {
        "category0": np.asarray(class_weights["category0"], np.float32)
    }

    trainer = ACRTrainer(cfg, word_embeddings, label_specs, trainer_class_weights,
                         device=device)
    trainer.fit(articles)
    # evaluate on the train set: the reference's deliberate-overfit check
    # (acr_trainer_adressa.py:368-375)
    train_metrics = trainer.evaluate(articles)
    if train_metrics:
        print(f"Train-set metrics: {train_metrics}")
    ace_matrix = trainer.build_ace_matrix(articles)

    metadata = {
        key: np.concatenate([[0], articles[key]])
        for key in ("article_id", "category0", "category1", "author",
                    "created_at_ts")
    }
    export_ace_pickle(
        args.output_acr_metadata_embeddings_path, encoders, metadata, ace_matrix
    )
    print(
        f"Exported ACE matrix {ace_matrix.shape} to "
        f"{args.output_acr_metadata_embeddings_path}"
    )


if __name__ == "__main__":
    main()

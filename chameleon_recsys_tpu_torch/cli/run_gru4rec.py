"""GRU4Rec standalone temporal runner CLI.

The port's copy of ``chameleon_recsys_tpu/cli/run_gru4rec.py`` (twin of
nar_module/nar/benchmarks/gru4rec/run_gru4rec.py:91-297), with the same
flags and defaults: walk the same hour chunks as the NAR trainer, train
GRU4Rec per chunk (+2 extra epochs on the chunk's last hour), evaluate the
next hour against the per-session negative samples the NAR eval exported
(eval_sessions_negative_samples.json), and write the metric CSV.

``--platform`` picks the device: empty, ``cuda`` or ``gpu`` the card,
``cpu`` the CPU; without a card and without ``--platform cpu`` the CLI
exits with an error.

  python -m chameleon_recsys_tpu_torch.cli.run_gru4rec \
    --train_set_path_regex "sessions/sessions_hour_*.tfrecord.gz" \
    --eval_sessions_negative_samples_json_path nar_model/eval_sessions_negative_samples.json \
    --num_items 46033 --output_csv gru4rec_metrics.csv
"""
from __future__ import annotations

import argparse
import glob
import logging

import numpy as np

from ..baselines.gru4rec import GRU4Rec
from ..baselines.neural_runner import (
    NeuralBaselineRunner,
    load_eval_negative_samples,
)
from ..config import FeatureSpec, NARConfig, SessionFeaturesSchema
from ..data.sessions import read_sessions_tfrecord
from ..metrics.evaluation import create_eval_metrics
from ..utils.io import save_eval_benchmark_metrics_csv
from .nar_trainer_gcom import select_device


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--train_set_path_regex", required=True)
    p.add_argument("--eval_sessions_negative_samples_json_path", default="")
    p.add_argument("--num_items", type=int, required=True)
    p.add_argument("--output_csv", required=True)
    p.add_argument("--training_hours_for_each_eval", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--truncate_session_length", type=int, default=20)
    # reference config: bpr-max-0.5, layers [300], n_sample 200
    p.add_argument("--loss", default="bpr-max")
    p.add_argument("--bpreg", type=float, default=0.5)
    p.add_argument("--layers", default="300")
    p.add_argument("--n_sample", type=int, default=200)
    p.add_argument("--learning_rate", type=float, default=0.05)
    # reference optimizer flags (run_gru4rec.py: adapt=ARGS.optimizer,
    # decay=0.0, lmbd=ARGS.l2_lambda, momentum=ARGS.momentum)
    p.add_argument("--optimizer", default="adagrad",
                   choices=["adagrad", "adam", "adadelta", "rmsprop", "sgd"])
    p.add_argument("--optimizer_decay", type=float, default=0.9)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--l2_lambda", type=float, default=0.0)
    p.add_argument("--dropout_p_hidden", type=float, default=0.0)
    p.add_argument("--eval_total_negative_samples", type=int, default=50)
    p.add_argument("--eval_metrics_top_n", type=int, default=10)
    p.add_argument("--eval_negative_sample_relevance", type=float, default=0.02)
    p.add_argument("--platform", default="", choices=("", "cuda", "gpu", "cpu"),
                   help="the device: the card unless cpu")
    return p


def minimal_session_schema(num_items: int) -> SessionFeaturesSchema:
    """The external baselines consume only item ids, timestamps and session
    boundaries (run_gru4rec.py:141-268 — no context features), so the
    runner uses a dataset-agnostic minimal schema: the same session
    TFRecords work whether they came from the G1 or the Adressa
    preprocessor (whose context-feature sets differ)."""
    return SessionFeaturesSchema(
        single=(
            FeatureSpec("user_id", "categorical", 1),
            FeatureSpec("session_id", "numerical", dtype="int"),
            FeatureSpec("session_start", "numerical", dtype="int"),
            FeatureSpec("session_size", "numerical", dtype="int"),
        ),
        sequence=(
            FeatureSpec("event_timestamp", "numerical", dtype="int"),
            FeatureSpec("item_clicked", "categorical", num_items),
        ),
    )


def run_from_args(args, model_factory=None):
    """Runs the protocol over the session files; ``model_factory(args,
    device)`` builds the model (GRU4Rec from the flags by default).  Returns
    the eval rows."""
    logging.basicConfig(level=logging.INFO)
    device = select_device(args.platform)
    schema = minimal_session_schema(args.num_items)
    files = sorted(glob.glob(args.train_set_path_regex))
    if not files:
        raise SystemExit(f"no session files match {args.train_set_path_regex}")

    neg_samples = (
        load_eval_negative_samples(args.eval_sessions_negative_samples_json_path)
        if args.eval_sessions_negative_samples_json_path
        else None
    )
    cfg = NARConfig(
        batch_size=args.batch_size,
        max_session_length=args.truncate_session_length,
        metrics_top_n=args.eval_metrics_top_n,
        eval_negative_samples=args.eval_total_negative_samples,
    )
    model = (
        model_factory(args, device)
        if model_factory
        else GRU4Rec(
            args.num_items,
            layers=tuple(int(x) for x in args.layers.split(",")),
            loss=args.loss,
            bpreg=args.bpreg,
            n_sample=args.n_sample,
            learning_rate=args.learning_rate,
            optimizer=args.optimizer,
            decay=args.optimizer_decay,
            momentum=args.momentum,
            lmbd=args.l2_lambda,
            dropout_p_hidden=args.dropout_p_hidden,
            device=device,
        )
    )

    def create_metrics():
        return create_eval_metrics(
            args.eval_metrics_top_n,
            args.eval_negative_sample_relevance,
            False,
            np.zeros((args.num_items, 1), np.float32),  # no ACE for externals
            np.zeros(1, np.int64),
        )

    runner = NeuralBaselineRunner(
        model, cfg, schema, args.num_items, create_metrics,
        eval_negative_samples=neg_samples,
    )

    def hour_source(h):
        return read_sessions_tfrecord(files[h], schema)

    rows = runner.run(
        hour_source, hours=range(len(files)),
        training_hours_for_each_eval=args.training_hours_for_each_eval,
    )
    save_eval_benchmark_metrics_csv(
        rows, args.output_csv, args.training_hours_for_each_eval
    )
    print(f"Wrote {len(rows)} eval rows to {args.output_csv}")
    return rows


def main(argv=None):
    run_from_args(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()

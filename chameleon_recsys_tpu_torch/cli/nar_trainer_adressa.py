"""NAR temporal training CLI for Adressa.

The port's copy of ``chameleon_recsys_tpu/cli/nar_trainer_adressa.py``
(twin of the reference nar_module/nar/nar_trainer_adressa.py), with the
same flags and defaults.  The skeleton is ``nar_trainer_gcom``'s; the
differences are the feature schema (category0/category1/author article
features; city/region/country/device/os/referrer_class session features),
cardinalities taken from the preprocessing and ACR encoder pickles, and the
Adressa defaults (batch 64, lr 3e-4, L2 1e-4, temp 0.2, rnn 10x1, 7
negatives, top-5: scripts/run_nar_train_adressa_local.sh:9-40).

``--platform`` picks the device, and ``--data_parallelism`` /
``--model_parallelism`` the mesh, as ``nar_trainer_gcom``'s do;
``--dropout_keep_prob`` < 1 trains on the dense path with dropout.  Where
the JAX model would read an id past its table (a NaN row from Flax's
``Embed``), this CLI stops on the host with the feature, the id and the
table's size: every metadata column is checked when the schema is built,
every hour's context ids when the hour is read.

Usage (mirrors run_nar_train_adressa_local.sh):
  python -m chameleon_recsys_tpu_torch.cli.nar_trainer_adressa \
    --train_set_path_regex "sessions_tfrecords/sessions_hour_*.tfrecord.gz" \
    --acr_module_resources_path acr_articles_metadata_embeddings.pickle \
    --nar_module_preprocessing_resources_path nar_preprocessing_resources.pickle \
    --model_dir /tmp/nar_adressa
"""
from __future__ import annotations

import argparse
import glob
import logging
import pickle

import numpy as np

from ..config import (
    ADRESSA_ARTICLE_FEATURE_GROUPS,
    ADRESSA_SESSION_FEATURE_GROUPS,
    NARConfig,
    RunConfig,
    filter_article_schema,
    filter_session_schema,
)
from ..data.sessions import read_sessions_tfrecord
from ..train.temporal import TemporalHarness
from .nar_preprocess_adressa import adressa_article_schema, adressa_session_schema
from .nar_trainer_gcom import (
    default_benchmarks,
    mesh_from_args,
    parse_internal_features,
    select_device,
)

RANDOM_SEED = 42


def create_args_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--train_set_path_regex", required=True)
    p.add_argument("--acr_module_resources_path", required=True,
                   help="(label_encoders, metadata, ace_matrix) pickle")
    p.add_argument("--nar_module_preprocessing_resources_path", required=True)
    p.add_argument("--model_dir", default="/tmp/chameleon_tpu_nar_adressa")
    p.add_argument("--training_hours_for_each_eval", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--truncate_session_length", type=int, default=20)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--dropout_keep_prob", type=float, default=1.0)
    p.add_argument("--reg_l2_rate", type=float, default=1e-4)
    p.add_argument("--softmax_temperature", type=float, default=0.2)
    p.add_argument("--CAR_embedding_size", type=int, default=1024)
    p.add_argument("--rnn_units", type=int, default=10)
    p.add_argument("--rnn_num_layers", type=int, default=1)
    p.add_argument("--train_total_negative_samples", type=int, default=7)
    p.add_argument("--train_negative_samples_from_buffer", type=int, default=3000)
    p.add_argument("--eval_total_negative_samples", type=int, default=7)
    p.add_argument("--eval_negative_samples_from_buffer", type=int, default=3000)
    p.add_argument("--eval_metrics_top_n", type=int, default=5)
    p.add_argument("--recent_clicks_buffer_hours", type=float, default=1.0)
    p.add_argument("--recent_clicks_buffer_max_size", type=int, default=20000)
    p.add_argument("--recent_clicks_for_normalization", type=int, default=2000)
    p.add_argument("--content_embedding_scale_factor", type=float, default=6.0)
    p.add_argument("--eval_negative_sample_relevance", type=float, default=0.1,
                   help="relevance weight of negative samples in ESI-RR/"
                        "EILD-RR (reference Adressa config: 0.1)")
    p.add_argument("--enabled_internal_features", default="ALL")
    p.add_argument("--enabled_clicks_input_features_groups", default="ALL",
                   help="comma list of time,device,location,referrer,"
                        "engagement, or ALL/NONE")
    p.add_argument("--enabled_articles_input_features_groups", default="ALL",
                   help="comma list of category,author, or ALL/NONE")
    p.add_argument("--disable_eval_benchmarks", action="store_true")
    p.add_argument("--eval_cold_start", action="store_true")
    p.add_argument("--save_eval_sessions_negative_samples", action="store_true")
    p.add_argument("--save_eval_sessions_recommendations", action="store_true")
    p.add_argument("--resume_checkpoint", default="")
    p.add_argument("--save_scalars", action="store_true",
                   help="write per-step train scalars to train_scalars.jsonl")
    p.add_argument("--save_histograms", action="store_true",
                   help="write per-hour parameter histograms to "
                        "train_histograms.jsonl (makes the job slower)")
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--train_valid_row_capacity", type=int, default=0,
                   help="valid-row compaction capacity for the train step "
                   "(multiple of 8, >= your data's max per-batch valid "
                   "clicks; 0 = off). See NARConfig.train_valid_row_capacity.")
    p.add_argument("--platform", default="", choices=("", "cuda", "gpu", "cpu"),
                   help="the device: empty, cuda or gpu = the card, cpu = the CPU")
    # multi-device: a (data x model) mesh of one process per device, as
    # nar_trainer_gcom's; 0 = one device
    p.add_argument("--data_parallelism", type=int, default=0)
    p.add_argument("--model_parallelism", type=int, default=1)
    return p


def parse_args(argv=None):
    return create_args_parser().parse_args(argv)


def _check_fits(name, values, cardinality, where):
    values = np.asarray(values)
    if values.size and (values.min() < 0 or values.max() >= cardinality):
        bad = values[(values < 0) | (values >= cardinality)]
        raise SystemExit(
            f"{where}: {name} id {int(bad[0])} is outside its table of "
            f"{cardinality} rows ({bad.size} such ids); the cardinalities come "
            "from the NAR preprocessing and ACR label-encoder pickles")


def check_metadata_fits(metadata, article_schema):
    """Every categorical article metadata column within its table."""
    for spec in article_schema.metadata_features():
        if spec.kind == "categorical":
            _check_fits(spec.name, metadata[spec.name], spec.cardinality,
                        "article metadata")


def check_sessions_fit(sessions, session_schema, where):
    """Every clicked item and categorical context id of ``sessions`` within
    its table."""
    for spec in session_schema.context_sequence_features():
        if spec.kind == "categorical":
            _check_fits(spec.name, [v for s in sessions
                                    for v in s.context.get(spec.name, ())],
                        spec.cardinality, where)
    items = next(f for f in session_schema.sequence if f.name == "item_clicked")
    _check_fits("item_clicked", [i for s in sessions for i in s.item_ids],
                items.cardinality, where)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    device = select_device(args.platform)
    with mesh_from_args(args.data_parallelism, args.model_parallelism,
                        device) as mesh_plan:
        run(args, device, mesh_plan)


def run(args, device, mesh_plan):
    with open(args.acr_module_resources_path, "rb") as f:
        acr_label_encoders, metadata_raw, ace = pickle.load(f)
    norms = np.linalg.norm(ace, axis=1, keepdims=True)
    ace = np.divide(ace, norms, out=np.zeros_like(ace), where=norms > 0)
    ace = (ace * args.content_embedding_scale_factor).astype(np.float32)

    with open(args.nar_module_preprocessing_resources_path, "rb") as f:
        resources = pickle.load(f)
    cardinalities = dict(resources.get("cardinalities", {}))
    num_items = max(int(cardinalities.get("item_clicked", 0)), ace.shape[0])
    if ace.shape[0] < num_items:  # items clicked but unseen by ACR -> zero rows
        ace = np.vstack(
            [ace, np.zeros((num_items - ace.shape[0], ace.shape[1]), np.float32)]
        )

    # Article-feature cardinalities come from the ACR label encoders (the
    # reference loads the same pickle for them, nar_trainer_adressa.py
    # :453-470): the NAR preprocessing resources only cover context
    # features.
    if isinstance(acr_label_encoders, dict):
        for name, enc in acr_label_encoders.items():
            try:
                cardinalities.setdefault(name, len(enc))
            except TypeError:
                pass
    article_schema = filter_article_schema(
        adressa_article_schema(num_items=num_items, cardinalities=cardinalities),
        args.enabled_articles_input_features_groups,
        groups_map=ADRESSA_ARTICLE_FEATURE_GROUPS,
    )
    session_schema = filter_session_schema(
        adressa_session_schema(cardinalities),
        args.enabled_clicks_input_features_groups,
        groups_map=ADRESSA_SESSION_FEATURE_GROUPS,
    )

    metadata = {}
    for spec in article_schema.features:
        if spec.name == "article_id":
            continue
        col = np.zeros(num_items, np.int64)
        src = metadata_raw.get(spec.name) if isinstance(metadata_raw, dict) else None
        if src is not None:
            src = np.asarray(src)
            if spec.name == "created_at_ts":
                src = src // 1000  # the pickle stores unix ms; the model seconds
            col[: min(len(src), num_items)] = src[:num_items]
        metadata[spec.name] = col
    check_metadata_fits(metadata, article_schema)

    cfg = NARConfig(
        car_embedding_size=args.CAR_embedding_size,
        rnn_units=args.rnn_units,
        rnn_num_layers=args.rnn_num_layers,
        learning_rate=args.learning_rate,
        keep_prob=args.dropout_keep_prob,
        reg_weight_decay=args.reg_l2_rate,
        softmax_temperature=args.softmax_temperature,
        negative_samples=args.train_total_negative_samples,
        negative_sample_from_buffer=args.train_negative_samples_from_buffer,
        eval_negative_samples=args.eval_total_negative_samples,
        eval_negative_sample_from_buffer=args.eval_negative_samples_from_buffer,
        recent_clicks_buffer_hours=args.recent_clicks_buffer_hours,
        recent_clicks_buffer_max_size=args.recent_clicks_buffer_max_size,
        recent_clicks_for_normalization=args.recent_clicks_for_normalization,
        batch_size=args.batch_size,
        max_session_length=args.truncate_session_length,
        metrics_top_n=args.eval_metrics_top_n,
        eval_negative_sample_relevance=args.eval_negative_sample_relevance,
        internal_features=parse_internal_features(args.enabled_internal_features),
        compute_dtype=args.compute_dtype,
        train_valid_row_capacity=(
            args.train_valid_row_capacity
            if args.train_valid_row_capacity > 0 else None
        ),
        # one compaction group per data rank, as the JAX CLI sets it
        train_compaction_groups=max(args.data_parallelism, 1),
    )
    run_cfg = RunConfig(
        model_dir=args.model_dir,
        training_hours_for_each_eval=args.training_hours_for_each_eval,
        random_seed=RANDOM_SEED,
    )

    files = sorted(glob.glob(args.train_set_path_regex))
    if not files:
        raise SystemExit(f"no session files match {args.train_set_path_regex}")

    harness = TemporalHarness(
        cfg, run_cfg, session_schema, article_schema, ace, metadata,
        benchmarks=() if args.disable_eval_benchmarks else default_benchmarks(ace),
        log_negative_samples=args.save_eval_sessions_negative_samples,
        log_recommendations=args.save_eval_sessions_recommendations,
        eval_cold_start=args.eval_cold_start,
        save_scalars=args.save_scalars,
        save_histograms=args.save_histograms,
        mesh_plan=mesh_plan,
        device=device,
    )
    if args.resume_checkpoint:
        harness.load_checkpoint(args.resume_checkpoint)

    def hour_source(hour_idx):
        sessions = read_sessions_tfrecord(files[hour_idx], session_schema)
        check_sessions_fit(sessions, session_schema, files[hour_idx])
        return sessions

    harness.run(hour_source, hours=range(len(files)))
    harness.export_artifacts()
    harness.save_checkpoint()
    print(f"Done. Artifacts in {args.model_dir}")


if __name__ == "__main__":
    main()

"""NAR temporal training CLI for G1/Globo.com.

The port's copy of ``chameleon_recsys_tpu/cli/nar_trainer_gcom.py``, twin of
the reference's primary entry point (nar_module/nar/nar_trainer_gcom.py:
37-591): ~40 flags driving the streaming temporal protocol over per-hour
session TFRecords, with the ACR handoff pickle providing frozen ACEs.  The
flags, their names and defaults are the JAX CLI's.

``--platform`` picks the device: empty, ``cuda`` or ``gpu`` the card,
``cpu`` the CPU.  Without a card and without ``--platform cpu`` the CLI
exits with an error; it never carries on on the CPU.  The flags of features
not ported yet (``--data_parallelism``, ``--model_parallelism`` > 1) exit
at parse time, before any file is read, naming the slice they wait for.
``--dropout_keep_prob`` < 1 trains on the dense path with dropout, as the
JAX model does.  ``--use_native_loader`` reads and collates each hour's
file with the C++ loader (``native/chio.cc``, built with ``g++`` at first
use); where it cannot be built the CLI exits, as the JAX CLI does.

Usage (mirrors run_nar_train_gcom_local.sh):
  python -m chameleon_recsys_tpu_torch.cli.nar_trainer_gcom \
    --train_set_path_regex "sessions_tfrecords/sessions_hour_*.tfrecord.gz" \
    --acr_module_articles_metadata_csv_path articles_metadata.csv \
    --acr_module_articles_content_embeddings_pickle_path articles_embeddings.pickle \
    --model_dir /tmp/nar_model --train_total_negative_samples 50 ...
"""
from __future__ import annotations

import argparse
import csv
import glob
import logging
import pickle
from pathlib import Path

import numpy as np
import torch

from ..baselines import (
    ContentBasedRecommender,
    ItemCooccurrenceRecommender,
    ItemKNNRecommender,
    RecentlyPopularRecommender,
    SequentialRulesRecommender,
    SessionBasedKNNRecommender,
)
from ..config import (
    InternalFeaturesConfig,
    NARConfig,
    RunConfig,
    TIME_UNIT_MS,
    filter_article_schema,
    filter_session_schema,
    gcom_article_schema,
    gcom_session_schema,
)
from ..data.sessions import read_sessions_tfrecord
from ..train.temporal import BenchmarkSpec, TemporalHarness

RANDOM_SEED = 42


def create_args_parser():
    p = argparse.ArgumentParser()
    # paths
    p.add_argument("--train_set_path_regex", required=True)
    p.add_argument("--acr_module_articles_metadata_csv_path", required=True)
    p.add_argument("--acr_module_articles_content_embeddings_pickle_path", required=True)
    p.add_argument("--model_dir", default="/tmp/chameleon_tpu_nar")
    # temporal protocol
    p.add_argument("--train_files_from", type=int, default=0)
    p.add_argument("--train_files_up_to", type=int, default=0)
    p.add_argument("--training_hours_for_each_eval", type=int, default=5)
    p.add_argument("--save_results_each_n_evals", type=int, default=1)
    # model hparams (defaults = G1 reproduction config, README.md:264-306)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--truncate_session_length", type=int, default=20)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--dropout_keep_prob", type=float, default=1.0)
    p.add_argument("--reg_l2_rate", type=float, default=1e-5)
    p.add_argument("--softmax_temperature", type=float, default=0.1)
    p.add_argument("--CAR_embedding_size", type=int, default=1024)
    p.add_argument("--rnn_units", type=int, default=255)
    p.add_argument("--rnn_num_layers", type=int, default=2)
    p.add_argument("--train_total_negative_samples", type=int, default=50)
    p.add_argument("--train_negative_samples_from_buffer", type=int, default=3000)
    p.add_argument("--eval_total_negative_samples", type=int, default=50)
    p.add_argument("--eval_negative_samples_from_buffer", type=int, default=5000)
    p.add_argument("--eval_metrics_top_n", type=int, default=10)
    p.add_argument("--recent_clicks_buffer_hours", type=float, default=1.0)
    p.add_argument("--recent_clicks_buffer_max_size", type=int, default=20000)
    p.add_argument("--recent_clicks_for_normalization", type=int, default=5000)
    p.add_argument("--content_embedding_scale_factor", type=float, default=6.0)
    p.add_argument("--novelty_reg_factor", type=float, default=0.0)
    p.add_argument("--eval_negative_sample_relevance", type=float, default=0.02)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--train_valid_row_capacity", type=int, default=0,
                   help="valid-row compaction capacity for the train step "
                   "(multiple of 8, >= your data's max per-batch valid "
                   "clicks; 0 = off). See NARConfig.train_valid_row_capacity.")
    # feature toggles (reference enabled_*_features flags)
    p.add_argument("--enabled_internal_features", default="ALL",
                   help="comma list of recency,novelty,article_content_embeddings,"
                        "item_clicked_embeddings, or ALL/NONE")
    p.add_argument("--enabled_clicks_input_features_groups", default="ALL",
                   help="comma list of time,device,location,referrer, or ALL/NONE")
    p.add_argument("--enabled_articles_input_features_groups", default="ALL",
                   help="comma list of category, or ALL/NONE")
    p.add_argument("--disable_eval_benchmarks", action="store_true")
    p.add_argument("--eval_metrics_by_session_position", action="store_true")
    p.add_argument("--eval_cold_start", action="store_true")
    p.add_argument("--save_eval_sessions_negative_samples", action="store_true")
    p.add_argument("--save_eval_sessions_recommendations", action="store_true")
    # per-step observability channel (reference TensorBoard scalars +
    # --save_histograms, nar_trainer_gcom.py:54): JSONL under model_dir
    p.add_argument("--save_scalars", action="store_true",
                   help="write per-step train scalars to train_scalars.jsonl")
    p.add_argument("--save_histograms", action="store_true",
                   help="write per-hour parameter histograms to "
                        "train_histograms.jsonl (makes the job slower)")
    p.add_argument("--resume_checkpoint", default="")
    # multi-device (data x model) mesh: not ported yet, the multi-GPU slice;
    # 0 and 1 = one device
    p.add_argument("--data_parallelism", type=int, default=0)
    p.add_argument("--model_parallelism", type=int, default=1)
    # thread pool for the per-batch classical-baseline tier (-1 = auto: one
    # thread per baseline capped at cpu_count; 0/1 = serial); outputs are
    # bit-identical either way
    p.add_argument("--benchmark_workers", type=int, default=-1)
    # remote artifact sync (reference GCS workflow shape without the cloud
    # SDK: nar_trainer_gcom.py:79-80, 450-459, 527-556): a store root dir +
    # a path under it.  --warmup_model_dir downloads a previous run's
    # checkpoint into model_dir before training; --sync_artifacts_to uploads
    # model_dir on every export.
    p.add_argument("--artifact_store_root", default="")
    p.add_argument("--warmup_model_dir", default="",
                   help="store path of a previous run to warm-start from")
    p.add_argument("--sync_artifacts_to", default="",
                   help="store path to upload model_dir artifacts to")
    p.add_argument("--platform", default="", choices=("", "cuda", "gpu", "cpu"),
                   help="the device: empty, cuda or gpu = the card, cpu = the CPU")
    p.add_argument("--use_native_loader", action="store_true",
                   help="parse/collate session TFRecords with the C++ "
                        "libchio loader instead of the Python path")
    return p


# flag -> (is it set to a feature not ported yet, the slice it waits for)
_NOT_PORTED = {
    "--data_parallelism": (lambda a: a.data_parallelism != 0, "multi-GPU"),
    "--model_parallelism": (lambda a: a.model_parallelism > 1, "multi-GPU"),
}


def refuse_not_ported(parser, not_ported, argv=None):
    """``parser``'s flags; exits (status 2) on a flag set to a feature that
    is not ported yet (``not_ported``: flag -> (test, the slice it waits
    for)), before anything is read."""
    args = parser.parse_args(argv)
    for flag, (is_set, slice_name) in not_ported.items():
        if is_set(args):
            parser.error(f"{flag} is not ported yet: it comes with the "
                         f"{slice_name} slice")
    return args


def parse_args(argv=None):
    """The parsed flags; exits (status 2) on a flag set to a feature that is
    not ported yet, before anything is read."""
    return refuse_not_ported(create_args_parser(), _NOT_PORTED, argv)


def select_device(platform: str) -> torch.device:
    """``--platform`` -> the device; exits when the card is asked for (the
    default) and there is none."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --platform cpu to run on the CPU")
    return torch.device("cuda")


def parse_internal_features(flag_value: str) -> InternalFeaturesConfig:
    all_features = (
        "recency", "novelty", "article_content_embeddings",
        "item_clicked_embeddings",
    )
    if flag_value == "ALL":
        enabled = set(all_features)
    elif flag_value == "NONE":
        enabled = set()
    else:
        enabled = set(x.strip() for x in flag_value.split(","))
    return InternalFeaturesConfig(**{f: f in enabled for f in all_features})


def load_acr_module_resources(metadata_csv_path, embeddings_pickle_path,
                              scale_factor: float):
    """ACE pickle + metadata CSV, L2-normalized and scaled
    (reference nar_trainer_gcom.py:461-474)."""
    with open(embeddings_pickle_path, "rb") as f:
        ace = pickle.load(f)
    norms = np.linalg.norm(ace, axis=1, keepdims=True)
    ace = np.divide(ace, norms, out=np.zeros_like(ace), where=norms > 0)
    ace = (ace * scale_factor).astype(np.float32)

    with open(metadata_csv_path) as f:
        rows = list(csv.DictReader(f))
    num_items = ace.shape[0]
    created = np.zeros(num_items, np.int64)
    category = np.zeros(num_items, np.int64)
    for r in rows:
        i = int(r["article_id"])
        if i < num_items:
            created[i] = int(r["created_at_ts"]) // TIME_UNIT_MS
            category[i] = int(r["category_id"])
    return ace, {"created_at_ts": created, "category_id": category}


def default_benchmarks(ace_matrix):
    """G1 benchmark set and parameters (nar_trainer_gcom.py:280-302)."""
    return [
        BenchmarkSpec(RecentlyPopularRecommender, {}),
        BenchmarkSpec(ItemCooccurrenceRecommender, {}),
        BenchmarkSpec(ItemKNNRecommender, {"reg_lambda": 20, "alpha": 0.75}),
        BenchmarkSpec(
            SessionBasedKNNRecommender,
            {
                "sessions_buffer_size": 3000,
                "candidate_sessions_sample_size": 1000,
                "sampling_strategy": "recent",
                "nearest_neighbor_session_for_scoring": 500,
                "similarity": "cosine",
                "first_session_clicks_decay": "div",
            },
        ),
        BenchmarkSpec(
            ContentBasedRecommender,
            {"content_article_embeddings_matrix": ace_matrix},
        ),
        BenchmarkSpec(
            SequentialRulesRecommender,
            {"max_clicks_dist": 10, "dist_between_clicks_decay": "div"},
        ),
    ]


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    device = select_device(args.platform)

    ace, metadata = load_acr_module_resources(
        args.acr_module_articles_metadata_csv_path,
        args.acr_module_articles_content_embeddings_pickle_path,
        args.content_embedding_scale_factor,
    )
    num_items = ace.shape[0]
    article_schema = filter_article_schema(
        gcom_article_schema(num_items=num_items),
        args.enabled_articles_input_features_groups,
    )
    session_schema = filter_session_schema(
        gcom_session_schema(num_items=num_items),
        args.enabled_clicks_input_features_groups,
    )

    cfg = NARConfig(
        car_embedding_size=args.CAR_embedding_size,
        rnn_units=args.rnn_units,
        rnn_num_layers=args.rnn_num_layers,
        learning_rate=args.learning_rate,
        keep_prob=args.dropout_keep_prob,
        reg_weight_decay=args.reg_l2_rate,
        softmax_temperature=args.softmax_temperature,
        novelty_reg_factor=args.novelty_reg_factor,
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
    )
    run_cfg = RunConfig(
        model_dir=args.model_dir,
        training_hours_for_each_eval=args.training_hours_for_each_eval,
        train_files_from=args.train_files_from,
        train_files_up_to=args.train_files_up_to,
        save_results_each_n_evals=args.save_results_each_n_evals,
        random_seed=RANDOM_SEED,
    )

    files = sorted(glob.glob(args.train_set_path_regex))
    up_to = args.train_files_up_to or len(files)
    files = files[args.train_files_from : up_to]
    if not files:
        raise SystemExit(f"no session files match {args.train_set_path_regex}")

    store = None
    if args.artifact_store_root:
        # gs://bucket/prefix selects the GCS backend; a plain path the
        # local-filesystem one (utils/artifact_store.py::open_artifact_store)
        from ..utils.artifact_store import open_artifact_store

        store = open_artifact_store(args.artifact_store_root)

    harness = TemporalHarness(
        cfg,
        run_cfg,
        session_schema,
        article_schema,
        ace,
        metadata,
        benchmarks=() if args.disable_eval_benchmarks else default_benchmarks(ace),
        log_negative_samples=args.save_eval_sessions_negative_samples,
        log_recommendations=args.save_eval_sessions_recommendations,
        eval_metrics_by_session_position=args.eval_metrics_by_session_position,
        eval_cold_start=args.eval_cold_start,
        artifact_store=store if args.sync_artifacts_to else None,
        artifact_remote_path=args.sync_artifacts_to,
        benchmark_workers=(
            None if args.benchmark_workers < 0 else args.benchmark_workers
        ),
        save_scalars=args.save_scalars,
        save_histograms=args.save_histograms,
        device=device,
    )
    resume_ckpt = args.resume_checkpoint
    if store is not None and args.warmup_model_dir and not resume_ckpt:
        from ..utils.artifact_store import warm_start_model_dir

        fetched = warm_start_model_dir(store, args.warmup_model_dir, args.model_dir)
        ckpt = Path(args.model_dir) / "checkpoint.pkl"
        if fetched and ckpt.exists():
            resume_ckpt = str(ckpt)
    if resume_ckpt:
        harness.load_checkpoint(resume_ckpt)

    if args.use_native_loader:
        from ..native import NativeSessionLoader, native_available
        from ..native.loader import build_error

        if not native_available():
            raise SystemExit(f"native loader unavailable (g++/zlib missing): "
                             f"{build_error()}")

        def hour_source(hour_idx):
            return NativeSessionLoader(files[hour_idx], session_schema)

    else:

        def hour_source(hour_idx):
            return read_sessions_tfrecord(files[hour_idx], session_schema)

    harness.run(hour_source, hours=range(len(files)))
    harness.export_artifacts()
    harness.save_checkpoint()
    print(f"Done. Artifacts in {args.model_dir}")


if __name__ == "__main__":
    main()

"""End-to-end quality experiment on a learnable synthetic stream.

The port of ``examples/train_nar_synthetic.py``: runs the full temporal
protocol on synthetic sessions a model can learn from (``--stream markov``:
next clicks follow a sparse transition graph; ``contextual``: transitions
conditioned on the device; ``churn``: a churning catalog whose ACEs carry
the category) and prints per-eval-hour HR/MRR for CHAMELEON and the
classical baselines, then exports the artifacts.  The flags and defaults
are the JAX example's, but for ``--platform``: the card (``cuda``, the
default) unless ``--platform cpu`` is given, with no fallback.
``--approx_topk`` is accepted; the port's negative sampler always takes the
exact top-k.

  python -m chameleon_recsys_tpu_torch.cli.train_nar_synthetic --platform cpu --hours 6

``build`` makes the example's harness and hour source, so that tests and
the chip smoke run drive its exact configuration (``cfg_overrides``: fields
of ``NARConfig`` set over the example's, such as ``use_pallas_rnn`` and
``use_pallas_scorer``).
"""
from __future__ import annotations

import argparse
import logging
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

from ..baselines import (
    ContentBasedRecommender,
    ItemCooccurrenceRecommender,
    RecentlyPopularRecommender,
    SequentialRulesRecommender,
)
from ..config import (
    ArticleFeaturesSchema,
    FeatureSpec,
    NARConfig,
    RunConfig,
    SessionFeaturesSchema,
)
from ..data.collate import Session
from ..data.synthetic import (
    make_churn_corpus,
    make_synthetic_corpus,
    make_transition_graph,
    synthetic_churn_hour_sessions,
    synthetic_contextual_hour_sessions,
    synthetic_markov_hour_sessions,
)
from ..train.temporal import BenchmarkSpec, TemporalHarness
from .nar_trainer_gcom import select_device


def create_args_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--hours", type=int, default=6)
    parser.add_argument("--sessions_per_hour", type=int, default=128)
    parser.add_argument("--num_items", type=int, default=2000)
    parser.add_argument("--eval_every", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--rnn_units", type=int, default=64)
    parser.add_argument("--car_size", type=int, default=128)
    parser.add_argument("--negatives", type=int, default=20)
    parser.add_argument("--top_n", type=int, default=10)
    parser.add_argument("--platform", default="cuda", choices=("cuda", "gpu", "cpu"),
                        help="the device: cuda or gpu = the card, cpu = the CPU")
    parser.add_argument("--approx_topk", action="store_true",
                        help="accepted for the JAX example's command lines; the "
                        "port's negative sampler always takes the exact top-k")
    parser.add_argument("--stream", default="markov",
                        choices=["markov", "contextual", "churn"],
                        help="markov: item->item transitions; contextual: "
                             "(item, device)->item transitions that counting "
                             "baselines cannot separate; churn: news-like "
                             "article churn + category-correlated ACEs — "
                             "the item cold-start regime where content/"
                             "recency generalization beats counting")
    parser.add_argument("--item_lifetime_hours", type=float, default=4.0)
    parser.add_argument("--category_signal", type=float, default=0.8)
    return parser


def build(args, device, cfg_overrides: Optional[dict] = None
          ) -> Tuple[TemporalHarness, Callable[[int], List[Session]]]:
    """The example's harness on ``device`` (its model directory a new
    temporary one) and its hour source, from parsed ``args``."""
    num_items = args.num_items
    art = ArticleFeaturesSchema(
        features=(
            FeatureSpec("article_id", "categorical", num_items),
            FeatureSpec("created_at_ts", "numerical", dtype="int"),
            FeatureSpec("category_id", "categorical", 20),
        )
    )
    sess = SessionFeaturesSchema(
        single=(
            FeatureSpec("user_id", "categorical", 100000),
            FeatureSpec("session_id", "numerical", dtype="int"),
            FeatureSpec("session_start", "numerical", dtype="int"),
            FeatureSpec("session_size", "numerical", dtype="int"),
        ),
        sequence=(
            FeatureSpec("event_timestamp", "numerical", dtype="int"),
            FeatureSpec("item_clicked", "categorical", num_items),
            FeatureSpec("device", "categorical", 5),
            FeatureSpec("hour_sin", "numerical", dtype="float"),
        ),
    )
    cfg = NARConfig(**{
        **dict(
            car_embedding_size=args.car_size,
            rnn_units=args.rnn_units,
            rnn_num_layers=2,
            matching_layer_sizes=(128, 64, 32),
            learning_rate=1e-3,
            negative_samples=args.negatives,
            negative_sample_from_buffer=500,
            eval_negative_samples=args.negatives,
            eval_negative_sample_from_buffer=500,
            recent_clicks_buffer_max_size=5000,
            recent_clicks_for_normalization=1000,
            batch_size=args.batch_size,
            max_session_length=12,
            metrics_top_n=args.top_n,
            approx_negative_topk=args.approx_topk,
        ),
        **(cfg_overrides or {}),
    })
    if args.stream == "churn":
        corpus = make_churn_corpus(
            art, ace_dim=64, stream_hours=args.hours,
            item_lifetime_hours=args.item_lifetime_hours,
            category_signal=args.category_signal,
        )
    else:
        corpus = make_synthetic_corpus(art, ace_dim=64)
    graph = make_transition_graph(num_items)
    run_cfg = RunConfig(
        model_dir=tempfile.mkdtemp(prefix="chameleon_demo_"),
        training_hours_for_each_eval=args.eval_every,
    )
    benchmarks = [
        BenchmarkSpec(RecentlyPopularRecommender, {}),
        BenchmarkSpec(ItemCooccurrenceRecommender, {}),
        BenchmarkSpec(
            SequentialRulesRecommender,
            {"max_clicks_dist": 10, "dist_between_clicks_decay": "div"},
        ),
    ]
    if args.stream == "churn":
        benchmarks.append(BenchmarkSpec(
            ContentBasedRecommender,
            {"content_article_embeddings_matrix": corpus.ace_matrix},
        ))
    harness = TemporalHarness(
        cfg, run_cfg, sess, art, corpus.ace_matrix, corpus.metadata,
        benchmarks=benchmarks, device=device,
    )

    def hour_source(h):
        if args.stream == "contextual":
            return synthetic_contextual_hour_sessions(
                corpus, sess, h, args.sessions_per_hour,
                successors_per_context=5,
                max_session_length=cfg.max_session_length,
            )
        if args.stream == "churn":
            return synthetic_churn_hour_sessions(
                corpus, sess, h, args.sessions_per_hour,
                item_lifetime_hours=args.item_lifetime_hours,
                max_session_length=cfg.max_session_length,
            )
        return synthetic_markov_hour_sessions(
            corpus, sess, graph, h, args.sessions_per_hour,
            cfg.max_session_length,
        )

    return harness, hour_source


def format_row(i: int, row: dict) -> str:
    """One line of the per-eval-hour table, as the JAX example prints it."""
    line = (
        f"eval {i}: chameleon {row['hitrate_at_n_chameleon']:.4f}/"
        f"{row['mrr_at_n_chameleon']:.4f} | pop "
        f"{row.get('hitrate_at_n_pop_recent', float('nan')):.4f} | cooc "
        f"{row.get('hitrate_at_n_coocurrent', float('nan')):.4f} | sr "
        f"{row.get('hitrate_at_n_sr', float('nan')):.4f}"
    )
    if "hitrate_at_n_cb" in row:
        line += f" | cb {row['hitrate_at_n_cb']:.4f}"
    return line + f" | {row.get('train_sessions_per_s', 0):.0f} sess/s"


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = create_args_parser().parse_args(argv)
    device = select_device(args.platform)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    harness, hour_source = build(args, device)
    rows = harness.run(hour_source, hours=range(args.hours))
    print(f"\n=== per-eval-hour accuracy (HR@{args.top_n} / MRR@{args.top_n}) ===")
    for i, row in enumerate(rows):
        print(format_row(i, row))
    harness.export_artifacts()
    print("artifacts:", harness.run_cfg.model_dir)
    return rows


if __name__ == "__main__":
    main()

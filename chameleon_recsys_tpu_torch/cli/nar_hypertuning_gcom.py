"""Hyperparameter sweep CLI for the G1 NAR model.

The port's copy of ``chameleon_recsys_tpu/cli/nar_hypertuning_gcom.py``:
replaces the reference's ML Engine hypertuning job
(nar_module/nar_mlengine_hypertuning.yaml:1-51: goal MAXIMIZE ``mrr_at_n``,
30 trials over discrete grids of batch size, negatives, CAR width, RNN
units, learning rate, dropout and L2) with a local sweep over the same
grids (``train/sweep.py``).  It takes the flags of the port's
``nar_trainer_gcom`` plus ``--max_trials``, ``--param_grid``,
``--sweep_spec``, ``--objective`` and ``--max_parallel``; each trial runs
the temporal harness on one device on the session files without the
classical baselines, in ``model_dir/trial_NNN``.  As in the JAX CLI,
``--use_native_loader``, ``--data_parallelism`` and ``--model_parallelism``
are accepted and ignored: the trials read through the Python reader, on no
mesh.
``--train_valid_row_capacity`` reaches the trials' config (the JAX CLI
drops it).

``--platform`` picks the device as ``nar_trainer_gcom``'s does: the card,
or ``cpu`` when asked; without a card it exits.

  python -m chameleon_recsys_tpu_torch.cli.nar_hypertuning_gcom \
    --train_set_path_regex "sessions/sessions_hour_*.tfrecord.gz" \
    --acr_module_articles_metadata_csv_path articles_metadata.csv \
    --acr_module_articles_content_embeddings_pickle_path articles_embeddings.pickle \
    --model_dir /tmp/nar_sweep --max_trials 30 \
    --param_grid '{"learning_rate": [1e-4, 3e-4], "rnn_units": [128, 255]}'
"""
from __future__ import annotations

import glob
import json
import logging

from ..config import (
    NARConfig,
    RunConfig,
    filter_article_schema,
    filter_session_schema,
    gcom_article_schema,
    gcom_session_schema,
)
from ..data.sessions import read_sessions_tfrecord
from ..train.sweep import load_sweep_spec, run_sweep
from ..train.temporal import TemporalHarness
from .nar_trainer_gcom import (
    create_args_parser,
    load_acr_module_resources,
    parse_internal_features,
    select_device,
)

# the reference YAML's discrete grids (nar_mlengine_hypertuning.yaml:9-51)
DEFAULT_GRID = {
    "batch_size": [196, 256],
    "learning_rate": [1e-4, 3e-4],
    "reg_weight_decay": [1e-5, 1e-4],
    "negative_samples": [30, 50],
    "car_embedding_size": [512, 1024],
    "rnn_units": [128, 255],
    "softmax_temperature": [0.1, 0.2],
}


def create_sweep_parser():
    p = create_args_parser()
    p.add_argument("--max_trials", type=int, default=30)
    p.add_argument("--param_grid", default="",
                   help="JSON dict of NARConfig field -> list of values "
                        "(defaults to the reference hypertuning grids)")
    p.add_argument("--sweep_spec", default="",
                   help="path to a YAML/JSON sweep spec, in the reference's ML "
                        "Engine layout (nar_mlengine_hypertuning.yaml) or the "
                        "flat {params, objective, ...} layout; overrides "
                        "--param_grid/--max_trials/--objective")
    p.add_argument("--objective", default="mrr_at_n")
    p.add_argument("--max_parallel", type=int, default=1)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = create_sweep_parser().parse_args(argv)
    device = select_device(args.platform)

    goal = "MAXIMIZE"
    if args.sweep_spec:
        spec = load_sweep_spec(args.sweep_spec)
        param_grid = spec.param_grid
        goal = spec.goal
        if spec.objective:
            args.objective = spec.objective
        if spec.max_trials:
            args.max_trials = spec.max_trials
        if spec.max_parallel:
            args.max_parallel = spec.max_parallel
    else:
        param_grid = json.loads(args.param_grid) if args.param_grid else DEFAULT_GRID

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

    # every flag the parser takes reaches the base config: an ignored flag
    # would mislabel the sweep's results
    base_cfg = NARConfig(
        batch_size=args.batch_size,
        max_session_length=args.truncate_session_length,
        learning_rate=args.learning_rate,
        keep_prob=args.dropout_keep_prob,
        reg_weight_decay=args.reg_l2_rate,
        softmax_temperature=args.softmax_temperature,
        novelty_reg_factor=args.novelty_reg_factor,
        rnn_units=args.rnn_units,
        rnn_num_layers=args.rnn_num_layers,
        car_embedding_size=args.CAR_embedding_size,
        negative_samples=args.train_total_negative_samples,
        negative_sample_from_buffer=args.train_negative_samples_from_buffer,
        eval_negative_samples=args.eval_total_negative_samples,
        eval_negative_sample_from_buffer=args.eval_negative_samples_from_buffer,
        recent_clicks_buffer_hours=args.recent_clicks_buffer_hours,
        recent_clicks_buffer_max_size=args.recent_clicks_buffer_max_size,
        recent_clicks_for_normalization=args.recent_clicks_for_normalization,
        metrics_top_n=args.eval_metrics_top_n,
        eval_negative_sample_relevance=args.eval_negative_sample_relevance,
        internal_features=parse_internal_features(args.enabled_internal_features),
        compute_dtype=args.compute_dtype,
        train_valid_row_capacity=(
            args.train_valid_row_capacity if args.train_valid_row_capacity > 0 else None
        ),
    )
    run_cfg = RunConfig(
        model_dir=args.model_dir,
        training_hours_for_each_eval=args.training_hours_for_each_eval,
    )

    files = sorted(glob.glob(args.train_set_path_regex))
    if not files:
        raise SystemExit(f"no session files match {args.train_set_path_regex}")
    up_to = args.train_files_up_to or len(files)
    files = files[args.train_files_from: up_to]

    def harness_factory(cfg, trial_run_cfg):
        # trials score the neural model only, as the reference's do
        return TemporalHarness(cfg, trial_run_cfg, session_schema, article_schema,
                               ace, metadata, benchmarks=(), device=device)

    def hour_source(hour_idx):
        return read_sessions_tfrecord(files[hour_idx], session_schema)

    results = run_sweep(
        base_cfg, run_cfg, param_grid, harness_factory, hour_source,
        hours=range(len(files)), objective=args.objective,
        max_trials=args.max_trials, max_parallel=args.max_parallel, goal=goal,
    )
    best = results[0]
    print(f"Best trial {best.trial_id}: {args.objective}={best.objective:.5f} "
          f"with {best.overrides}")
    return results


if __name__ == "__main__":
    main()

"""Tiny versions of the cells for the CPU tests: the configuration files
cut to widths a test run holds, the traffic mixes cut to a few batches."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchkit import spec  # noqa: E402
from benchkit.common import Run  # noqa: E402

TINY_NAR = {
    "car_embedding_size": 32, "rnn_units": 8, "matching_layer_sizes": [16, 8, 4],
    "negative_samples": 5, "eval_negative_samples": 5, "negative_sample_from_buffer": 60,
    "eval_negative_sample_from_buffer": 80, "neg_sampling_multiplying_factor": 4,
    "recent_clicks_buffer_max_size": 400, "recent_clicks_for_normalization": 150,
    "batch_size": 8, "max_session_length": 6, "train_valid_row_capacity": 24,
    "compute_dtype": "float32", "use_pallas_rnn": False, "use_pallas_scorer": False,
    "metrics_top_n": 3,
}
TINY_MIX = {
    "train_hours": {"sessions_per_hour": 32, "distinct_hours": 3},
    "serve_b32": {"batch_sessions": 8, "distinct_batches": 4, "sessions_per_hour": 40,
                  "check_from_first_calls": 4, "check_calls": 2, "warmup_calls": 1,
                  "num_candidates": 12, "top_k": 3},
    "eval_hours": {"sessions_per_hour": 32, "distinct_hours": 3, "check_batches": 2,
                   "check_hour_from_first": 2},
}


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(spec.load_json(BENCH_DIR / "configs" / f"{name}.json"))
    cfg["num_items"] = 300
    cfg["ace_dim"] = 12
    for rows in (cfg["article_features"], cfg["session_sequence"]):
        for r in rows:
            if r[0] in ("article_id", "item_clicked"):
                r[2] = 300
    cfg["nar"].update(TINY_NAR)
    if cfg["nar"]["rnn_num_layers"] == 1:
        cfg["nar"]["rnn_units"] = 4
    return cfg


def tiny_traffic(name: str) -> dict:
    mix = spec.load_json(BENCH_DIR / "traffic" / f"{name}.json")
    mix.update(TINY_MIX[name])
    mix["session_length"] = dict(mix["session_length"], max=6)
    return mix


def tiny_run(workload: str, seed: int, tmpdir, seconds: float = 0.3, limits=None) -> Run:
    cell = spec.cell(workload)
    return Run(workload, seed, seconds, False, "cpu", tiny_config(cell.config["name"]),
               tiny_traffic(cell.traffic_name), dict(limits if limits is not None
                                                     else cell.limits), str(tmpdir))


SMALL_NAR = {
    "batch_size": 16, "train_valid_row_capacity": 160, "recent_clicks_buffer_max_size": 4000,
    "recent_clicks_for_normalization": 1000, "negative_sample_from_buffer": 1500,
    "eval_negative_sample_from_buffer": 2000,
}


def small_run(workload: str, seed: int, tmpdir) -> Run:
    """The cell at its configuration's widths and types (the kernels' plain
    twins on the CPU) with few articles, sessions and rows."""
    cell = spec.cell(workload)
    cfg = copy.deepcopy(cell.config)
    cfg["num_items"] = 3000
    for rows in (cfg["article_features"], cfg["session_sequence"]):
        for r in rows:
            if r[0] in ("article_id", "item_clicked"):
                r[2] = 3000
    cfg["nar"].update(SMALL_NAR)
    mix = dict(cell.traffic)
    small_mix = {"sessions_per_hour": 96, "distinct_hours": 2, "distinct_batches": 3,
                 "batch_sessions": 16, "check_from_first_calls": 3, "check_calls": 2,
                 "warmup_calls": 1, "check_batches": 2, "check_hour_from_first": 1}
    mix.update({k: v for k, v in small_mix.items() if k in mix})
    return Run(workload, seed, 0.2, False, "cpu", cfg, mix, dict(cell.limits), str(tmpdir))

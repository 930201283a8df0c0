"""Artifact IO: pickles, the per-hour metrics CSV, JSON-lines logs.

The port's copy of the writers of ``chameleon_recsys_tpu/utils/io.py``
(``serialize``, ``deserialize``, ``save_eval_benchmark_metrics_csv``,
``append_json_lines``) and of its analysis helpers (``gini_index``,
``min_max_scale``), with the same file contracts: the reference's eval
CSV with derived hour/day columns (nar_module/nar/nar_utils.py:31-40) and
its JSON-lines negative-sample / recommendation logs
(nar_trainer_gcom.py:390-407).
"""
from __future__ import annotations

import csv
import json
import pickle
from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np


def serialize(path, obj):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def deserialize(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_eval_benchmark_metrics_csv(
    eval_sessions_metrics_log: List[Dict],
    output_csv_path,
    training_hours_for_each_eval: int = 5,
):
    """One row per eval, with derived hour/day columns
    (reference nar_utils.py:31-40)."""
    if not eval_sessions_metrics_log:
        return
    rows = []
    for i, metrics in enumerate(eval_sessions_metrics_log):
        cumulative = (i + 1) * training_hours_for_each_eval
        # reference columns: hour-of-day (%24) and day index (nar_utils.py:31-40)
        row = {"eval_hour": cumulative % 24, "eval_day": cumulative // 24}
        row.update(metrics)
        rows.append(row)
    fieldnames: List[str] = []
    for row in rows:
        for key in row:
            if key not in fieldnames:
                fieldnames.append(key)
    path = Path(output_csv_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)


def gini_index(values) -> float:
    """Gini coefficient of a value distribution (reference
    nar_module/nar/utils.py:210-230; used for catalog-concentration
    analysis)."""
    values = np.sort(np.asarray(values, np.float64))
    n = len(values)
    if n == 0 or values.sum() == 0:
        return 0.0
    index = np.arange(1, n + 1)
    return float((2 * np.sum(index * values) / (n * values.sum())) - (n + 1) / n)


def min_max_scale(values, min_max_range=(0.0, 1.0)):
    """Min-max scaling helper (reference utils.py:234-237)."""
    values = np.asarray(values, np.float64)
    lo, hi = values.min(), values.max()
    span = hi - lo if hi > lo else 1.0
    scaled = (values - lo) / span
    a, b = min_max_range
    return scaled * (b - a) + a


def append_json_lines(path, records: Iterable[Dict]):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")

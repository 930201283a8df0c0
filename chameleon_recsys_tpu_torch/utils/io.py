"""Artifact IO: pickles, the per-hour metrics CSV, JSON-lines logs.

The port's copy of the writers of ``chameleon_recsys_tpu/utils/io.py``
(``serialize``, ``deserialize``, ``save_eval_benchmark_metrics_csv``,
``append_json_lines``), with the same file contracts: the reference's eval
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


def append_json_lines(path, records: Iterable[Dict]):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")

"""G1/Globo.com NAR preprocessing: hourly click CSVs -> per-hour session
TFRecords.

The port's copy of ``chameleon_recsys_tpu/cli/nar_preprocess_gcom.py``, twin
of the reference CLI (nar_module/nar/preprocessing/
nar_preprocess_gcom.py:13-137): group clicks into sessions per hourly CSV,
derive cyclical local-time features (America/Sao_Paulo), and write one
gzipped TFRecord of SequenceExamples per hour, with the same bytes as the
JAX package's CLI.  Preprocessing never touches a device: ``--platform``
takes ``cpu`` or ``cuda`` and ignores both.

Usage:
  python -m chameleon_recsys_tpu_torch.cli.nar_preprocess_gcom \
    --input_clicks_csv_path_regex "clicks/clicks_hour_*.csv" \
    --output_sessions_tfrecords_path "sessions_tfrecords/sessions_hour_*.tfrecord.gz"
"""
from __future__ import annotations

import argparse
import csv
import glob
from collections import defaultdict

from ..config import TIME_UNIT_MS, gcom_session_schema
from ..data.collate import Session
from ..data.preprocessing.time_features import local_time_features
from ..data.sessions import write_sessions_tfrecord

CONTEXT_COLUMNS = {
    "environment": "click_environment",
    "deviceGroup": "click_deviceGroup",
    "os": "click_os",
    "country": "click_country",
    "region": "click_region",
    "referrer_type": "click_referrer_type",
}


def load_sessions_from_csv(path, tz="America/Sao_Paulo"):
    """CSV clicks → Session list sorted by session start
    (reference load_sessions_by_hour, nar_preprocess_gcom.py:31-51)."""
    by_session = defaultdict(list)
    with open(path) as f:
        for row in csv.DictReader(f):
            by_session[int(row["session_id"])].append(row)

    sessions = []
    for session_id, rows in by_session.items():
        rows.sort(key=lambda r: int(r["click_timestamp"]))
        ts_ms = [int(r["click_timestamp"]) for r in rows]
        context = {name: [int(r[col]) for r in rows] for name, col in CONTEXT_COLUMNS.items()}
        hour_sin, hour_cos, weekdays = [], [], []
        for t in ts_ms:
            hs, hc, wd = local_time_features(t, tz)
            hour_sin.append(hs)
            hour_cos.append(hc)
            weekdays.append(wd)
        context["local_hour_sin"] = hour_sin
        context["local_hour_cos"] = hour_cos
        context["local_weekday"] = weekdays
        sessions.append(
            Session(
                session_id=session_id,
                user_id=int(rows[0]["user_id"]),
                session_start=int(rows[0]["session_start"]) // TIME_UNIT_MS,
                item_ids=[int(r["click_article_id"]) for r in rows],
                timestamps=[t // TIME_UNIT_MS for t in ts_ms],
                context=context,
            )
        )
    sessions.sort(key=lambda s: s.session_start)
    return sessions


def _process_hour(hour_index: int, path: str, output_pattern: str) -> int:
    """One hour file → one TFRecord (self-contained for a worker process)."""
    schema = gcom_session_schema()
    sessions = load_sessions_from_csv(path)
    out = output_pattern.replace("*", f"{hour_index:03d}")
    write_sessions_tfrecord(sessions, schema, out)
    return hour_index


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_clicks_csv_path_regex", required=True)
    parser.add_argument("--output_sessions_tfrecords_path", required=True)
    parser.add_argument("--number_hours_to_preprocess", type=int, default=-1)
    parser.add_argument(
        "--num_workers", type=int, default=1,
        help="hour files are independent (the reference distributes this "
        "step over a Dataproc/Spark cluster) — N>1 processes them on a "
        "local process pool; output files are byte-identical to serial",
    )
    parser.add_argument(
        "--platform", default="", choices=("", "cpu", "cuda", "gpu"),
        help="accepted for the trainer's flag set and ignored: preprocessing "
        "runs on the host",
    )
    args = parser.parse_args(argv)

    files = sorted(glob.glob(args.input_clicks_csv_path_regex))
    if 0 <= args.number_hours_to_preprocess < len(files):
        files = files[: args.number_hours_to_preprocess + 1]

    if args.num_workers > 1 and len(files) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, as_completed

        with ProcessPoolExecutor(
            max_workers=args.num_workers,
            mp_context=multiprocessing.get_context("spawn"),
        ) as pool:
            futures = [
                pool.submit(
                    _process_hour, i, p, args.output_sessions_tfrecords_path
                )
                for i, p in enumerate(files)
            ]
            done = 0
            for f in as_completed(futures):
                f.result()  # re-raise worker errors
                done += 1
                if done % 10 == 0:
                    print(f"Exported {done} TFRecord files")
    else:
        for hour_index, path in enumerate(files):
            _process_hour(hour_index, path, args.output_sessions_tfrecords_path)
            if hour_index % 10 == 0:
                print(f"Exported {hour_index + 1} TFRecord files")
    print("Preprocessing finalized")


if __name__ == "__main__":
    main()

"""Adressa NAR preprocessing: sessionized click stream → per-hour session
TFRecords.

Covers BOTH Adressa steps of the reference without a Spark cluster:
  * step 1 (the Dataproc sessionization notebook): 30-min-idle
    sessionization with de-dup and synthetic session ids is provided by
    ``data/preprocessing/sessionization.py`` and applied here to a JSON-lines
    click log;
  * step 2 (nar_module/nar/preprocessing/nar_preprocess_adressa.py:85-301):
    standardize numeric features with the reference's hardcoded scalers,
    derive Europe/Oslo local-time features, and export per-hour TFRecords.

The port's copy of ``chameleon_recsys_tpu/cli/nar_preprocess_adressa.py``:
the same flags, the same session TFRecords and the same resources pickle.
Preprocessing never touches a device: ``--platform`` takes ``cpu`` or
``cuda`` and ignores both.

Input: JSON lines with at least
  {"userId": str, "id": article-id-int, "time": unix-seconds,
   "city"/"region"/"country"/"deviceType"/"os"/"referrerClass": encoded ints,
   "activeTime": seconds (optional)}
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

from ..config import (
    ArticleFeaturesSchema,
    FeatureSpec,
    SessionFeaturesSchema,
    TIME_UNIT_MS,
)
from ..data.collate import Session
from ..data.preprocessing.sessionization import Click, sessionize_clicks
from ..data.preprocessing.time_features import local_time_features
from ..data.preprocessing.user_agent import (
    extract_device_group_from_user_agent,
    extract_os_from_user_agent,
)
from ..data.sessions import write_sessions_tfrecord
from ..utils.io import serialize

# Hardcoded standardization stats (reference nar_preprocess_adressa.py:93-107).
# _elapsed_ms_since_last_click / active_time_secs_by_word are kept for the
# reference's optional features (disabled there too, nar_trainer_adressa
# comments) so enabling them later reuses the same constants.
NUMERIC_SCALERS = {
    "_elapsed_ms_since_last_click": {
        "valid_max": 60 * 60 * 1000.0, "avg": 789935.7, "stddev": 1371436.0,
    },
    "active_time_secs": {"valid_max": 900.0, "avg": 65.0, "stddev": 69.37},
    "active_time_secs_by_word": {
        "valid_max": 10.0, "avg": 1.854, "stddev": 1.474,
    },
}

CONTEXT_KEYS = ("city", "region", "country", "device", "os", "referrer_class")


def standardize(feature: str, value: float) -> float:
    cfg = NUMERIC_SCALERS[feature]
    return (min(float(value), cfg["valid_max"]) - cfg["avg"]) / cfg["stddev"]


def adressa_session_schema(cardinalities=None) -> SessionFeaturesSchema:
    """Adressa session schema (nar_trainer_adressa.py:147-181); cardinalities
    come from the preprocessing encoders pickle."""
    card = cardinalities or {}

    def c(name, default):
        return int(card.get(name, default))

    return SessionFeaturesSchema(
        single=(
            FeatureSpec("user_id", "categorical", c("user_id", 1_000_000)),
            FeatureSpec("session_id", "numerical", dtype="int"),
            FeatureSpec("session_start", "numerical", dtype="int"),
            FeatureSpec("session_size", "numerical", dtype="int"),
        ),
        sequence=(
            FeatureSpec("event_timestamp", "numerical", dtype="int"),
            FeatureSpec("item_clicked", "categorical", c("item_clicked", 72933)),
            FeatureSpec("city", "categorical", c("city", 1022)),
            FeatureSpec("region", "categorical", c("region", 237)),
            FeatureSpec("country", "categorical", c("country", 70)),
            FeatureSpec("device", "categorical", c("device", 5)),
            FeatureSpec("os", "categorical", c("os", 10)),
            FeatureSpec("local_hour_sin", "numerical", dtype="float"),
            FeatureSpec("local_hour_cos", "numerical", dtype="float"),
            FeatureSpec("weekday", "numerical", dtype="float"),
            FeatureSpec("referrer_class", "categorical", c("referrer_class", 7)),
            FeatureSpec("active_time_secs", "numerical", dtype="float"),
        ),
    )


def adressa_article_schema(num_items=72933, cardinalities=None) -> ArticleFeaturesSchema:
    card = cardinalities or {}
    return ArticleFeaturesSchema(
        features=(
            FeatureSpec("article_id", "categorical", num_items),
            FeatureSpec("created_at_ts", "numerical", dtype="int"),
            FeatureSpec("category0", "categorical", int(card.get("category0", 41))),
            FeatureSpec("category1", "categorical", int(card.get("category1", 128))),
            FeatureSpec("author", "categorical", int(card.get("author", 112))),
        )
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_clicks_json_path", required=True,
                   help="JSON-lines click log")
    p.add_argument("--output_sessions_tfrecords_path", required=True,
                   help="pattern with * for the hour index")
    p.add_argument("--output_nar_preprocessing_resources_path", required=True)
    p.add_argument("--timezone", default="Europe/Oslo")
    p.add_argument(
        "--num_workers", type=int, default=1,
        help="parallel per-hour TFRecord export (threads; gzip releases "
        "the GIL) — the reference runs this step on a Spark cluster",
    )
    p.add_argument(
        "--platform", default="", choices=("", "cpu", "cuda", "gpu"),
        help="accepted for the trainer's flag set and ignored: preprocessing "
        "runs on the host",
    )
    args = p.parse_args(argv)

    clicks = []
    user_encoder: dict = {}
    os_encoder: dict = {}
    device_encoder: dict = {}

    def _encode_dynamic(encoder: dict, value: str) -> int:
        if value not in encoder:
            encoder[value] = len(encoder) + 1  # 0 stays the padding id
        return encoder[value]
    with open(args.input_clicks_json_path) as f:
        for line in f:
            rec = json.loads(line)
            user = rec["userId"]
            if user not in user_encoder:
                user_encoder[user] = len(user_encoder) + 1
            clicks.append(
                Click(
                    user_id=user,
                    article_id=int(rec["id"]),
                    timestamp_ms=int(rec["time"]) * 1000,
                    context=rec,
                )
            )
    if not clicks:
        raise SystemExit("no clicks in input")
    dataset_start_ms = min(c.timestamp_ms for c in clicks)

    by_hour = defaultdict(list)
    for raw in sessionize_clicks(clicks, dataset_start_ms):
        ctx = {k: [] for k in CONTEXT_KEYS}
        ctx.update(
            {
                "local_hour_sin": [], "local_hour_cos": [], "weekday": [],
                "active_time_secs": [],
            }
        )
        for click in raw.clicks:
            rec = click.context or {}
            # Events without pre-encoded device/OS columns but with a raw
            # User-Agent header get them parsed here (the reference runs
            # ua-parser in its ETL, nar_module/nar/utils.py:145-180).
            if "userAgent" in rec and ("os" not in rec or "deviceType" not in rec):
                ua = rec["userAgent"]
                rec = dict(rec)
                rec.setdefault(
                    "os",
                    _encode_dynamic(os_encoder, extract_os_from_user_agent(ua)),
                )
                rec.setdefault(
                    "deviceType",
                    _encode_dynamic(
                        device_encoder,
                        extract_device_group_from_user_agent(ua),
                    ),
                )
            for key, src in (
                ("city", "city"), ("region", "region"), ("country", "country"),
                ("device", "deviceType"), ("os", "os"),
                ("referrer_class", "referrerClass"),
            ):
                ctx[key].append(int(rec.get(src, 0)))
            hs, hc, wd_scaled = local_time_features(
                click.timestamp_ms, args.timezone
            )
            ctx["local_hour_sin"].append(hs)
            ctx["local_hour_cos"].append(hc)
            # Adressa centers weekday: (wd+1-3.5)/7 = (wd+1)/7 − 0.5
            ctx["weekday"].append(wd_scaled - 0.5)
            # missing dwell time falls back to the scaler AVERAGE (→ 0 after
            # standardization), like the reference (nar_preprocess_adressa.py:
            # 144-146) — a 0-second default would read as "extremely short"
            active = rec.get("activeTime")
            if active is None:
                active = NUMERIC_SCALERS["active_time_secs"]["avg"]
            ctx["active_time_secs"].append(
                standardize("active_time_secs", active)
            )
        by_hour[raw.session_hour].append(
            Session(
                session_id=raw.session_id,
                user_id=user_encoder[raw.user_id],
                session_start=raw.start_ms // TIME_UNIT_MS,
                item_ids=[c.article_id for c in raw.clicks],
                timestamps=[c.timestamp_ms // TIME_UNIT_MS for c in raw.clicks],
                context=ctx,
            )
        )

    max_item = max(
        max(s.item_ids) for sessions in by_hour.values() for s in sessions
    )
    cardinalities = {
        "user_id": len(user_encoder) + 1,
        "item_clicked": max_item + 1,
    }
    schema = adressa_session_schema(cardinalities)
    hours_sorted = sorted(by_hour.items())
    workers = getattr(args, "num_workers", 1)
    if workers > 1 and len(hours_sorted) > 1:
        # per-hour writes are independent and gzip compression releases the
        # GIL, so a thread pool parallelizes the export step (the reference
        # runs this on a Spark cluster; see SURVEY.md §2.2)
        from concurrent.futures import ThreadPoolExecutor

        def write_one(item):
            hour, sessions = item
            out = args.output_sessions_tfrecords_path.replace(
                "*", f"{hour:04d}"
            )
            write_sessions_tfrecord(sessions, schema, out)

        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(write_one, hours_sorted))
    else:
        for hour, sessions in hours_sorted:
            out = args.output_sessions_tfrecords_path.replace("*", f"{hour:04d}")
            write_sessions_tfrecord(sessions, schema, out)
    serialize(
        args.output_nar_preprocessing_resources_path,
        {
            "nar_encoders": {
                "user_id": user_encoder,
                "os": os_encoder,
                "device": device_encoder,
            },
            "cardinalities": cardinalities,
            "numeric_scalers": NUMERIC_SCALERS,
        },
    )
    print(
        f"Exported {len(by_hour)} hour files, {sum(len(v) for v in by_hour.values())} sessions"
    )


if __name__ == "__main__":
    main()

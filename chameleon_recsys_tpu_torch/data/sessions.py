"""Session stream ↔ gzipped TFRecord bridge.

Round-trips the reference's per-hour session files
(SequenceExamples: context = user_id/session_id/session_start/session_size,
sequences = event_timestamp/item_clicked/context features —
nar_preprocess_gcom.py:75-108) into ``Session`` objects.  Timestamps on disk
are unix milliseconds (reference convention); in memory they are int32
seconds since a dataset epoch (config.TIME_UNIT_MS).

The port's copy of ``chameleon_recsys_tpu/data/sessions.py``; it builds this
package's ``data.collate.Session``.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

from ..config import SessionFeaturesSchema, TIME_UNIT_MS
from .collate import Session
from .example_proto import decode_sequence_example, encode_sequence_example
from .tfrecord import read_tfrecord_file, write_tfrecord_file

_STRUCTURAL_SINGLE = ("user_id", "session_id", "session_start", "session_size")
_STRUCTURAL_SEQ = ("event_timestamp", "item_clicked")


def write_sessions_tfrecord(
    sessions: Sequence[Session],
    schema: SessionFeaturesSchema,
    path,
    epoch_ms: int = 0,
):
    def records():
        for s in sessions:
            n = len(s.item_ids)
            ts_ms = [int(t) * TIME_UNIT_MS + epoch_ms for t in s.timestamps]
            context = {
                "user_id": [int(s.user_id)],
                "session_id": [int(s.session_id)],
                "session_start": [int(s.session_start) * TIME_UNIT_MS + epoch_ms],
                "session_size": [n],
            }
            sequences = {
                "event_timestamp": [[t] for t in ts_ms],
                "item_clicked": [[int(i)] for i in s.item_ids],
            }
            for spec in schema.context_sequence_features():
                vals = s.context.get(spec.name, [0] * n)
                if spec.dtype == "float":
                    sequences[spec.name] = [[float(v)] for v in vals]
                else:
                    sequences[spec.name] = [[int(v)] for v in vals]
            yield encode_sequence_example(context, sequences)

    write_tfrecord_file(path, records())


def read_sessions_tfrecord(
    path, schema: SessionFeaturesSchema, epoch_ms: int = 0
) -> List[Session]:
    sessions: List[Session] = []
    for record in read_tfrecord_file(path):
        context, sequences = decode_sequence_example(record)
        ts = [
            int((v[0] - epoch_ms) // TIME_UNIT_MS)
            for v in sequences["event_timestamp"]
        ]
        items = [int(v[0]) for v in sequences["item_clicked"]]
        extra = {}
        for spec in schema.context_sequence_features():
            steps = sequences.get(spec.name)
            if steps is None:
                continue
            if spec.dtype == "float":
                extra[spec.name] = [float(v[0]) if v else 0.0 for v in steps]
            else:
                extra[spec.name] = [int(v[0]) if v else 0 for v in steps]
        sessions.append(
            Session(
                session_id=int(context["session_id"][0]),
                user_id=int(context["user_id"][0]),
                session_start=int(
                    (context["session_start"][0] - epoch_ms) // TIME_UNIT_MS
                ),
                item_ids=items,
                timestamps=ts,
                context=extra,
            )
        )
    return sessions

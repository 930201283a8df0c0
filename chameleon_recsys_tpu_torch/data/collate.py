"""Sessions and their collation into fixed-shape padded batches.

Copies of ``Session``, ``collate_sessions`` and ``batches_from_sessions``
from ``chameleon_recsys_tpu/data/collate.py``: sessions are truncated to
``max_session_length`` clicks, inputs are clicks ``[:-1]``,
``label_next_item`` is clicks ``[1:]``, ``label_last_item`` is the final
click, and everything is zero-padded to [B, T] (T = max_session_length - 1).
Partial batches are padded with empty sessions (session_size = 0, fully
masked).  The batches are numpy arrays; the caller moves them to the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from ..config import SessionFeaturesSchema


@dataclass
class Session:
    session_id: int
    user_id: int
    session_start: int  # seconds since dataset epoch
    item_ids: List[int]  # click sequence (no padding)
    timestamps: List[int]  # per-click seconds since dataset epoch
    context: Dict[str, List] = field(default_factory=dict)  # per-click features


def collate_sessions(
    sessions: Sequence[Session],
    schema: SessionFeaturesSchema,
    batch_size: int,
    max_session_length: int,
) -> Dict[str, np.ndarray]:
    """Collate at most ``batch_size`` sessions into one fixed-shape batch."""
    t = max_session_length - 1
    if len(sessions) > batch_size:
        raise ValueError("more sessions than batch_size")

    def zeros(dtype=np.int32):
        return np.zeros((batch_size, t), dtype=dtype)

    batch: Dict[str, np.ndarray] = {
        "item_clicked": zeros(),
        "label_next_item": zeros(),
        "label_last_item": np.zeros((batch_size, 1), np.int32),
        "event_timestamp": zeros(),
        "session_size": np.zeros((batch_size,), np.int32),
        "session_id": np.zeros((batch_size,), np.int64),
        "user_id": np.zeros((batch_size,), np.int64),
        "session_start": np.zeros((batch_size,), np.int64),
    }
    for spec in schema.context_sequence_features():
        dtype = np.float32 if spec.dtype == "float" else np.int32
        batch[spec.name] = zeros(dtype)

    for i, s in enumerate(sessions):
        items = s.item_ids[:max_session_length]
        ts = s.timestamps[:max_session_length]
        n = len(items)
        if n < 2:
            raise ValueError("sessions must have >= 2 clicks")
        batch["session_size"][i] = n
        batch["session_id"][i] = s.session_id
        batch["user_id"][i] = s.user_id
        batch["session_start"][i] = s.session_start
        batch["item_clicked"][i, : n - 1] = items[:-1]
        batch["label_next_item"][i, : n - 1] = items[1:]
        batch["label_last_item"][i, 0] = items[-1]
        batch["event_timestamp"][i, : n - 1] = ts[:-1]
        for spec in schema.context_sequence_features():
            vals = s.context[spec.name][:max_session_length]
            batch[spec.name][i, : n - 1] = vals[: n - 1]

    return batch


def batches_from_sessions(
    sessions: Sequence[Session],
    schema: SessionFeaturesSchema,
    batch_size: int,
    max_session_length: int,
):
    """Yield fixed-shape batches covering ``sessions`` in order."""
    for start in range(0, len(sessions), batch_size):
        yield collate_sessions(
            sessions[start : start + batch_size],
            schema,
            batch_size,
            max_session_length,
        )

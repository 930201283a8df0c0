"""Temporal context features.

Twin of get_time_features / get_cicled_feature_value
(nar_module/nar/preprocessing/nar_preprocess_gcom.py:53-73): local hour as
sin/cos on a 24h cycle and weekday scaled to (0, 1].

The port's copy of
``chameleon_recsys_tpu/data/preprocessing/time_features.py``.  The zone comes
from the system tz database; a missing zone (``America/Sao_Paulo`` for G1,
``Europe/Oslo`` for Adressa) raises: both zones keep DST, so no fixed
offset stands in.
"""
from __future__ import annotations

import datetime
import math
import zoneinfo
from typing import Tuple


def cycled_feature(value: float, max_value: float) -> Tuple[float, float]:
    scaled = (value + 1e-6) / max_value
    return math.sin(2 * math.pi * scaled), math.cos(2 * math.pi * scaled)


def local_time_features(
    timestamp_ms: int, tz: str = "America/Sao_Paulo"
) -> Tuple[float, float, float]:
    """(hour_sin, hour_cos, weekday_scaled) in the clicks' local timezone."""
    dt = datetime.datetime.fromtimestamp(
        timestamp_ms / 1000.0, tz=zoneinfo.ZoneInfo(tz)
    )
    hour_sin, hour_cos = cycled_feature(dt.hour, 24)
    weekday_scaled = (dt.weekday() + 1) / 7.0  # Monday = 1/7
    return hour_sin, hour_cos, weekday_scaled

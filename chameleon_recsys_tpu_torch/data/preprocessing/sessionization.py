"""Click-stream sessionization (the reference's Spark/Dataproc step, local).

Re-creation of the Adressa sessionization notebook's semantics
(nar_module/scripts/dataproc_preprocessing/
nar_preprocessing_addressa_01_dataproc.ipynb, cells 54-58, per SURVEY.md §2.2)
as plain Python, with no cluster:

  * a session closes after 30 idle minutes (MAX_SESSION_IDLE_TIME);
  * repeated clicks on the same article within a session are dropped;
  * sessions need ≥ 2 clicks;
  * synthetic ``session_id = first_click_ts_ms * 100 + hash(user_id) % 1000``
    so sorting ids sorts by session start time (required by V-SkNN,
    nar_model.py:1630-1631);
  * ``session_hour`` = hours since the dataset start.

The port's copy of
``chameleon_recsys_tpu/data/preprocessing/sessionization.py``.  Python
salts ``hash`` of a str per process (``PYTHONHASHSEED``): the session ids,
and so the session files, repeat within a process, or across processes
with the seed fixed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List

MAX_SESSION_IDLE_TIME_MS = 30 * 60 * 1000


@dataclass
class Click:
    user_id: str
    article_id: int
    timestamp_ms: int
    context: Dict[str, object] = None


@dataclass
class RawSession:
    session_id: int
    user_id: str
    start_ms: int
    session_hour: int
    clicks: List[Click]


def _close_session(user_id: str, clicks: List[Click], dataset_start_ms: int):
    if len(clicks) < 2:
        return None
    first_ts = clicks[0].timestamp_ms
    session_id = first_ts * 100 + hash(user_id) % 1000
    return RawSession(
        session_id=session_id,
        user_id=user_id,
        start_ms=first_ts,
        session_hour=(first_ts - dataset_start_ms) // (1000 * 60 * 60),
        clicks=clicks,
    )


def sessionize_clicks(
    clicks: Iterable[Click],
    dataset_start_ms: int,
    max_idle_ms: int = MAX_SESSION_IDLE_TIME_MS,
) -> Iterator[RawSession]:
    """Group a click stream into sessions.  Clicks need not be globally
    sorted, only per-user sorted (they are sorted per user internally)."""
    by_user: Dict[str, List[Click]] = {}
    for click in clicks:
        by_user.setdefault(click.user_id, []).append(click)

    sessions: List[RawSession] = []
    for user_id, user_clicks in by_user.items():
        user_clicks.sort(key=lambda c: c.timestamp_ms)
        current: List[Click] = []
        seen_articles = set()
        last_ts = None
        for click in user_clicks:
            if last_ts is not None and click.timestamp_ms - last_ts > max_idle_ms:
                s = _close_session(user_id, current, dataset_start_ms)
                if s:
                    sessions.append(s)
                current, seen_articles = [], set()
            last_ts = click.timestamp_ms
            if click.article_id in seen_articles:
                continue  # de-dup repeated article within session
            seen_articles.add(click.article_id)
            current.append(click)
        s = _close_session(user_id, current, dataset_start_ms)
        if s:
            sessions.append(s)

    sessions.sort(key=lambda s: s.start_ms)
    yield from sessions

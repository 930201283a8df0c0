"""The session record the serving path takes."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class Session:
    session_id: int
    user_id: int
    session_start: int  # seconds since dataset epoch
    item_ids: List[int]  # click sequence (no padding)
    timestamps: List[int]  # per-click seconds since dataset epoch
    context: Dict[str, List] = field(default_factory=dict)  # per-click features

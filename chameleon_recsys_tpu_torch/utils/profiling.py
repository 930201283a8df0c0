"""Throughput counters: steps/s, sessions/s and clicks/s of one phase.

The port's copy of ``ThroughputMeter`` from
``chameleon_recsys_tpu/utils/profiling.py``; the device-trace helpers there
come with the tooling slice.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class ThroughputMeter:
    """Streaming throughput counters for one phase (train or eval)."""

    name: str = "train"
    steps: int = 0
    sessions: int = 0
    clicks: int = 0
    elapsed: float = 0.0
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, steps: int = 1, sessions: int = 0, clicks: int = 0):
        if self._t0 is None:
            return
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None
        self.steps += steps
        self.sessions += sessions
        self.clicks += clicks

    @contextlib.contextmanager
    def measure(self, sessions: int = 0, clicks: int = 0):
        self.start()
        try:
            yield
        finally:
            self.stop(1, sessions, clicks)

    def result(self) -> Dict[str, float]:
        dt = max(self.elapsed, 1e-9)
        return {
            f"{self.name}_steps": self.steps,
            f"{self.name}_elapsed_s": round(self.elapsed, 3),
            f"{self.name}_steps_per_s": round(self.steps / dt, 2),
            f"{self.name}_sessions_per_s": round(self.sessions / dt, 1),
            f"{self.name}_clicks_per_s": round(self.clicks / dt, 1),
        }

    def reset(self):
        self.steps = self.sessions = self.clicks = 0
        self.elapsed = 0.0
        self._t0 = None

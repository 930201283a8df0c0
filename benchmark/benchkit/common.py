"""What every run shares: its record, the seconds since the process
started, the device's description, the check that no JAX was loaded, and
the result line."""
from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "chameleon_recsys_tpu")


def process_seconds() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, Flax's or the
    JAX package's, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Check:
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    """One run of one cell: what the driver measured and what the readers
    and the comparison read."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    tmpdir: str
    setup_phases: Dict[str, float] = field(default_factory=dict)
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = field(default_factory=dict)
    host: Dict[str, Any] = field(default_factory=dict)  # host-clock records
    work: Dict[str, Any] = field(default_factory=dict)  # shapes of the work done
    trace_summary: Any = None
    memory_peak_bytes: int = 0
    checks: Dict[str, Check] = field(default_factory=dict)

    def phase(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.setup_phases[name] = self.setup_phases.get(name, 0.0) + now - t0
        return now


def result_line(run: Run, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict]) -> str:
    out = {
        "correct": bool(run.checks) and all(c.ok for c in run.checks.values()),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup_phases_s"] = run.setup_phases
    out["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in run.checks.items()}
    return json.dumps(out)

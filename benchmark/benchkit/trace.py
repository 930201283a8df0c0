"""A profiled stretch of a run and what it says: the device's busy time,
time by device operation, and the device's idle gaps by what the host was
doing.  The benchmark's own spans (``span``) mark its calls into the
system; the profiler's Chrome trace (``torch.profiler``, CUPTI on the card)
gives device events and host operations on one clock."""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's, seen in the trace as ``bench.<name>``."""
    with torch.profiler.record_function("bench." + name):
        yield


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]  # (name, seconds), most first
    idle_gaps: List[Tuple[str, float]]  # (what the host did, seconds), most first
    kernels: Dict[str, float] = field(default_factory=dict)  # name -> seconds
    units: int = 0  # the calls the traced stretch made


def profile(run_units: Callable[[], int], tmpdir: str, cuda: bool = True) -> Trace:
    """Profile ``run_units()`` (which returns how many calls it made) inside
    the span ``bench.window``, synchronised at both ends; ``cuda`` False
    profiles the host alone (the CPU tests)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with torch_profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            units = run_units()
            sync()
    path = Path(tmpdir) / f"trace-{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    trace = read(events)
    trace.units = units
    return trace


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short(name: str, n: int = 64) -> str:
    name = re.sub(r"\s+", " ", name)
    return name if len(name) <= n else name[:n]


def read(events: List[dict]) -> Trace:
    """Busy and idle time of the device inside the ``bench.window`` span."""
    win = next((e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
                and e.get("cat") == "user_annotation"), None)
    if win is None:
        raise RuntimeError("the trace has no bench.window span")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev, host = [], collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s, d = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 > s0:
                dev.append((s0, s1, str(e.get("name", ""))))
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host[(e.get("pid"), e.get("tid"))].append((s, s + d, str(e.get("name", ""))))
    kernels: Dict[str, float] = collections.defaultdict(float)
    for s, t, name in dev:
        kernels[name] += (t - s) / 1e6
    busy = _merge([(s, t) for s, t, _ in dev])
    busy_s = sum(t - s for s, t in busy) / 1e6
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    by_what: Dict[str, float] = collections.defaultdict(float)
    for (g0, g1), what in zip(gaps, _host_at([(a + b) / 2 for a, b in gaps], host)):
        by_what[what] += (g1 - g0) / 1e6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])
    return Trace((w1 - w0) / 1e6, busy_s,
                 [(short(n), s) for n, s in ops[:10]],
                 sorted(by_what.items(), key=lambda kv: -kv[1])[:10],
                 dict(kernels))


def _host_at(points: List[float], host) -> List[str]:
    """For each time point: the innermost benchmark span open there and the
    innermost host operation open there (on any thread; ``python`` where
    none is), as ``span:operation``."""
    spans, ops = [], collections.defaultdict(list)
    for key, evs in host.items():
        for e in evs:
            (spans if e[2].startswith("bench.") else ops[key]).append(e)
    spans.sort()
    out = []
    indexed = []
    for evs in ops.values():
        evs.sort()
        indexed.append(([e[0] for e in evs], evs))
    for p in points:
        sp = [e for e in spans if e[0] <= p < e[1]]
        where = max(sp)[2][6:] if sp else "none"
        best = None
        for starts, evs in indexed:
            k = bisect.bisect_right(starts, p) - 1
            stop = max(k - 50, -1)
            while k > stop:
                s, t, name = evs[k]
                if t > p:
                    if best is None or s > best[0]:
                        best = (s, name)
                    break
                k -= 1
        out.append(f"{where}:{short(best[1], 40) if best else 'python'}")
    return out

"""A profiled stretch as ``trace.profile`` reads it, and besides the device
time of the work launched under each of some of the program's spans: a
kernel, copy or memset counts under a span where the runtime call that
launched it (the event of the same ``correlation``) started inside one of
the span's ``user_annotation`` intervals, on any thread."""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

from . import trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def device_seconds_under(events, names: Sequence[str]) -> Dict[str, float]:
    """{span name: device seconds of the work launched inside it}."""
    intervals = {n: sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                           for e in events if e.get("ph") == "X"
                           and e.get("cat") == "user_annotation" and e.get("name") == n)
                 for n in names}
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    out = {n: 0.0 for n in names}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        at = launches.get(e.get("args", {}).get("correlation"))
        if at is None:
            continue
        for n, spans in intervals.items():
            if any(s <= at < t for s, t in spans):
                out[n] += float(e.get("dur", 0.0)) / 1e6
    return out


def profile(run_units: Callable[[], int], tmpdir: str, cuda: bool,
            names: Sequence[str]) -> Tuple[trace.Trace, Dict[str, float]]:
    """``trace.profile``'s stretch, and ``device_seconds_under`` ``names``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with torch_profile(activities=activities) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            units = run_units()
            sync()
    path = Path(tmpdir) / f"trace-{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    summary = trace.read(events)
    summary.units = units
    return summary, device_seconds_under(events, names)

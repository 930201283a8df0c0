"""Observability: throughput counters and device time on the card.

The port of ``chameleon_recsys_tpu/utils/profiling.py``:

- ``ThroughputMeter``, steps/s, sessions/s and clicks/s of one phase;
- the readers of a profiler trace, ``device_op_durations``,
  ``device_op_durations_by_track`` and ``device_op_totals``, over the Chrome
  trace the torch profiler writes (``torch_trace``, the counterpart of
  ``xla_trace``).  They count device events only (kernels, copies and
  memsets: Kineto's categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``),
  never host events, whatever their names; a device's tracks are its
  streams;
- ``device_call_times_ms`` and ``device_time_ms``, each call timed by CUDA
  events on the current stream;
- ``cuda_ms`` (the mean over back-to-back calls by CUDA events),
  ``launch_split`` (each launch of one call, by the profiler) and
  ``device_profile`` (device time by kernel and the launches of a call);
  they return data and leave the printing to the caller.  Like the trace
  readers they leave out the device-side spans of ``record_function``
  ranges (``Optimizer.step#...``), which cover kernels counted on their own.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

log = logging.getLogger("chameleon_torch.profiling")

# the Chrome trace categories of device work (Kineto's names)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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


# ---------------------------------------------------------------------------
# Trace readers
# ---------------------------------------------------------------------------

def _device_events(trace_dir: str):
    """(device ``X`` events, {(pid, tid): thread name}) of the last trace
    file under ``trace_dir`` (``*.pt.trace.json``, gzipped or not)."""
    paths = sorted(glob.glob(trace_dir + "/**/*.pt.trace.json", recursive=True)
                   + glob.glob(trace_dir + "/**/*.pt.trace.json.gz", recursive=True))
    if not paths:
        return [], {}
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        events = json.load(f).get("traceEvents", [])
    threads = {
        (e.get("pid"), e.get("tid")): e.get("args", {}).get("name", "")
        for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"
    }
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    return device, threads


def device_op_durations(trace_dir: str) -> Dict[str, List[float]]:
    """{device event name: [durations ms]} over the trace in ``trace_dir``:
    what the card executed, immune to the host's dispatch."""
    durs: Dict[str, List[float]] = collections.defaultdict(list)
    for e in _device_events(trace_dir)[0]:
        durs[str(e.get("name", ""))].append(float(e.get("dur", 0.0)) / 1e3)
    return dict(durs)


def device_op_durations_by_track(trace_dir: str) -> Dict[str, Dict[str, float]]:
    """{device track: {event name: total ms}}: a track is a stream (its
    thread name, e.g. ``stream 7``, or its tid), so work that overlaps on
    two streams is not summed into one timeline."""
    events, threads = _device_events(trace_dir)
    out: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    for e in events:
        track = threads.get((e.get("pid"), e.get("tid"))) or str(e.get("tid"))
        out[track][str(e.get("name", ""))] += float(e.get("dur", 0.0)) / 1e3
    return {k: dict(v) for k, v in out.items()}


def device_op_totals(trace_dir: str) -> Dict[str, float]:
    """{device event name: total ms} over the trace in ``trace_dir``."""
    return {k: sum(v) for k, v in device_op_durations(trace_dir).items()}


@contextlib.contextmanager
def torch_trace(log_dir: str, enabled: bool = True):
    """A torch-profiler trace of the block written under ``log_dir`` as a
    Chrome trace (``*.pt.trace.json``; the readers above, TensorBoard or
    Perfetto read it), the card's activity included where there is a card;
    yields the profiler (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


# ---------------------------------------------------------------------------
# Device time on the card
# ---------------------------------------------------------------------------

def device_call_times_ms(fn: Callable, args=(), iters: int = 50) -> List[float]:
    """Each of ``iters`` calls of ``fn(*args)`` timed by CUDA events around
    it on the current stream, after one warm-up call; empty without a card.
    A call the host dispatches more slowly than the card runs it includes
    the card's wait for the host."""
    if not torch.cuda.is_available():
        return []
    fn(*args)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def device_time_ms(fn: Callable, args=(), iters: int = 10) -> float:
    """The mean of ``device_call_times_ms``; 0.0 without a card."""
    times = device_call_times_ms(fn, args, iters)
    return sum(times) / len(times) if times else 0.0


def cuda_ms(fn: Callable, iters: int, warmup: int = 5) -> float:
    """ms a call of ``fn()`` over ``iters`` back-to-back calls, by two CUDA
    events around them all, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _is_device_work(event, device_type) -> bool:
    """A kernel, copy or memset on the card: not the device-side span of a
    ``record_function`` range (e.g. ``Optimizer.step#...``), which covers
    kernels that are counted on their own."""
    return (event.device_type == device_type.CUDA
            and not getattr(event, "is_user_annotation", False))


def launch_split(fn: Callable, calls: int) -> List[Tuple[str, float]]:
    """[(kernel name, mean device us)] for each launch of one ``fn()`` call,
    in launch order, over ``calls`` profiled calls (torch profiler, device
    events only).  A session counts only where its device events are
    ``calls`` repeats of one launch sequence, every record kept; the
    profiler now and then records no device event, or one of an earlier
    session, so a session that is not is profiled again, and after eight
    such sessions the split raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if _is_device_work(e, DeviceType)),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        per_call = len(events) // calls
        if (events and per_call * calls == len(events)
                and names == names[:per_call] * calls):
            return [
                (events[i].name,
                 sum(events[c * per_call + i].time_range.elapsed_us()
                     for c in range(calls)) / calls)
                for i in range(per_call)
            ]
        log.warning("launch split: %d device events over %d calls, not %d repeats of "
                    "one sequence; profiling again", len(events), calls, calls)
    raise RuntimeError(f"launch split: no even session in eight over {calls} calls: "
                       + ", ".join(f"{name[:60]} x{n}" for name, n in
                                   collections.Counter(e.name for e in events).items()))


@dataclass
class DeviceProfile:
    """A profile of ``calls`` calls: the card's busy time and its launches
    (kernels and copies) per call, and (name, us per call, launches per
    call) for each device kernel, the most time first."""

    busy_us: float
    launches: float
    kernels: List[Tuple[str, float, float]]

    def busy_share(self, host_ms: float) -> float:
        """The busy time's share of ``host_ms`` a call."""
        return self.busy_us / (host_ms * 1e3)


def device_profile(fn: Callable, calls: int) -> Optional[DeviceProfile]:
    """Device time by kernel over ``calls`` calls of ``fn`` (torch profiler,
    device-side events only); None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [
        (e.key, e.self_device_time_total / calls, e.count / calls)
        for e in prof.key_averages()
        if _is_device_work(e, DeviceType) and e.self_device_time_total > 0
    ]
    if not kernels:
        return None
    return DeviceProfile(busy_us=sum(k[1] for k in kernels),
                         launches=sum(k[2] for k in kernels),
                         kernels=sorted(kernels, key=lambda k: -k[1]))

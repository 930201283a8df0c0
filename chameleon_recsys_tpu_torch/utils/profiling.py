"""Observability: throughput counters and device time on the card.

The port of ``chameleon_recsys_tpu/utils/profiling.py``:

- ``ThroughputMeter``, steps/s, sessions/s and clicks/s of one phase;
- the program's spans (``span``, ``spanned``): named host intervals at
  batch and call granularity in the train hour, the eval hour,
  ``recommend`` and the neural baselines' train hour, nothing while
  tracing is off (``set_tracing``; a running torch profiler also turns it
  on, ``tracing``), seconds and calls in a registry (``span_snapshot``,
  ``reset_spans``) while it is on, and profiler ranges on the device's
  clock while a profiler runs;
- the program's counters (``add_counts``, ``counter_snapshot``,
  ``reset_counters``): named sums that code adds to while tracing is on;
- the readers of a profiler trace, ``device_op_durations``,
  ``device_op_durations_by_track`` and ``device_op_totals``, over the Chrome
  trace the torch profiler writes (``torch_trace``, the counterpart of
  ``xla_trace``).  They count device events only (kernels, copies and
  memsets: Kineto's categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``),
  never host events, whatever their names; a device's tracks are its
  streams; ``span_breakdown`` reads the program's spans in such a trace:
  their seconds, the device operations launched under each, and the
  device's idle time under each;
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

import bisect
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
# Program spans
# ---------------------------------------------------------------------------

# Tracing is on while ``set_tracing(True)`` holds or while a torch profiler
# runs.  The registry is the process's: {span name: [seconds, calls]} of
# the spans closed while tracing was on.  Spans are opened on the thread
# that drives the harness or the server, never on a worker thread.
_tracing = False
_spans: Dict[str, List[float]] = {}
_counters: Dict[str, Dict[str, float]] = {}
# the names of the program's spans start so: NAR's, and the neural
# baselines' runner and GRU4Rec's
SPAN_PREFIX = ("nar.", "neural.", "gru4rec.")
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """The span of ``span(name)`` while tracing is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "into", "key", "t0", "mark")

    def __init__(self, name: str, into: Optional[Dict[str, float]], key: Optional[str]):
        self.name, self.into, self.key, self.mark = name, into, key, None

    def __enter__(self):
        if _profiler_enabled():
            self.mark = torch.profiler.record_function(self.name)
            self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        seconds = time.perf_counter() - self.t0
        if self.mark is not None:
            self.mark.__exit__(exc_type, exc, tb)
        if self.into is not None:
            self.into[self.key] += seconds
        if _tracing or self.mark is not None:
            entry = _spans.setdefault(self.name, [0.0, 0])
            entry[0] += seconds
            entry[1] += exc_type is not StopIteration
        return False


def span(name: str, into: Optional[Dict[str, float]] = None, key: Optional[str] = None):
    """A span of the program around a ``with`` block.

    While tracing is off it is one shared object that does nothing.  While
    tracing is on it adds its host seconds and one call to the registry
    (``span_snapshot``), and while a torch profiler runs it is also a
    ``record_function`` range, a ``user_annotation`` event of the profiler's
    Chrome trace on the clock of the device's events.  ``into[key]`` gains
    its seconds whether tracing is on or off: a caller's own timer, kept
    through the same span.  A block left by ``StopIteration`` (an
    iterator's last pull, which finds no item) adds its seconds but no
    call.  It never waits for the device."""
    if _tracing or into is not None or _profiler_enabled():
        return _Span(name, into, key)
    return _OFF


def spanned(name: str, iterable):
    """The items of ``iterable``, each pull inside ``span(name)``."""
    it = iter(iterable)
    while True:
        try:
            with span(name):
                item = next(it)
        except StopIteration:
            return
        yield item


def set_tracing(on: bool) -> bool:
    """Turn the program's tracing on or off; returns what it was."""
    global _tracing
    was, _tracing = _tracing, bool(on)
    return was


def tracing() -> bool:
    """Whether tracing is on: ``set_tracing(True)`` holds or a torch
    profiler runs."""
    return _tracing or _profiler_enabled()


def span_snapshot() -> Dict[str, Tuple[float, int]]:
    """{span name: (seconds, calls)} since the last ``reset_spans``."""
    return {name: (entry[0], entry[1]) for name, entry in _spans.items()}


def reset_spans() -> None:
    _spans.clear()


def add_counts(name: str, **values: float) -> None:
    """Add ``values`` (field: amount) to counter ``name`` in the registry.
    Callers add only while ``tracing()`` holds."""
    entry = _counters.setdefault(name, {})
    for field, value in values.items():
        entry[field] = entry.get(field, 0.0) + float(value)


def counter_snapshot() -> Dict[str, Dict[str, float]]:
    """{counter name: {field: sum}} since the last ``reset_counters``."""
    return {name: dict(entry) for name, entry in _counters.items()}


def reset_counters() -> None:
    _counters.clear()


# ---------------------------------------------------------------------------
# Trace readers
# ---------------------------------------------------------------------------

def trace_events(trace_dir: str) -> List[dict]:
    """The events of the last trace file under ``trace_dir``
    (``*.pt.trace.json``, gzipped or not); empty where there is none."""
    paths = sorted(glob.glob(trace_dir + "/**/*.pt.trace.json", recursive=True)
                   + glob.glob(trace_dir + "/**/*.pt.trace.json.gz", recursive=True))
    if not paths:
        return []
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        return json.load(f).get("traceEvents", [])


def _device_events(trace_dir: str):
    """(device ``X`` events, {(pid, tid): thread name}) of the last trace
    file under ``trace_dir``."""
    events = trace_events(trace_dir)
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


@dataclass
class SpanBreakdown:
    """What a Chrome trace says of the program's spans over a stretch.
    ``spans``: {name: (seconds, calls)}; ``launched``: {innermost span open
    at the launch: (device operations, device seconds)}; ``idle_by_span``:
    {innermost span open: seconds no device operation ran}.  ``none`` is
    the key of what falls under no span."""

    window_s: float
    busy_s: float
    spans: Dict[str, Tuple[float, int]]
    launched: Dict[str, Tuple[int, float]]
    idle_by_span: Dict[str, float]


def _boundaries(spans: List[Tuple[float, float, str]]):
    """(times, names): from ``times[i]`` to ``times[i + 1]`` the innermost
    of the nested ``spans`` (start, end, name) open is ``names[i]`` (None
    where none is)."""
    times: List[float] = []
    names: List[Optional[str]] = []

    def at(t, name):
        if times and t <= times[-1]:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)

    stack: List[Tuple[float, str]] = []  # (end, name), the innermost last

    def close(until):
        while stack and stack[-1][0] <= until:
            t = stack.pop()[0]
            at(t, stack[-1][1] if stack else None)

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close(s)
        stack.append((e, name))
        at(s, name)
    close(float("inf"))
    return times, names


def _split_gap(g0: float, g1: float, times, names, idle: Dict[str, float]) -> None:
    """Add the gap from ``g0`` to ``g1`` (us) to ``idle``, split among the
    innermost spans open over it."""
    k = bisect.bisect_right(times, g0) - 1
    t = g0
    while t < g1:
        nxt = times[k + 1] if k + 1 < len(times) else g1
        u = min(nxt, g1)
        idle[(names[k] if k >= 0 else None) or "none"] += (u - t) / 1e6
        t, k = u, k + 1


def span_breakdown(events: List[dict], start: Optional[float] = None,
                   end: Optional[float] = None) -> SpanBreakdown:
    """The program's spans in a Chrome trace's ``events`` (the
    ``user_annotation`` events of ``span`` named as ``SPAN_PREFIX`` has
    it), over the
    stretch from ``start`` to ``end`` (us, the trace's clock; by default
    the first span's start to the last one's end).  Each kernel, copy or memset counts under the
    innermost span open, on any thread, when its launch (the runtime call
    of the same ``correlation``) started: the autograd engine launches the
    backward from its own thread.  Each idle gap of the device is split
    among the innermost spans open over it."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), str(e["name"]))
             for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    if start is None:
        start = min((s for s, _, _ in spans), default=0.0)
    if end is None:
        end = max((t for _, t, _ in spans), default=start)
    spans = [x for x in spans if start <= x[0] < end]
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for s, t, name in spans:
        by_name[name][0] += (t - s) / 1e6
        by_name[name][1] += 1
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    times, names = _boundaries(spans)

    def under(t):
        k = bisect.bisect_right(times, t) - 1
        return (names[k] if k >= 0 else None) or "none"

    launched: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    busy = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        s = float(e["ts"])
        s0, s1 = max(s, start), min(s + float(e.get("dur", 0.0)), end)
        if s1 <= s0:
            continue
        busy.append((s0, s1))
        launch = launches.get(e.get("args", {}).get("correlation"))
        entry = launched[under(launch) if launch is not None else "none"]
        entry[0] += 1
        entry[1] += (s1 - s0) / 1e6
    idle: Dict[str, float] = collections.defaultdict(float)
    prev, busy_s = start, 0.0
    for s, t in sorted(busy) + [(end, end)]:
        if s > prev:
            _split_gap(prev, s, times, names, idle)
        busy_s += max(0.0, t - max(s, prev))
        prev = max(prev, t)
    return SpanBreakdown((end - start) / 1e6, busy_s / 1e6,
                         {k: (v[0], int(v[1])) for k, v in by_name.items()},
                         {k: (int(v[0]), v[1]) for k, v in launched.items()},
                         dict(idle))


@contextlib.contextmanager
def torch_trace(log_dir: str, enabled: bool = True):
    """A torch-profiler trace of the block written under ``log_dir`` as a
    Chrome trace (``*.pt.trace.json``; the readers above, TensorBoard or
    Perfetto read it), the card's activity included where there is a card;
    yields the profiler (None when not ``enabled``).  Tracing is on inside
    the block, so the trace carries the program's spans (``span``) on the
    clock of the device's events, and the registry counts them: the
    operator's way to see both at once (``span_breakdown`` reads them)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was = set_tracing(True)
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
            yield prof
    finally:
        set_tracing(was)


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

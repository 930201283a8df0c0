"""The device-trace readers and timers of ``chameleon_recsys_tpu_torch/utils/profiling.py``.

A torch-profiler Chrome trace holds host events (``cpu_op``,
``cuda_runtime``, ``python_function``, annotations) beside the card's
(``kernel``, ``gpu_memcpy``, ``gpu_memset``, one track per stream), and
names repeat across the two: ``aten::mm`` on the host launches a kernel.
These tests pin, on synthetic trace files as ``tests/test_profiling.py``
does for XLA's, that the readers count device events only, keep a device's
streams apart and sum each name's time; and that the profiler's own trace
of a CPU run, which holds no device event, reads as empty.  The card's
timers are held on the card in ``tests/test_torch_cuda.py``.
"""
import gzip
import json

import pytest
import torch

from chameleon_recsys_tpu_torch.utils import profiling
from chameleon_recsys_tpu_torch.utils.profiling import (
    DeviceProfile,
    device_op_durations,
    device_op_durations_by_track,
    device_op_totals,
    torch_trace,
)


def _write_trace(root, events, name="host_1.1700000000000.pt.trace.json", gz=False):
    root.mkdir(parents=True, exist_ok=True)
    payload = json.dumps({"traceEvents": events})
    if gz:
        with gzip.open(root / (name + ".gz"), "wt") as f:
            f.write(payload)
    else:
        (root / name).write_text(payload)
    return str(root)


def _thread(pid, tid, name):
    return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": name}}


def _x(cat, name, pid, tid, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}


EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    {"ph": "M", "name": "process_name", "pid": 4242, "args": {"name": "python"}},
    _thread(0, 7, "stream 7 "),
    _thread(0, 13, "stream 13 "),
    _x("kernel", "gemm", 0, 7, 0, 4000),
    _x("kernel", "gemm", 0, 7, 5000, 2000),
    _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 0, 7, 8000, 500),
    _x("gpu_memset", "Memset (Device)", 0, 13, 0, 250),
    _x("kernel", "elementwise", 0, 13, 1000, 1500),
    # an annotation spans device work on the same pid: no device work itself
    _x("gpu_user_annotation", "step", 0, 7, 0, 9000),
    # host events with tempting names
    _x("cpu_op", "gemm", 4242, 4242, 0, 999000),
    _x("cuda_runtime", "cudaLaunchKernel", 4242, 4242, 10, 20),
    _x("python_function", "elementwise", 4242, 4242, 0, 50000),
]


def test_device_events_only_streams_apart_and_totals(tmp_path):
    trace = _write_trace(tmp_path / "a", EVENTS)
    assert device_op_durations(trace) == {
        "gemm": [4.0, 2.0], "Memcpy HtoD (Pinned -> Device)": [0.5],
        "Memset (Device)": [0.25], "elementwise": [1.5]}
    assert device_op_durations_by_track(trace) == {
        "stream 7 ": {"gemm": 6.0, "Memcpy HtoD (Pinned -> Device)": 0.5},
        "stream 13 ": {"Memset (Device)": 0.25, "elementwise": 1.5}}
    totals = device_op_totals(trace)
    assert totals["gemm"] == 6.0 and sum(totals.values()) == 8.25


def test_last_trace_file_gzipped_and_unnamed_tracks(tmp_path):
    """The last trace file by name is read, gzipped as well; a stream
    without a thread name is keyed by its tid."""
    root = tmp_path / "plugins"
    _write_trace(root, EVENTS, name="host_1.1700000000000.pt.trace.json")
    _write_trace(root / "later", [_x("kernel", "op", 0, 9, 0, 1000)],
                 name="host_1.1800000000000.pt.trace.json", gz=True)
    assert device_op_durations_by_track(str(root)) == {"9": {"op": 1.0}}
    assert device_op_durations(str(tmp_path / "empty")) == {}


def test_torch_trace_of_a_cpu_run_reads_as_no_device_time(tmp_path):
    x = torch.randn(64, 64)
    with torch_trace(str(tmp_path / "off"), enabled=False) as prof:
        x @ x
    assert prof is None and not (tmp_path / "off").exists()
    with torch_trace(str(tmp_path / "on")) as prof:
        x @ x
    files = list((tmp_path / "on").glob("*.pt.trace.json"))
    assert prof is not None and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert device_op_durations(str(tmp_path / "on")) == {}


def test_device_timers_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    assert profiling.device_call_times_ms(lambda: calls.append(1), (), 5) == []
    assert profiling.device_time_ms(lambda: calls.append(1)) == 0.0
    assert not calls


def test_busy_share():
    prof = DeviceProfile(busy_us=1500.0, launches=3.0, kernels=[("k", 1500.0, 3.0)])
    assert prof.busy_share(3.0) == pytest.approx(0.5)

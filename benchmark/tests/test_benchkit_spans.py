"""The readers of the system's own spans (``benchkit/spans.py``): a traced
run of each driver gives every ``program_span`` metric that reads them, a
system without the registry gives none, and the spans in a trace leave the
trace reader's device numbers as they were."""
import sys
import types

import pytest
import torch

import tiny
import run as bench_run
from benchkit import spans, spec, trace

from chameleon_recsys_tpu_torch.utils import profiling

BENCH = spec.benchmark()
READS_SPANS = {"collate_ms.train", "collate_ms.eval", "recommend_candidates_ms",
               "recommend_collate_ms", "host_wait_share.train", "host_wait_share.eval",
               "host_wait_share.serve"}


@pytest.mark.parametrize("workload", ["g1.train", "g1.serve", "g1.eval"])
def test_a_traced_run_gives_every_span_metric(workload, tmp_path):
    profiling.reset_spans()
    run = tiny.tiny_run(workload, 17, tmp_path)
    run.trace = True
    bench_run.execute(run, torch.device("cpu"))
    cell = spec.cell(workload, BENCH)
    mine = [m["name"] for m in cell.per_layer if m["name"] in READS_SPANS]
    assert mine
    for name in mine:
        value = spec.metric_reader(name)(run)
        assert value is not None and value > 0, name
        if name.startswith("host_wait_share"):
            assert value < 100
    profiling.reset_spans()


def test_span_metrics_read_nothing_without_the_registry(monkeypatch, tmp_path):
    run = tiny.tiny_run("g1.serve", 3, tmp_path)
    run.trace_summary = trace.Trace(1.0, 0.5, [], [])
    monkeypatch.setitem(sys.modules, spans.REGISTRY, types.ModuleType(spans.REGISTRY))
    assert spans.snapshot() == {}
    for name in READS_SPANS:
        assert spec.metric_reader(name)(run) is None, name


def test_program_spans_leave_the_device_numbers_as_they_were():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.recommend", "ts": 0, "dur": 100,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 30, "dur": 30, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 25, "dur": 10, "pid": 0, "tid": 8},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 60, "dur": 10, "pid": 0, "tid": 7},
    ]
    ours = [
        {"ph": "X", "cat": "user_annotation", "name": "nar.serve.collate", "ts": 1, "dur": 8,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "nar.serve.wait", "ts": 72, "dur": 20,
         "pid": 1, "tid": 1},
    ]
    before, after = trace.read(ev), trace.read(ev + ours)
    for field in ("window_s", "busy_s", "device_ops", "kernels"):
        assert getattr(after, field) == getattr(before, field), field
    assert sum(s for _, s in after.idle_gaps) == pytest.approx(
        sum(s for _, s in before.idle_gaps))
    gaps = dict(after.idle_gaps)
    # the Python the host ran now names the program's span open there
    assert gaps["recommend:nar.serve.collate"] == pytest.approx(10e-6)  # [0, 10]
    assert gaps["recommend:nar.serve.wait"] == pytest.approx(30e-6)  # [70, 100]
    assert gaps["recommend:aten::item"] == pytest.approx(25e-6)

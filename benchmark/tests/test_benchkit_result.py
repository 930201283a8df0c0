"""The result line's form, and the check for JAX by whole module names."""
import json
import sys

import torch

import tiny
import run as bench_run
from benchkit import common, spec, trace


def test_last_line_form(tmp_path):
    bench = spec.benchmark()
    for wl, tr in (("g1.serve", False), ("g1.eval", True)):
        run = tiny.tiny_run(wl, 31, tmp_path)
        run.trace = tr
        run.device = "NVIDIA H100 80GB HBM3"
        bench_run.execute(run, torch.device("cpu"))
        line = json.loads(bench_run.report(run, spec.cell(wl, bench), bench, run.device, 1))
        keys = list(line)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert keys[-1] == "checks"
        assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        cell = spec.cell(wl, bench)
        wanted = cell.per_layer if tr else cell.end_to_end
        names = {m["name"] for m in wanted}
        assert set(line["metrics"]) <= names
        if not tr:
            assert set(line["metrics"]) == names
        else:
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}


def test_forbidden_modules_by_whole_name(monkeypatch):
    fake = {"chameleon_recsys_tpu_torch": object(), "chameleon_recsys_tpu_torch.serve": object(),
            "jaxtyping": object(), "flaxen": object()}
    monkeypatch.setattr(sys, "modules", dict(sys.modules, **fake))
    assert common.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(sys.modules, **{"chameleon_recsys_tpu.config": 1,
                                                              "jaxlib.xla": 1}))
    assert common.forbidden_modules() == ["chameleon_recsys_tpu", "jaxlib"]


def test_trace_reader_on_known_events():
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
    t = trace.read(ev)
    assert abs(t.window_s - 100e-6) < 1e-12
    assert abs(t.busy_s - 35e-6) < 1e-12  # [10, 35] and [60, 70]
    assert t.device_ops[0][0] == "k1" and abs(t.device_ops[0][1] - 30e-6) < 1e-12
    gaps = dict(t.idle_gaps)
    assert abs(gaps["recommend:aten::item"] - 25e-6) < 1e-12  # [35, 60]
    assert abs(gaps["recommend:python"] - 40e-6) < 1e-12  # [0, 10] and [70, 100]

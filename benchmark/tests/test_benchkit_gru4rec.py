"""``gru4rec.train`` on the CPU: the cell's driver (``neural_train_hours``)
end to end at a tiny size, correct; each fault ``faults_gru4rec.py`` plants
under its timed path, and the control (the reference in bfloat16 or float8
in the system's place), not correct; its readers on canned traces and a
stubbed registry; its operation and byte counts."""
import copy
import sys
import types

import pytest
import torch

import tiny
import faults_gru4rec
import run as bench_run
from benchkit import drivers, gru4rec_work, span_trace, spans, spec, trace
from benchkit.common import Run

SEED = 2 ** 31 + 404


def _config(n_items=500, layers=(32,), n_sample=20, batch=8, length=6):
    cell = spec.cell("gru4rec.train")
    cfg = copy.deepcopy(cell.config)
    cfg["num_items"] = 300
    cfg["ace_dim"] = 12
    for rows in (cfg["article_features"], cfg["session_sequence"]):
        for r in rows:
            if r[0] in ("article_id", "item_clicked"):
                r[2] = 300
    cfg["gru4rec"].update(n_items=n_items, layers=list(layers), n_sample=n_sample,
                          batch_size=batch, truncate_session_length=length,
                          neg_pool_capacity=400, recent_clicks_buffer_max_size=400)
    mix = dict(cell.traffic, sessions_per_hour=4 * batch, distinct_hours=3)
    mix["session_length"] = dict(mix["session_length"], max=length)
    return cell, cfg, mix


def _run(tmp_path, seconds=0.3, **kw):
    cell, cfg, mix = _config(**kw)
    run = Run("gru4rec.train", SEED, seconds, False, "cpu", cfg, mix, dict(cell.limits),
              str(tmp_path))
    state = bench_run.execute(run, torch.device("cpu"))
    return run, state


def _failed(run):
    return [k for k, c in run.checks.items() if not c.ok]


def test_a_sound_run_is_correct(tmp_path):
    run, _ = _run(tmp_path)
    assert not _failed(run), run.checks
    assert set(run.checks) == {"score_gap", "grad_gap", "change_gap", "row_faults",
                               "negative_faults"}
    assert run.e2e["train_sessions_per_s"] > 0 and run.work["steps"] == run.attempted


@pytest.mark.parametrize("fault, caught", [
    ("half_batch", {"score_gap", "grad_gap"}),
    ("altered_update", {"row_faults"}),
    ("unchanged_state", {"grad_gap", "change_gap"}),
    ("outside_negatives", {"negative_faults"}),
])
def test_a_planted_fault_is_caught(fault, caught, tmp_path, monkeypatch):
    from chameleon_recsys_tpu_torch.baselines import gru4rec

    monkeypatch.setattr(gru4rec.GRU4Rec, "fit_batch", gru4rec.GRU4Rec.fit_batch)
    monkeypatch.setattr(gru4rec.ReferenceOptimizer, "step", gru4rec.ReferenceOptimizer.step)
    faults_gru4rec.plant(fault)
    run, _ = _run(tmp_path)
    assert caught <= set(_failed(run)), run.checks


@pytest.mark.parametrize("precision", ["bf16", "fp8"])
def test_control_fails(precision, tmp_path):
    """At the configuration's widths (a GRU of 300, 200 negatives) with few
    item rows and sessions, the system passes every number and the
    reference in a lower precision in its place fails one."""
    run, state = _run(tmp_path, n_items=4000, layers=(300,), n_sample=200, batch=16, length=20)
    drv = drivers.driver(run.traffic["driver"])
    ctrl = drv.reference_outputs(run, state, torch.device("cpu"), precision)
    numbers = drv.numbers(run, state, drv.as_system(run, state, ctrl), state["reference"])
    assert all(c.ok for c in run.checks.values()), run.checks
    assert any(v > run.limits[k] for k, v in numbers.items()), numbers


# -- readers -------------------------------------------------------------------

def _registry(monkeypatch, snapshot, counters=None):
    module = types.ModuleType(spans.REGISTRY)
    module.span_snapshot = lambda: dict(snapshot)
    if counters is not None:
        module.counter_snapshot = lambda: {k: dict(v) for k, v in counters.items()}
    monkeypatch.setitem(sys.modules, spans.REGISTRY, module)


@pytest.fixture
def traced(tmp_path):
    cell = spec.cell("gru4rec.train")
    run = Run("gru4rec.train", 5, 20.0, True, "NVIDIA H100 80GB HBM3", cell.config,
              cell.traffic, dict(cell.limits), str(tmp_path))
    run.window_s = 20.0
    run.trace_summary = trace.Trace(2.0, 1.2, [], [])
    run.work = {"steps": 800, "model_flops": 800 * 5.0e9,
                "trace": {"steps": 44, "model_flops": 44 * 5.0e9, "update_s": 0.4}}
    return run


def test_update_roofline_reads_the_counter_and_the_update_kernels(monkeypatch, traced):
    read = spec.metric_reader("gru4rec_update_roofline.train")
    _registry(monkeypatch, {"gru4rec.update": (0.01, 44)})
    assert read(traced) is None  # a system without the counter
    touched = {"steps": 44, "wx": 44 * 300.0, "wy": 44 * 2800.0}
    _registry(monkeypatch, {"gru4rec.update": (0.01, 44)}, {"gru4rec.rows_touched": touched})
    need = 5 * 4 * (44 * 300 * 900 + 44 * 2800 * 301 + 44 * (300 * 300 + 300 * 600 + 900))
    assert read(traced) == pytest.approx(100 * need / 3.35e12 / 0.4)
    traced.work["trace"]["update_s"] = 0.0
    assert read(traced) is None


def test_span_readers(monkeypatch, traced):
    _registry(monkeypatch, {"neural.collate": (0.22, 44), "neural.step": (0.088, 44),
                            "neural.wait": (0.5, 2), "nar.train_step.sync": (0.1, 22)})
    assert spec.metric_reader("collate_ms.gru4rec")(traced) == pytest.approx(5.0)
    assert spec.metric_reader("gru4rec_step_ms.train")(traced) == pytest.approx(2.0)
    assert spec.metric_reader("host_wait_share.gru4rec")(traced) == pytest.approx(25.0)
    assert spec.metric_reader("grad_sync_share.dp4")(traced) == pytest.approx(5.0)
    _registry(monkeypatch, {})
    for name in ("collate_ms.gru4rec", "gru4rec_step_ms.train", "host_wait_share.gru4rec",
                 "grad_sync_share.dp4"):
        assert spec.metric_reader(name)(traced) is None, name


def test_mfu_at_the_float32_peak(traced):
    assert spec.metric_reader("gru4rec_mfu")(traced) == pytest.approx(
        100 * 800 * 5.0e9 / 20.0 / 67e12)


def test_device_seconds_under_a_span():
    """A kernel counts under the span in which its launch started, on any
    thread; one launched outside every such span counts nowhere."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "gru4rec.update", "ts": 100, "dur": 50,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 2,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 160, "dur": 2,
         "tid": 2, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "adagrad", "ts": 200, "dur": 30,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 240, "dur": 40,
         "args": {"correlation": 8}},
    ]
    assert span_trace.device_seconds_under(events, ["gru4rec.update", "neural.step"]) == {
        "gru4rec.update": pytest.approx(30e-6), "neural.step": 0.0}


def test_step_flops_and_update_bytes_at_the_cell():
    """G1's cell: a 20-clicks truncation gives 19 steps; 128 sessions
    against 128 + 200 candidates; the update's dense leaves are wh, wrz
    and bh."""
    fwd = 2 * 128 * 19 * (300 * 600 + 300 * 300) + 2 * 128 * 19 * 328 * 300
    assert gru4rec_work.forward_flops([300], 128, 19, 200) == fwd
    assert gru4rec_work.step_flops([300], 128, 19, 200) == 3 * fwd
    assert gru4rec_work.dense_elements([300]) == 300 * 300 + 300 * 600 + 900
    assert gru4rec_work.dense_elements([300, 100]) == (
        300 * 300 + 300 * 600 + 900 + 100 * 100 + 100 * 200 + 300 + 300 * 300)
    assert gru4rec_work.update_bytes([300], 2, 10, 20) == 20 * (
        10 * 900 + 20 * 301 + 2 * (300 * 300 + 300 * 600 + 900))

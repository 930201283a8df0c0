"""The program's spans (``chameleon_recsys_tpu_torch/utils/profiling.py``:
``span``, ``spanned``, the registry) in the train hour, the eval hour and
``recommend``, and the reader of them in a Chrome trace (``span_breakdown``).

A tiny harness of the synthetic example (``cli/train_nar_synthetic.py``:
60 items, batch 8, three classical baselines) and a server on its weights
run on the CPU.  With tracing off the registry stays empty and no profiler
range is opened; with it on, each span counts once a batch or a call as
placed, a parent's children never sum past it, the eval hour's phase
timers are its spans, and under a profiler the spans are ``user_annotation``
events nested as placed.  The reader is pinned on hand-made events: spans,
launches correlated with their kernels (one from another thread, as the
autograd engine launches the backward), and idle gaps split among spans.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from chameleon_recsys_tpu_torch.cli import train_nar_synthetic
from chameleon_recsys_tpu_torch.serve import NARServer
from chameleon_recsys_tpu_torch.utils import profiling

SESSIONS = 20  # an hour: batches of 8, 8 and 4
BATCHES = 3
TRAIN_CHILDREN = ("sample", "forward", "backward", "optimizer", "stream")
EVAL_SPANS = ("nar.collate", "nar.eval.setup", "nar.eval.dispatch", "nar.eval.wait",
              "nar.eval.metrics", "nar.eval.baselines", "nar.host_tier", "nar.eval.results")
SERVE_SPANS = ("nar.serve.candidates", "nar.serve.collate", "nar.serve.score",
               "nar.serve.wait")


@pytest.fixture(scope="module")
def world():
    args = train_nar_synthetic.create_args_parser().parse_args(
        ["--num_items", "60", "--batch_size", "8", "--car_size", "16", "--rnn_units", "8",
         "--sessions_per_hour", str(SESSIONS), "--platform", "cpu"])
    harness, hour_source = train_nar_synthetic.build(
        args, "cpu", {"matching_layer_sizes": (16, 8, 8), "max_session_length": 6})
    harness.train_hour(hour_source(0))
    server = NARServer(harness.cfg, harness.session_schema, harness.article_schema,
                       harness.state.model.state_dict(), harness.state.stream,
                       harness.ace_matrix_np, {k: v.numpy() for k, v in harness.metadata.items()},
                       device="cpu")
    yield harness, hour_source, server
    shutil.rmtree(harness.run_cfg.model_dir, ignore_errors=True)


@pytest.fixture
def tracing():
    """Tracing on, the registry empty; both as they were afterwards."""
    was = profiling.set_tracing(True)
    saved = profiling.span_snapshot()
    profiling.reset_spans()
    yield
    profiling.set_tracing(was)
    profiling.reset_spans()
    profiling._spans.update({k: list(v) for k, v in saved.items()})


def _recommend(server, hour_source):
    return server.recommend(hour_source(5)[:4], top_k=3, num_candidates=12)


def test_tracing_off_leaves_the_registry_empty_and_opens_no_range(world, monkeypatch):
    harness, hour_source, server = world
    profiling.set_tracing(False)
    profiling.reset_spans()
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: opened.append(name))
    assert profiling.span("nar.a") is profiling.span("nar.b")  # the shared no-op
    harness.train_hour(hour_source(1))
    harness.evaluate_hour(hour_source(2))
    _recommend(server, hour_source)
    assert profiling.span_snapshot() == {}
    assert opened == []


def test_train_hour_spans_one_a_batch(world, tracing):
    harness, hour_source, _ = world
    harness.train_hour(hour_source(1))
    spans = profiling.span_snapshot()
    for name in ("nar.collate", "nar.put_batch", "nar.train_step", "nar.host_tier"):
        assert spans[name][1] == BATCHES, name
    assert spans["nar.train.wait"][1] == 1
    children = [spans[f"nar.train_step.{c}"] for c in TRAIN_CHILDREN]
    assert [c[1] for c in children] == [BATCHES] * len(TRAIN_CHILDREN)
    assert sum(c[0] for c in children) <= spans["nar.train_step"][0]


def test_recommend_gives_one_call_of_each_serving_span(world, tracing):
    _, hour_source, server = world
    ids, _ = _recommend(server, hour_source)
    assert ids.shape == (4, 3)
    spans = profiling.span_snapshot()
    assert {k: v[1] for k, v in spans.items()} == {k: 1 for k in SERVE_SPANS}


def test_eval_phases_are_its_spans_with_tracing_on_or_off(world):
    harness, hour_source, _ = world
    was = profiling.set_tracing(False)
    try:
        row_off = harness.evaluate_hour(hour_source(2))
        phases_off = dict(harness.last_eval_phase_seconds)
        profiling.set_tracing(True)
        profiling.reset_spans()
        row_on = harness.evaluate_hour(hour_source(2))
        phases_on = dict(harness.last_eval_phase_seconds)
        spans = profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()
    keys = ["device", "chameleon_metrics", "benchmarks", "cold_start", "host_state"]
    assert list(phases_off) == keys and list(phases_on) == keys
    assert row_on["hitrate_at_n"] == row_off["hitrate_at_n"]
    assert phases_off["device"] > 0 and phases_off["chameleon_metrics"] > 0
    assert set(EVAL_SPANS) <= set(spans)
    assert spans["nar.collate"][1] == BATCHES
    assert spans["nar.eval.dispatch"][1] == spans["nar.eval.wait"][1] == BATCHES
    assert spans["nar.eval.setup"][1] == spans["nar.eval.results"][1] == 1
    assert phases_on["device"] == pytest.approx(
        spans["nar.eval.dispatch"][0] + spans["nar.eval.wait"][0], rel=1e-9)
    assert phases_on["chameleon_metrics"] == pytest.approx(spans["nar.eval.metrics"][0],
                                                           rel=1e-9)
    assert phases_on["benchmarks"] == pytest.approx(spans["nar.eval.baselines"][0], rel=1e-9)
    # the host tier: the clicks' registration (not a phase) and the host state
    assert spans["nar.host_tier"][1] == 2 * BATCHES
    assert phases_on["host_state"] < spans["nar.host_tier"][0]


def _within(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_a_profiler_sees_the_spans_nested_as_placed(world, tmp_path):
    harness, hour_source, server = world
    was = profiling.set_tracing(False)
    profiling.reset_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            harness.train_hour(hour_source(1))
            _recommend(server, hour_source)
        spans = profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith("nar.")]
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    # a running profiler turns tracing on: the registry counts what it saw,
    # but for the hour's last pull of a batch, which it times and does not
    # count
    counted = {k: v[1] for k, v in spans.items()}
    counted["nar.collate"] += 1
    assert {k: len(v) for k, v in by.items()} == counted
    assert len(by["nar.train_step"]) == BATCHES
    for child in TRAIN_CHILDREN:
        for e in by[f"nar.train_step.{child}"]:
            assert any(_within(e, p) for p in by["nar.train_step"])
    flat = [e for name in ("nar.collate", "nar.put_batch", "nar.train_step", "nar.host_tier",
                           "nar.train.wait") + SERVE_SPANS for e in by[name]]
    for e in flat:  # the harness's and the server's own spans do not nest
        assert not any(_within(e, o) for o in flat if o is not e)
    read = profiling.span_breakdown(events)
    assert {k: v[1] for k, v in read.spans.items()} == {k: len(v) for k, v in by.items()}
    assert read.spans["nar.train_step"][0] == pytest.approx(
        sum(e["dur"] for e in by["nar.train_step"]) / 1e6)


def test_torch_trace_turns_tracing_on_in_its_block(world, tmp_path):
    _, hour_source, server = world
    profiling.reset_spans()
    try:
        with profiling.torch_trace(str(tmp_path)):
            assert profiling._tracing
            _recommend(server, hour_source)
        assert not profiling._tracing
        assert {k: v[1] for k, v in profiling.span_snapshot().items()} == {
            k: 1 for k in SERVE_SPANS}
    finally:
        profiling.reset_spans()
    read = profiling.span_breakdown(profiling.trace_events(str(tmp_path)))
    assert {k: v[1] for k, v in read.spans.items()} == {k: 1 for k in SERVE_SPANS}


def test_spanned_counts_the_items_not_the_last_pull(tracing):
    assert list(profiling.spanned("nar.x", iter(range(4)))) == [0, 1, 2, 3]
    assert list(profiling.spanned("nar.y", [])) == []
    spans = profiling.span_snapshot()
    assert spans["nar.x"][1] == 4 and spans["nar.y"][1] == 0
    assert spans["nar.x"][0] >= 0.0


def test_a_timer_span_times_with_tracing_off():
    was = profiling.set_tracing(False)
    profiling.reset_spans()
    try:
        acc = {"a": 0.0}
        with profiling.span("nar.t", acc, "a"):
            sum(range(1000))
        assert acc["a"] > 0 and profiling.span_snapshot() == {}
    finally:
        profiling.set_tracing(was)


def _x(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def test_span_breakdown_on_known_events():
    ev = [
        _x("user_annotation", "nar.collate", 0, 10),
        _x("user_annotation", "nar.train_step", 10, 60),
        _x("user_annotation", "nar.train_step.forward", 12, 18),
        _x("user_annotation", "nar.train_step.backward", 30, 30),
        _x("user_annotation", "nar.train.wait", 75, 20),
        _x("user_annotation", "bench.window", 0, 100),  # another prefix: not read
        _x("cpu_op", "aten::mm", 14, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 14, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
        # the autograd engine's thread launches the backward
        _x("cuda_runtime", "cudaLaunchKernel", 32, 1, tid=9, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 76, 1, correlation=4),
        _x("cuda_runtime", "cudaStreamSynchronize", 77, 10),
        _x("kernel", "k_fwd", 15, 10, tid=7, correlation=1),
        _x("kernel", "k_fwd2", 25, 5, tid=7, correlation=2),
        _x("kernel", "k_bwd", 40, 30, tid=7, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 80, 5, tid=7, correlation=4),
        _x("gpu_user_annotation", "nar.train_step", 15, 55, tid=7),  # device side: not work
    ]
    r = profiling.span_breakdown(ev, start=0, end=100)
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx(50e-6)  # [15, 30], [40, 70], [80, 85]
    assert {k: v[1] for k, v in r.spans.items()} == {
        "nar.collate": 1, "nar.train_step": 1, "nar.train_step.forward": 1,
        "nar.train_step.backward": 1, "nar.train.wait": 1}
    assert r.spans["nar.train_step"][0] == pytest.approx(60e-6)
    assert set(r.launched) == {"nar.train_step.forward", "nar.train_step.backward",
                               "nar.train.wait"}
    assert r.launched["nar.train_step.forward"][0] == 2
    assert r.launched["nar.train_step.forward"][1] == pytest.approx(15e-6)
    assert r.launched["nar.train_step.backward"] == (1, pytest.approx(30e-6))
    assert r.launched["nar.train.wait"] == (1, pytest.approx(5e-6))
    # gaps [0, 15], [30, 40], [70, 80], [85, 100], split among the spans
    # open over them: none over [70, 75] and [95, 100]
    want = {"nar.collate": 10e-6, "nar.train_step": 2e-6, "nar.train_step.forward": 3e-6,
            "nar.train_step.backward": 10e-6, "nar.train.wait": 15e-6, "none": 10e-6}
    assert set(r.idle_by_span) == set(want)
    for k, v in want.items():
        assert r.idle_by_span[k] == pytest.approx(v), k
    assert sum(r.idle_by_span.values()) == pytest.approx(r.window_s - r.busy_s)


def test_span_breakdown_defaults_to_the_spans_stretch():
    ev = [_x("user_annotation", "nar.serve.score", 10, 20),
          _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=5),
          _x("kernel", "k", 14, 6, tid=7, correlation=5),
          _x("kernel", "outside", 40, 6, tid=7)]
    r = profiling.span_breakdown(ev)
    assert r.window_s == pytest.approx(20e-6) and r.busy_s == pytest.approx(6e-6)
    assert r.launched == {"nar.serve.score": (1, pytest.approx(6e-6))}
    assert r.idle_by_span == {"nar.serve.score": pytest.approx(14e-6)}
    assert np.isclose(sum(r.idle_by_span.values()), r.window_s - r.busy_s)

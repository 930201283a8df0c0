"""The reader of ``train_graph_share`` against a stubbed span registry: it
reads nothing where the system has neither graph span, and the replays'
share of the train steps where it has."""
import sys
import types

import pytest

import tiny
from benchkit import spans, spec, trace

READ = spec.metric_reader("train_graph_share")


def _registry(monkeypatch, snapshot):
    module = types.ModuleType(spans.REGISTRY)
    module.span_snapshot = lambda: dict(snapshot)
    monkeypatch.setitem(sys.modules, spans.REGISTRY, module)


@pytest.fixture
def run(tmp_path):
    run = tiny.tiny_run("g1.train", 5, tmp_path)
    run.trace_summary = trace.Trace(1.0, 0.5, [], [])
    return run


def test_nothing_without_the_graph_spans(monkeypatch, run):
    _registry(monkeypatch, {"nar.train_step": (0.5, 22), "nar.train_step.forward": (0.2, 22),
                            "nar.train.wait": (0.01, 2)})
    assert READ(run) is None
    monkeypatch.setitem(sys.modules, spans.REGISTRY, types.ModuleType(spans.REGISTRY))
    assert READ(run) is None


@pytest.mark.parametrize("captures, replays, share", [(0, 22, 100.0), (1, 21, 21 / 22 * 100),
                                                      (1, 0, 0.0)])
def test_the_replays_share_of_the_train_steps(monkeypatch, run, captures, replays, share):
    snap = {"nar.train_step": (0.5, 22), "nar.train_step.replay": (0.02, replays),
            "nar.train_step.capture": (0.05, captures)}
    _registry(monkeypatch, {k: v for k, v in snap.items() if v[1]})
    assert READ(run) == pytest.approx(share)


def test_nothing_outside_a_traced_run(monkeypatch, run):
    _registry(monkeypatch, {"nar.train_step": (0.5, 22), "nar.train_step.replay": (0.02, 22)})
    run.trace_summary = None
    assert READ(run) is None

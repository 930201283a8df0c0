"""The reader of ``eval_metrics_device_share`` against a stubbed span
registry: it reads nothing where the system has no fold span, and the
folded batches' share of the metric tier's batches where it has."""
import sys
import types

import pytest

import tiny
from benchkit import spans, spec, trace

READ = spec.metric_reader("eval_metrics_device_share")


def _registry(monkeypatch, snapshot):
    module = types.ModuleType(spans.REGISTRY)
    module.span_snapshot = lambda: dict(snapshot)
    monkeypatch.setitem(sys.modules, spans.REGISTRY, module)


@pytest.fixture
def run(tmp_path):
    run = tiny.tiny_run("g1.eval", 5, tmp_path)
    run.trace_summary = trace.Trace(1.0, 0.5, [], [])
    return run


def test_nothing_without_the_fold_span(monkeypatch, run):
    _registry(monkeypatch, {"nar.eval.metrics": (0.1, 22), "nar.eval.dispatch": (0.04, 22)})
    assert READ(run) is None
    monkeypatch.setitem(sys.modules, spans.REGISTRY, types.ModuleType(spans.REGISTRY))
    assert READ(run) is None


@pytest.mark.parametrize("folded, share", [(22, 100.0), (11, 50.0)])
def test_the_folded_share_of_the_metric_tier_batches(monkeypatch, run, folded, share):
    _registry(monkeypatch, {"nar.eval.metrics": (0.1, 22),
                            "nar.eval.metrics.device": (0.01, folded)})
    assert READ(run) == pytest.approx(share)


def test_nothing_outside_a_traced_run(monkeypatch, run):
    _registry(monkeypatch, {"nar.eval.metrics": (0.1, 22),
                            "nar.eval.metrics.device": (0.01, 22)})
    run.trace_summary = None
    assert READ(run) is None

"""A run with its timed path broken underneath, the look for a card
skipped, comes out not correct: for each fault the cell can have, and for
the control (the reference in float8 in the system's place)."""
import pytest
import torch

import tiny
import run as bench_run
from benchkit import drivers
from chameleon_recsys_tpu_torch.serve import NARServer
from chameleon_recsys_tpu_torch.train import temporal


def _run(workload, tmp_path, seed=2 ** 31 + 404):
    run = tiny.tiny_run(workload, seed, tmp_path)
    bench_run.execute(run, torch.device("cpu"))
    return run


def _failed(run):
    return [k for k, c in run.checks.items() if not c.ok]


def test_sound_runs_are_correct(tmp_path):
    for wl in ("g1.train", "g1.serve", "g1.eval"):
        assert not _failed(_run(wl, tmp_path)), wl


def test_train_step_leaving_the_state_unchanged(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert {"grad_gap", "change_gap"} <= set(_failed(_run("g1.train", tmp_path)))


def test_scored_rows_in_another_order(tmp_path, monkeypatch):
    """Which padding rows the train step scores, and the order of all its
    rows, are the system's own: a step that scores them reversed is
    correct."""
    from chameleon_recsys_tpu_torch.train import steps

    original = steps.compact_valid_rows

    def reversed_rows(*a, **k):
        rows = original(*a, **k)
        return rows._replace(rows_sel=rows.rows_sel.flip(0), row_mask=rows.row_mask.flip(0),
                             row_click=rows.row_click.flip(0))

    monkeypatch.setattr(steps, "compact_valid_rows", reversed_rows)
    run = _run("g1.train", tmp_path)
    assert not _failed(run), run.checks


def test_train_step_on_half_the_batch(tmp_path, monkeypatch):
    original = temporal.train_step

    def half(state, batch, *a, **k):
        batch = dict(batch)
        size = batch["session_size"].clone()
        size[size.shape[0] // 2:] = 0
        batch["session_size"] = size
        return original(state, batch, *a, **k)

    monkeypatch.setattr(temporal, "train_step", half)
    assert "row_faults" in _failed(_run("g1.train", tmp_path))


def test_train_update_altered(tmp_path, monkeypatch):
    original = temporal.train_step

    def altered(state, *a, **k):
        state, metrics = original(state, *a, **k)
        with torch.no_grad():
            state.model.CAR_kernel.add_(1e-3)
        return state, metrics

    monkeypatch.setattr(temporal, "train_step", altered)
    assert "change_gap" in _failed(_run("g1.train", tmp_path))


def test_served_answer_altered(tmp_path, monkeypatch):
    original = NARServer.recommend

    def swapped(self, *a, **k):
        ids, scores = original(self, *a, **k)
        return ids[:, ::-1].copy(), scores

    monkeypatch.setattr(NARServer, "recommend", swapped)
    assert _failed(_run("g1.serve", tmp_path))


def test_eval_answer_altered(tmp_path, monkeypatch):
    original = temporal.eval_step

    def reranked(*a, **k):
        stream, metrics, fetches = original(*a, **k)
        fetches = dict(fetches)
        fetches["predicted_ids"] = fetches["predicted_ids"].flip(-1)
        return stream, metrics, fetches

    monkeypatch.setattr(temporal, "eval_step", reranked)
    assert _failed(_run("g1.eval", tmp_path))


def test_eval_on_half_the_batch(tmp_path, monkeypatch):
    original = temporal.eval_step

    def half(model, stream, batch, *a, **k):
        batch = dict(batch)
        size = batch["session_size"].clone()
        size[size.shape[0] // 2:] = 0
        batch["session_size"] = size
        return original(model, stream, batch, *a, **k)

    monkeypatch.setattr(temporal, "eval_step", half)
    assert _failed(_run("g1.eval", tmp_path))


@pytest.mark.parametrize("workload", ["g1.train", "g1.serve", "adressa.serve", "g1.eval"])
def test_control_fails(workload, tmp_path):
    """The reference computed in float8 (per-tensor scale) in the system's
    place fails one of the cell's numbers, at the configuration's widths
    with few sessions (the readings at the cell's own size are PERF.md's),
    where the system's bfloat16 path passes them all."""
    run = tiny.small_run(workload, 2 ** 31 + 505, tmp_path)
    drv = drivers.driver(run.traffic["driver"])
    state = bench_run.execute(run, torch.device("cpu"), drv)
    ctrl = drv.reference_outputs(run, state, torch.device("cpu"), "fp8")
    numbers = drv.numbers(run, state, drv.as_system(run, state, ctrl), state["reference"])
    assert all(c.ok for c in run.checks.values()), run.checks
    assert any(v > run.limits[k] for k, v in numbers.items()), numbers

"""The port's GRU4Rec (``baselines/gru4rec.py``) against the benchmark's
plain reference (``benchmark/reference/gru4rec.py``, written from the
published model, importing nothing of the port), on the CPU at a small
size: 500 items, one GRU layer of 32, 20 shared negatives, batch 8, 6
steps a session, seeded random weights.

For each of the five losses: the scores, the loss and every gradient of a
step, and the parameters and Adagrad's accumulators after 3 steps given the
same negatives (the port's draws replaced through
``_draw_negative_indices``), float32 to 1e-5 of each tensor's norm (the same
arithmetic summed in another order); every row of the item tables (``wx.0``,
``wy``, ``by``) outside the steps' inputs, labels and negatives left
bit-unchanged, its accumulator exactly 0.  Then the step's counter of
touched rows, and the runner's and the step's spans under tracing.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chameleon_recsys_tpu_torch.baselines import gru4rec
from chameleon_recsys_tpu_torch.baselines.neural_runner import NeuralBaselineRunner
from chameleon_recsys_tpu_torch.cli.run_gru4rec import minimal_session_schema
from chameleon_recsys_tpu_torch.config import NARConfig
from chameleon_recsys_tpu_torch.data.collate import Session
from chameleon_recsys_tpu_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from reference import gru4rec as ref  # noqa: E402

N_ITEMS, UNITS, N_SAMPLE, B, T, STEPS = 500, 32, 20, 8, 6, 3
TOL = 1e-5
LOSSES = ["bpr-max", "cross-entropy", "bpr", "top1", "top1-max"]


def _config(loss):
    return {"gru4rec": {
        "n_items": N_ITEMS, "layers": [UNITS], "loss": loss, "bpreg": 0.5,
        "n_sample": N_SAMPLE, "learning_rate": 0.05, "adagrad_eps": 1e-6, "batch_size": B,
        "truncate_session_length": T + 1, "neg_pool_capacity": 400,
        "recent_clicks_buffer_max_size": 400, "recent_clicks_buffer_hours": 1.0}}


def _weights(model, seed=0):
    """Every parameter drawn, the biases too, so that each gradient counts."""
    g = torch.Generator().manual_seed(seed)
    return {name: torch.randn(shape, generator=g) * (0.3 if kind == "zeros" else 0.5)
            for name, shape, kind in model.param_shapes()}


def _batches(seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        lengths = rng.randint(1, T + 1, size=B)
        live = np.arange(T)[None, :] < lengths[:, None]
        items = np.where(live, rng.randint(1, 300, size=(B, T)), 0)
        labels = np.where(live, rng.randint(1, 300, size=(B, T)), 0)
        buffer = rng.randint(1, 300, size=350)
        picks = rng.randint(0, len(buffer), size=N_SAMPLE)
        out.append((items, labels, buffer, picks))
    return out


def _port(loss, w):
    model = gru4rec.GRU4Rec(N_ITEMS, layers=(UNITS,), loss=loss, bpreg=0.5, n_sample=N_SAMPLE,
                            neg_pool_capacity=400, device="cpu")
    model.params.load_state_dict(w)
    return model


def _close(a, b, name):
    assert (a - b).norm() <= TOL * b.norm() + 1e-7, name


@pytest.mark.parametrize("loss", LOSSES)
def test_a_step_is_the_reference_step(loss, monkeypatch):
    model_ref = ref.Model(_config(loss))
    w = _weights(model_ref)
    port = _port(loss, w)
    items, labels, buffer, picks = _batches()[0]
    negs = torch.from_numpy(buffer[picks])
    seen = {}
    original = gru4rec.LOSSES[loss]

    def scored(scores, *a):
        seen["scores"] = scores.detach()
        return original(scores, *a)

    monkeypatch.setitem(gru4rec.LOSSES, loss, scored)
    it, lb = torch.from_numpy(items), torch.from_numpy(labels)
    p_loss = port.loss_for_batch(it, lb, lb != 0, negs)
    named = dict(port.params.named_parameters())
    p_grads = dict(zip(named, torch.autograd.grad(p_loss, list(named.values()))))
    params = {n: p.clone().requires_grad_(True) for n, p in w.items()}
    r_loss, r_scores = ref.loss_and_scores(model_ref, params, it, lb, negs, ref.Precision())
    r_grads = dict(zip(params, torch.autograd.grad(r_loss, list(params.values()))))
    live = (lb != 0).T
    cols = torch.cat([live, live.new_ones((T, N_SAMPLE))], 1)
    mask = live[:, :, None] & cols[:, None, :]
    _close(seen["scores"][mask], r_scores[mask], "scores")
    assert float(p_loss.detach()) == pytest.approx(float(r_loss.detach()), rel=TOL)
    assert set(p_grads) == set(r_grads)
    for name, r in r_grads.items():
        _close(p_grads[name], r, name)


@pytest.mark.parametrize("loss", LOSSES)
def test_three_steps_are_the_reference_steps(loss, monkeypatch):
    """The port's dense Adagrad over every row against the reference's
    update of the addressed rows: the same parameters and accumulators,
    and every row outside the addressed ones untouched to the bit."""
    model_ref = ref.Model(_config(loss))
    w = _weights(model_ref)
    port = _port(loss, w)
    batches = _batches()
    draws = [torch.from_numpy(p) for _, _, _, p in batches]
    monkeypatch.setattr(gru4rec, "_draw_negative_indices", lambda n, n_valid, g: draws.pop(0))
    for items, labels, buffer, _ in batches:
        port.fit_batch(items, labels, buffer)
    ref_batches = [{"items": torch.from_numpy(i), "labels": torch.from_numpy(l)}
                   for i, l, _, _ in batches]
    negs = [torch.from_numpy(buf[p]) for _, _, buf, p in batches]
    _, _, _, r_params = ref.train_steps(model_ref, w, ref_batches, negs, ref.Precision())
    p_params = dict(port.params.named_parameters())
    for name, r in r_params.items():
        _close(p_params[name].detach(), r, name)
    hit = torch.zeros(N_ITEMS, dtype=torch.bool)
    for b, n in zip(ref_batches, negs):
        hit |= ref.touched(b["items"], b["labels"], n, N_ITEMS)
    for name in ref.Model.TABLES:
        p = p_params[name].detach()
        acc = port.optimizer.state[p_params[name]]["acc"]
        assert torch.equal(p[~hit].view(torch.int32), w[name][~hit].view(torch.int32)), name
        assert not acc[~hit].any(), name
        assert acc[hit].any(), name


def test_rows_touched_counts_the_rows_with_a_gradient():
    model_ref = ref.Model(_config("bpr-max"))
    port = _port("bpr-max", _weights(model_ref))
    items, labels, buffer, picks = _batches()[0]
    it, lb = torch.from_numpy(items), torch.from_numpy(labels)
    negs = torch.from_numpy(buffer[picks])
    port.loss_for_batch(it, lb, lb != 0, negs).backward()
    wx, wy = gru4rec.rows_touched(port.params).tolist()
    live_items = set(items[labels != 0].tolist())
    candidates = set(labels[labels != 0].tolist()) | set(negs.tolist())
    assert wx == int((port.params.wx[0].grad != 0).any(1).sum()) == len(live_items)
    assert wy == len(candidates)


def _sessions(n, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k = int(rng.randint(2, T + 2))
        out.append(Session(session_id=i + 1, user_id=1, session_start=1000 + i,
                           item_ids=rng.randint(1, 300, size=k).tolist(),
                           timestamps=(1000 + i + np.arange(k)).tolist(), context={}))
    return out


def _runner(model):
    cfg = NARConfig(batch_size=B, max_session_length=T + 1)
    return NeuralBaselineRunner(model, cfg, minimal_session_schema(N_ITEMS), N_ITEMS,
                                lambda: [])


@pytest.fixture
def registry():
    was = profiling.set_tracing(False)
    saved = profiling.span_snapshot()
    profiling.reset_spans()
    profiling.reset_counters()
    yield
    profiling.set_tracing(was)
    profiling.reset_spans()
    profiling.reset_counters()
    profiling._spans.update({k: list(v) for k, v in saved.items()})


def test_train_hour_spans(registry):
    """Off: nothing in the registry and no count kept.  On: each batch's
    pull, step and buffer update, the step's four children, and the hour's
    one closing fetch; on the CPU the step counts no rows (the counter is
    the card's)."""
    model_ref = ref.Model(_config("bpr-max"))
    runner = _runner(_port("bpr-max", _weights(model_ref)))
    hour = _sessions(3 * B)
    runner.train_hour(hour)
    assert profiling.span_snapshot() == {} and profiling.counter_snapshot() == {}
    profiling.set_tracing(True)
    runner.train_hour(hour)
    spans = profiling.span_snapshot()
    for name in ("neural.collate", "neural.step", "neural.buffer", "gru4rec.sample",
                 "gru4rec.forward", "gru4rec.backward", "gru4rec.update"):
        assert spans[name][1] == 3, name
    assert spans["neural.wait"][1] == 1
    children = sum(spans[f"gru4rec.{c}"][0] for c in ("sample", "forward", "backward",
                                                       "update"))
    assert children <= spans["neural.step"][0]
    assert profiling.counter_snapshot() == {} and runner.model._counts is None


def test_counter_registry_adds_fields(registry):
    profiling.add_counts("gru4rec.rows_touched", steps=2, wx=10, wy=7)
    profiling.add_counts("gru4rec.rows_touched", steps=1, wx=4, wy=3)
    assert profiling.counter_snapshot() == {
        "gru4rec.rows_touched": {"steps": 3.0, "wx": 14.0, "wy": 10.0}}
    profiling.reset_counters()
    assert profiling.counter_snapshot() == {}


def test_span_breakdown_reads_the_neural_spans():
    """The trace reader takes the runner's and GRU4Rec's spans beside NAR's."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "neural.step", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "gru4rec.update", "ts": 60, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "other.span", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 70, "dur": 2,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 75, "dur": 10,
         "args": {"correlation": 1}},
    ]
    read = profiling.span_breakdown(events)
    assert set(read.spans) == {"neural.step", "gru4rec.update"}
    assert read.launched["gru4rec.update"] == (1, pytest.approx(1e-5))

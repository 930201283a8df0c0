"""Neural train hours: GRU4Rec's ``NeuralBaselineRunner.train_hour`` over
hour after hour of sessions, which the runner collates, with its click
buffer carried across hours.

Set-up makes the articles, the history hour that fills the click buffer,
the traffic hours and the weights from the seed (the articles, history and
hours are ``train_hours``' for the same seed; the configuration's
``id_rows`` map spreads the article ids over the item tables' rows), builds
the runner around them as ``cli/run_gru4rec.py`` does, and drives its
first steps through ``train_hour`` on the first batches (``check_steps``:
hours of 1 and 2 batches), recording what each step took and scored (its
inputs, labels, negatives and scores), the first gradient's norms
(from Adagrad's accumulator, which holds g^2 after a first step), the
parameters' change after step 3 and the table rows that changed outside
the rows the steps addressed.  The recording replaces the model's
``loss_for_batch`` and loss, so those steps run eagerly.  The rest of the
first hour warms up; where the system replays its step as a CUDA graph,
the graph is captured there, so the window only replays it.  The window
then trains hour after hour until ``seconds`` have passed, moving
each hour ``distinct_hours`` hours later each time it comes round; its rate
is every session it trained over all of its time.  After the window the
plain reference follows those first steps from the same weights with the
system's negatives, and checks the negatives against its own click
buffer."""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import check as ck
from .. import gru4rec_system as gsys
from .. import gru4rec_work, span_trace, traffic, weights
from ..common import process_seconds
from .common import hour_objects, no_gc, reference_module, seeds, shift

UPDATE_SPAN = "gru4rec.update"


def _mapped(s: traffic.Sessions, rows: np.ndarray) -> traffic.Sessions:
    s.items = rows[s.items]
    return s


def setup(run, device):
    cfg, mix = run.config, run.traffic
    ref = reference_module(cfg)
    t = time.perf_counter()
    model = ref.Model(cfg)
    seed_w, seed_s = seeds(run.seed)
    r_corpus, r_hist, r_hours, r_rows = traffic.rngs(run.seed, 4)
    corpus = traffic.make_corpus(cfg, r_corpus, mix["item_zipf"])
    rows = gsys.id_rows(corpus.num_items, model.n_items, r_rows)
    n = int(mix["sessions_per_hour"])
    hist = _mapped(traffic.hour_sessions(corpus, cfg, mix, r_hist, n, -1, 10 ** 9), rows)
    bs = model.batch_size
    arrays = [_mapped(traffic.hour_sessions(corpus, cfg, mix, r_hours, n, h,
                                            (h + 1) * 10 ** 7), rows)
              for h in range(int(mix["distinct_hours"]))]
    with no_gc():
        hours = [hour_objects(a) for a in arrays]
        history = hour_objects(hist)
    first, second = (int(k) for k in mix["check_steps"])
    hist_dicts = traffic.serving_sessions(hist)
    steps = [traffic.serving_sessions(arrays[0])[i * bs:(i + 1) * bs]
             for i in range(first + second)]
    del arrays
    t = run.phase("traffic", t)
    w = weights.make_weights(model, seed_w, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = run.phase("weights", t)
    runner = gsys.make_runner(cfg, w, seed_s, device)
    gsys.warm_buffer(runner, history)
    t = run.phase("system", t)

    # the first steps, through the window's own call, recorded
    records: List[dict] = []
    stop = gsys.record_steps(runner, records)
    runner.train_hour(hours[0][:first * bs])
    grad1 = ck.norms({k: a.sqrt() for k, a in gsys.accumulators(runner).items()})
    runner.train_hour(hours[0][first * bs:(first + second) * bs])
    stop()
    params, accs = gsys.parameters(runner), gsys.accumulators(runner)
    change = ck.norms({k: params[k] - w[k] for k in w})
    hit = ref.touched(records[0]["items"], records[0]["labels"], records[0]["negs"],
                      model.n_items)
    for r in records[1:]:
        hit |= ref.touched(r["items"], r["labels"], r["negs"], model.n_items)
    row_faults = 0
    for k in ref.Model.TABLES:
        moved = gsys.rows_changed(w[k], params[k]) | gsys.rows_changed(torch.zeros_like(w[k]),
                                                                       accs[k])
        row_faults += int((moved & ~hit).sum())
    del w, params, accs, hit
    runner.train_hour(hours[0][(first + second) * bs:])  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
    run.phase("first steps and warm-up", t)
    return dict(ref=ref, model=model, hours=hours, runner=runner, records=records,
                grad1=grad1, change=change, row_faults=row_faults, seed_w=seed_w,
                steps=steps, hist=hist_dicts)


def _hour(hours, h: int) -> list:
    """Hour ``h`` of the run: the ``h mod d``-th hour made, moved a further
    ``d`` hours later each time it comes round again."""
    d = len(hours)
    if h >= d:
        shift(hours[h % d], d * traffic.HOUR)
    return hours[h % d]


def _work(run, model, steps: int) -> Dict[str, float]:
    return {"steps": steps,
            "model_flops": steps * gru4rec_work.step_flops(model.layers, model.batch_size,
                                                            model.t, model.n_sample)}


def window(run, state, device):
    runner, hours, model = state["runner"], state["hours"], state["model"]
    gc.collect()
    gc.freeze()
    run.setup_s = process_seconds()
    h, sessions, steps = 1, 0, 0
    per_hour = -(-len(hours[0]) // model.batch_size)
    w0 = time.perf_counter()
    while True:
        hour = _hour(hours, h)
        runner.train_hour(hour)
        sessions += len(hour)
        steps += per_hour
        h += 1
        if time.perf_counter() - w0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - w0
    run.attempted = steps
    run.e2e["train_sessions_per_s"] = sessions / run.window_s
    run.work = _work(run, model, steps)
    if run.trace:
        n_traced = int(run.traffic["trace_hours"])

        def go():
            for i in range(n_traced):
                runner.train_hour(_hour(hours, h + i))
            return n_traced * per_hour

        run.trace_summary, under = span_trace.profile(go, run.tmpdir, device.type == "cuda",
                                                      [UPDATE_SPAN])
        run.work["trace"] = dict(_work(run, model, n_traced * per_hour),
                                 update_s=under[UPDATE_SPAN])
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def free(state):
    state.pop("runner", None)


def _replay(run, state, device):
    """The reference's batches of the first steps, and the negative faults
    of the system's draws against its own click buffer."""
    ref, model = state["ref"], state["model"]
    clicks = ref.Clicks(model)
    for i in range(0, len(state["hist"]), model.batch_size):
        clicks.add(ref.train_batch(model, state["hist"][i:i + model.batch_size]))
    batches, faults = [], 0
    for sessions, rec in zip(state["steps"], state["records"]):
        b = ref.train_batch(model, sessions)
        faults += ref.negative_faults(rec["negs"], clicks.pool(), model.n_sample)
        clicks.add(b)
        batches.append({k: torch.as_tensor(v, device=device) for k, v in b.items()})
    return batches, faults


def reference_outputs(run, state, device, precision: str = "f32"):
    """The reference through the system's first steps, with the system's
    negatives: its first step's scores, first gradient's norms and the
    norms of its parameters' change."""
    ref, model = state["ref"], state["model"]
    if "replay" not in state:
        state["replay"] = _replay(run, state, device)
    batches, _ = state["replay"]
    w0 = weights.make_weights(model, state["seed_w"], device)
    negs = [r["negs"].to(device).long() for r in state["records"]]
    _, scores, grad, params = ref.train_steps(model, w0, batches, negs,
                                              ref.Precision(precision))
    return {"scores": scores, "grad": ck.norms(grad),
            "change": ck.norms({n: params[n] - w0[n] for n in w0})}


def as_system(run, state, ref_out):
    """The reference's outputs are in the system's form already."""
    return dict(ref_out)


def system_outputs(run, state):
    return {"scores": state["records"][0]["scores"], "grad": state["grad1"],
            "change": state["change"]}


def score_gap(sys_scores, ref_scores, labels, n_sample: int) -> float:
    """Widest |score_sys - score_ref| over the (step, session) rows with a
    label and their valid candidates, over the largest such |score_ref|."""
    live = (labels != 0).T  # [T, B]
    cols = torch.cat([live, live.new_ones((live.shape[0], n_sample))], 1)  # [T, B + n]
    mask = live[:, :, None] & cols[:, None, :]
    a, b = sys_scores.to(ref_scores.device).double(), ref_scores.double()
    scale = float(b.abs()[mask].max()) if bool(mask.any()) else 1.0
    return float((a - b).abs()[mask].max()) / max(scale, 1e-30) if bool(mask.any()) else 0.0


def numbers(run, state, sys_out, ref_out) -> Dict[str, float]:
    """Not compared: the loss.  With random weights every row's bpr-max
    loss is nearly the same, so a step on half its sessions reads within
    10x of the sound runs' largest gap."""
    batches, neg_faults = state["replay"]
    model = state["model"]
    return {
        # the first step's forward, from the same weights
        "score_gap": score_gap(sys_out["scores"], ref_out["scores"], batches[0]["labels"],
                               model.n_sample),
        "grad_gap": ck.norm_gap(sys_out["grad"], ref_out["grad"]),
        "change_gap": ck.norm_gap(sys_out["change"], ref_out["change"],
                                  ck.moving_leaves(ref_out["grad"])),
        "row_faults": float(state["row_faults"]),
        "negative_faults": float(neg_faults),
    }

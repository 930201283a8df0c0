"""Train hours: ``TemporalHarness.train_hour`` over hour after hour of
sessions, which the harness collates, with the click stream carried across
hours.

Set-up makes the articles, the history hour that fills the click buffer,
the traffic hours and the weights from the seed, builds the harness around
them, and drives its first train steps through ``train_hour`` on the first
batches (``check_steps``: hours of 1 and 2 batches), recording what each
step scored (a forward hook on the model: its rows, negatives,
probabilities), Adam's first moments after step 1 and the change
of every parameter after step 3.  The rest of the first hour warms up.
The window then trains hour after hour until ``seconds`` have passed,
moving each hour ``distinct_hours`` hours later each time it comes round; its
rate is every session it trained over all of its time.  After the window
the plain reference follows those first steps from the same inputs."""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import check as ck
from .. import flops, system, trace, traffic, weights
from ..common import process_seconds
from .common import (batch_lengths, hour_objects, no_gc, ref_inputs, reference_module, seeds, shift,
                     to_device, with_stream)


def _capture(records: List[dict]):
    def hook(module, args, kwargs, out):
        rows = kwargs.get("scoring_rows")
        records.append({
            "rows": None if rows is None else rows[0].detach().clone(),
            "valid": None if rows is None else rows[1].detach().clone(),
            "negs": out.candidate_ids[..., 1:].detach().clone(),
            "probs": out.items_prob.detach().float().clone(),
        })
    return hook


def setup(run, device):
    cfg, mix = run.config, run.traffic
    ref = reference_module(cfg)
    t = time.perf_counter()
    model = ref.Model(cfg)
    seed_w, seed_s = seeds(run.seed)
    r_corpus, r_hist, r_hours = traffic.rngs(run.seed, 3)
    corpus = traffic.make_corpus(cfg, r_corpus, mix["item_zipf"])
    n = int(mix["sessions_per_hour"])
    hist = traffic.hour_sessions(corpus, cfg, mix, r_hist, n, -1, 10 ** 9)
    bs = int(cfg["nar"]["batch_size"])
    arrays = [traffic.hour_sessions(corpus, cfg, mix, r_hours, n, h, (h + 1) * 10 ** 7)
              for h in range(int(mix["distinct_hours"]))]
    with no_gc():
        hours = [hour_objects(a) for a in arrays]
    lengths = [batch_lengths(a.lengths, bs) for a in arrays]
    first, second = (int(k) for k in mix["check_steps"])
    steps = [traffic.serving_sessions(arrays[0])[i * bs:(i + 1) * bs]
             for i in range(first + second)]
    del arrays
    t = run.phase("traffic", t)
    w = weights.make_weights(model, seed_w, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = run.phase("weights", t)
    harness = system.make_harness(cfg, corpus, w, traffic.history_clicks(hist), seed_s,
                                  device, run.tmpdir)
    t = run.phase("system", t)

    # the first steps, through the window's own call, recorded
    records: List[dict] = []
    hook = harness.state.model.register_forward_hook(_capture(records), with_kwargs=True)
    harness.train_hour(hours[0][:first * bs])
    b1 = system.adam_betas(harness)[0]
    grad1 = ck.norms({n: m / (1 - b1) for n, m in system.adam_first_moments(harness).items()})
    harness.train_hour(hours[0][first * bs:(first + second) * bs])
    params = system.parameters(harness)
    change = ck.norms({n: params[n].detach() - w[n] for n in w})
    hook.remove()
    del w, params
    harness.train_hour(hours[0][(first + second) * bs:])  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
    run.phase("first steps and warm-up", t)
    return dict(ref=ref, model=model, corpus=corpus, hist=hist, hours=hours,
                lengths=lengths, harness=harness, records=records, grad1=grad1,
                change=change, seed_w=seed_w, steps=steps)


def _work(run, model, batches) -> Dict[str, float]:
    """Valid rows, scored rows and the model's operations of ``batches``,
    each given by its sessions' lengths."""
    nar = run.config["nar"]
    cap = int(nar.get("train_valid_row_capacity") or 10 ** 9)
    k = int(nar["negative_samples"])
    bs = int(nar["batch_size"])
    shapes = flops.Shapes.of(model)
    valid = scored = fl = 0.0
    for lens in batches:
        v = float(np.clip(lens.astype(np.int64) - 1, 0, model.t).sum())
        s = min(v, cap)
        pool = min(k * int(nar["neg_sampling_multiplying_factor"]),
                   bs * model.t + bs + int(nar["negative_sample_from_buffer"]))
        valid += v
        scored += s
        fl += flops.model_flops(shapes, int(v), int(s), k, pool, train=True)
    return {"valid_rows": valid, "scored_rows": scored, "model_flops": fl,
            "grid_rows": float(len(batches) * bs * model.t),
            "steps": len(batches), "candidates": k}


def _hour(hours, h: int) -> list:
    """Hour ``h`` of the run: the ``h mod d``-th hour made, moved a further
    ``d`` hours later each time it comes round again."""
    d = len(hours)
    if h >= d:
        shift(hours[h % d], d * traffic.HOUR)
    return hours[h % d]


def window(run, state, device):
    harness, hours, lengths = state["harness"], state["hours"], state["lengths"]
    d = len(hours)
    step_s: List[float] = []
    restore = None
    if run.trace:
        def timed(original):
            def train_step(*a, **k):
                t0 = time.perf_counter()
                out = original(*a, **k)
                step_s.append(time.perf_counter() - t0)
                return out
            return train_step
        restore = system.wrap_step("train_step", timed)
    gc.collect()
    gc.freeze()
    run.setup_s = process_seconds()
    h, sessions, batches = 1, 0, []
    w0 = time.perf_counter()
    while True:
        hour = _hour(hours, h)
        harness.train_hour(hour)
        sessions += len(hour)
        batches += lengths[h % d]
        h += 1
        if time.perf_counter() - w0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - w0
    if restore:
        restore()
    run.attempted = len(batches)
    run.e2e["train_sessions_per_s"] = sessions / run.window_s
    run.work = _work(run, state["model"], batches)
    run.host["train_step_s"] = step_s
    if run.trace:
        n_traced = int(run.traffic["trace_hours"])
        traced = [b for i in range(n_traced) for b in lengths[(h + i) % d]]

        def go():
            for i in range(n_traced):
                hour = _hour(hours, h + i)
                with trace.span("train_hour"):
                    harness.train_hour(hour)
            return len(traced)

        run.trace_summary = trace.profile(go, run.tmpdir, device.type == "cuda")
        run.work["trace"] = _work(run, state["model"], traced)
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def free(state):
    state.pop("harness", None)


def _aligned(record, rows):
    """Each of the reference's rows ``rows`` as its place in the system's
    scored rows (the flat grid where the step scores every row), and how
    many rows the two do not share: a valid row the system left out or
    scored twice, or one it scored as valid that holds no click.  Which
    padding rows the system also scores, and in what order, is its own."""
    if record["rows"] is None:
        return rows, 0
    mine, flags = record["rows"].long(), record["valid"]
    sel = torch.nonzero(flags > 0)[:, 0]
    ids = mine[sel]
    match = ids[None, :] == rows[:, None]
    found = match.any(1)
    pos = torch.where(found, sel[match.float().argmax(1)], 0)
    faults = (int((~found).sum()) + ids.numel() - int(torch.unique(ids).numel())
              + int((~torch.isin(ids, rows)).sum()))
    return pos, faults


def _replay(run, state, device):
    """The reference's rows and stream for each first step, the places of
    those rows among the system's, and the faults of the system's rows and
    negatives against them."""
    ref, model = state["ref"], state["model"]
    nar = run.config["nar"]
    t, k, bs = model.t, int(nar["negative_samples"]), int(nar["batch_size"])
    cap = int(nar.get("train_valid_row_capacity") or t * bs)
    inp, stream = ref_inputs(ref, model, state["corpus"], state["hist"], device)
    batches = [to_device(ref.train_batch(model, s, bs), device) for s in state["steps"]]
    rows_all, row_faults, neg_faults = [], 0, 0
    for b, r in zip(batches, state["records"]):
        rows = ref.valid_rows(b["session_size"], t, cap)
        pos, faults = _aligned(r, rows)
        row_faults += faults
        rows_all.append((rows, pos))
        clicked, _ = ref.batch_clicks(b)
        neg_faults += ref.negative_faults(clicked, stream.buffer_ids,
                                          r["negs"].reshape(-1, k)[pos], rows // t,
                                          b["item_clicked"].reshape(-1)[rows], k)
        stream = ref.fold_clicks(model, stream, *ref.batch_clicks(b))
    return inp, batches, rows_all, row_faults, neg_faults


def reference_outputs(run, state, device, precision: str = "f32"):
    """The reference through the system's first steps, with the system's
    negatives: its probabilities, first gradient's norms and the
    norms of its parameters' change."""
    ref, model = state["ref"], state["model"]
    if "replay" not in state:
        state["replay"] = _replay(run, state, device)
    inp, batches, rows, _, _ = state["replay"]
    k = int(run.config["nar"]["negative_samples"])
    w0 = weights.make_weights(model, state["seed_w"], device)
    negs = [r["negs"].reshape(-1, k)[pos].long() for r, (_, pos) in zip(state["records"], rows)]
    _, stream0 = ref_inputs(ref, model, state["corpus"], state["hist"], device)
    _, probs, grad, params = ref.train_steps(
        model, w0, batches, [r for r, _ in rows], negs, stream0, with_stream(ref, inp, stream0),
        ref.Precision(precision))
    return {"probs": probs, "grad": ck.norms(grad),
            "change": ck.norms({n: params[n] - w0[n] for n in w0})}


def as_system(run, state, ref_out):
    """The reference's outputs in the system's form: its first step's
    probabilities at the system's places of its rows."""
    pos = state["replay"][2][0][1]
    shape = state["records"][0]["probs"].shape
    probs = ref_out["probs"][0]
    placed = probs.new_zeros((int(np.prod(shape[:-1])), shape[-1]))
    placed[pos] = probs
    return dict(ref_out, probs=[placed] + list(ref_out["probs"][1:]))


def system_outputs(run, state):
    rec = state["records"]
    return {"probs": [r["probs"] for r in rec], "grad": state["grad1"],
            "change": state["change"]}


def numbers(run, state, sys_out, ref_out) -> Dict[str, float]:
    _, _, rows, row_faults, neg_faults = state["replay"]
    top_n = int(run.config["nar"]["metrics_top_n"])
    pos = rows[0][1]
    probs = sys_out["probs"][0]
    sys_probs = probs.reshape(-1, probs.shape[-1])[pos.to(probs.device)].to(pos.device)
    return {
        # the first step's forward, from the same weights: later steps'
        # probabilities also carry how Adam's first updates (~lr * sign(g))
        # amplified the gradients' round-off
        "prob_gap": ck.prob_gap(sys_probs, ref_out["probs"][0],
                                torch.ones(len(pos), dtype=torch.bool, device=pos.device),
                                top_n),
        "grad_gap": ck.norm_gap(sys_out["grad"], ref_out["grad"]),
        "change_gap": ck.norm_gap(sys_out["change"], ref_out["change"],
                                  ck.moving_leaves(ref_out["grad"])),
        "row_faults": float(row_faults),
        "negative_faults": float(neg_faults),
    }

"""Eval hours: ``TemporalHarness.evaluate_hour`` over hours of sessions,
which the harness collates, CHAMELEON's metric tier only (no classical
baseline).

Every eval hour starts from the same click stream, since the harness
restores it after each hour.  Set-up makes the articles, the history hour,
``distinct_hours`` hours of sessions and the weights from the seed, builds
the harness and evaluates one hour to warm up.  The window evaluates hour
after hour until ``seconds`` have passed; its rate is every session it
evaluated over all of its time.  Of one hour drawn from the seed among the
first ``check_hour_from_first``, the eval step's negatives of every batch,
the full ranking of ``check_batches`` batches (one of them holding the
longest session) and the hour's HR and MRR are kept; after the window the
reference replays that hour."""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import check as ck
from .. import flops, system, trace, traffic, weights
from ..common import process_seconds
from .common import (batch_lengths, hour_objects, no_gc, ref_inputs, reference_module, seeds,
                     to_device, with_stream)


class _Keeper:
    """Wraps the harness's eval step: in the kept hour it asks the step for
    the full ranking of the kept batches and keeps every batch's
    negatives, and hands the harness what it asked for."""

    def __init__(self, top_n: int):
        self.top_n = top_n
        self.hour = -1
        self.keep_hour = None
        self.keep_batches = set()
        self.batch = 0
        self.negs: List[torch.Tensor] = []
        self.top: List[torch.Tensor] = []
        self.ranked: Dict[int, tuple] = {}

    def __call__(self, original):
        def eval_step(*a, **k):
            if self.hour != self.keep_hour:
                return original(*a, **k)
            j = self.batch
            self.batch += 1
            asked = k.get("fetch_full_ranking", True)
            if j in self.keep_batches:
                k["fetch_full_ranking"] = True
            stream, metrics, fetches = original(*a, **k)
            self.negs.append(fetches["neg_items"])
            self.top.append(fetches["predicted_ids"][..., : self.top_n])
            if j in self.keep_batches:
                self.ranked[j] = (fetches["predicted_ids"], fetches["predicted_probs"])
                if not asked:
                    fetches = dict(fetches)
                    fetches["predicted_ids"] = fetches["predicted_ids"][..., : self.top_n]
                    del fetches["predicted_probs"]
            return stream, metrics, fetches
        return eval_step


def setup(run, device):
    cfg, mix = run.config, run.traffic
    ref = reference_module(cfg)
    t = time.perf_counter()
    model = ref.Model(cfg)
    seed_w, seed_s = seeds(run.seed)
    r_corpus, r_hist, r_hours, r_pick = traffic.rngs(run.seed, 4)
    corpus = traffic.make_corpus(cfg, r_corpus, mix["item_zipf"])
    n = int(mix["sessions_per_hour"])
    hist = traffic.hour_sessions(corpus, cfg, mix, r_hist, n, -1, 10 ** 9)
    bs = int(cfg["nar"]["batch_size"])
    arrays = [traffic.hour_sessions(corpus, cfg, mix, r_hours, n, 0, (h + 1) * 10 ** 7)
              for h in range(int(mix["distinct_hours"]))]
    with no_gc():
        hours = [hour_objects(a) for a in arrays]
    lengths = [batch_lengths(a.lengths, bs) for a in arrays]
    keep_hour = int(r_pick.integers(0, int(mix["check_hour_from_first"])))
    kept_hour = traffic.serving_sessions(arrays[keep_hour % len(arrays)])
    kept_hour = [kept_hour[i:i + bs] for i in range(0, len(kept_hour), bs)]
    del arrays
    nb = len(kept_hour)
    longest = int(np.argmax([max(len(s["items"]) for s in b) for b in kept_hour]))
    kept = set(r_pick.choice(nb, int(mix["check_batches"]) - 1, replace=False).tolist())
    t = run.phase("traffic", t)
    w = weights.make_weights(model, seed_w, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = run.phase("weights", t)
    harness = system.make_harness(cfg, corpus, w, traffic.history_clicks(hist), seed_s,
                                  device, run.tmpdir)
    del w
    t = run.phase("system", t)
    keeper = _Keeper(int(cfg["nar"]["metrics_top_n"]))
    keeper.keep_hour = keep_hour
    keeper.keep_batches = kept | {longest}
    harness.evaluate_hour(hours[-1])  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
    run.phase("warm-up", t)
    return dict(ref=ref, model=model, corpus=corpus, hist=hist, hours=hours,
                lengths=lengths, kept_hour=kept_hour, harness=harness, keeper=keeper,
                seed_w=seed_w, row=None)


def _work(run, model, batches) -> Dict[str, float]:
    """Valid rows and the model's operations of ``batches``, each given by
    its sessions' lengths."""
    nar = run.config["nar"]
    k = int(nar["eval_negative_samples"])
    bs = int(nar["batch_size"])
    shapes = flops.Shapes.of(model)
    valid = fl = 0.0
    for lens in batches:
        v = float(np.clip(lens.astype(np.int64) - 1, 0, model.t).sum())
        pool = min(k * int(nar["neg_sampling_multiplying_factor"]),
                   bs * model.t + bs + int(nar["eval_negative_sample_from_buffer"]))
        valid += v
        fl += flops.model_flops(shapes, int(v), int(v), k, pool, train=False)
    return {"valid_rows": valid, "scored_rows": valid, "model_flops": fl,
            "grid_rows": float(len(batches) * bs * model.t),
            "steps": len(batches), "candidates": k}


def window(run, state, device):
    harness, hours, keeper = state["harness"], state["hours"], state["keeper"]
    lengths = state["lengths"]
    d = len(hours)
    restore = system.wrap_step("eval_step", keeper)
    tier = 0.0
    gc.collect()
    gc.freeze()
    run.setup_s = process_seconds()
    h, sessions, batches = 0, 0, []
    w0 = time.perf_counter()
    while True:
        keeper.hour, keeper.batch = h, 0
        row = harness.evaluate_hour(hours[h % d])
        if h == keeper.keep_hour:
            state["row"] = row
        tier += harness.last_eval_phase_seconds.get("chameleon_metrics", 0.0)
        sessions += len(hours[h % d])
        batches += lengths[h % d]
        h += 1
        if time.perf_counter() - w0 >= run.seconds and h > keeper.keep_hour:
            break
    run.window_s = time.perf_counter() - w0
    keeper.hour = -1
    run.attempted = len(batches)
    run.e2e["eval_sessions_per_s"] = sessions / run.window_s
    run.host["metrics_tier_s"] = tier
    run.work = _work(run, state["model"], batches)
    if run.trace:
        n_traced = int(run.traffic["trace_hours"])

        def go():
            for i in range(n_traced):
                with trace.span("evaluate_hour"):
                    harness.evaluate_hour(hours[(h + i) % d])
            return sum(len(lengths[(h + i) % d]) for i in range(n_traced))

        run.trace_summary = trace.profile(go, run.tmpdir, device.type == "cuda")
        run.work["trace"] = _work(run, state["model"],
                                  [b for i in range(n_traced) for b in lengths[(h + i) % d]])
    restore()
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def free(state):
    state.pop("harness", None)


def reference_outputs(run, state, device, precision: str = "f32"):
    """The reference over the kept hour with the system's negatives: the
    logits of every batch, replaying the click stream batch by batch, and
    the faults of the negatives."""
    ref, model, keeper = state["ref"], state["model"], state["keeper"]
    nar = run.config["nar"]
    bs = int(nar["batch_size"])
    hour = [ref.train_batch(model, b, bs) for b in state["kept_hour"]]
    inp, stream = ref_inputs(ref, model, state["corpus"], state["hist"], device)
    w = weights.make_weights(model, state["seed_w"], device)
    logits, masks, faults = [], [], 0
    k = int(nar["eval_negative_samples"])
    with torch.no_grad():
        for b_np, negs in zip(hour, keeper.negs):
            b = to_device(b_np, device)
            clicked, _ = ref.batch_clicks(b)
            t = b["item_clicked"].shape[1]
            rows = torch.arange(b["item_clicked"].numel(), device=device)
            if precision == "f32":
                faults += ref.negative_faults(clicked, stream.buffer_ids, negs.reshape(-1, k),
                                              rows // t, b["item_clicked"].reshape(-1), k)
            lg, mask = ref.grid_logits(model, w, b, negs.long(), with_stream(ref, inp, stream),
                                       ref.Precision(precision))
            logits.append(lg)
            masks.append(mask)
            stream = ref.fold_clicks(model, stream, *ref.batch_clicks(b))
    if len(keeper.negs) != len(hour):
        faults += abs(len(hour) - len(keeper.negs)) * 10 ** 6
    return {"logits": logits, "masks": masks, "faults": faults,
            "labels": [torch.as_tensor(b["label_next_item"], device=device) for b in hour],
            "negs": [n.long() for n in keeper.negs]}


def _hr_mrr(probs_rows: List[torch.Tensor], masks, top_n: int):
    """HR@N and MRR@N of the label (slot 0; ties rank it first) over the
    valid rows."""
    hit = rr = count = 0.0
    for p, m in zip(probs_rows, masks):
        rank = (p[..., 1:] > p[..., :1]).sum(-1).float()
        hit += float(((rank < top_n).float() * m).sum())
        rr += float((torch.where(rank < top_n, 1.0 / (1.0 + rank), 0.0) * m).sum())
        count += float(m.sum())
    return hit / max(count, 1.0), rr / max(count, 1.0)


def system_outputs(run, state):
    row, keeper = state["row"], state["keeper"]
    return {"ranked": keeper.ranked, "top": keeper.top, "hr": row["hitrate_at_n"],
            "mrr": row["mrr_at_n"]}


def as_system(run, state, ref_out):
    """The reference's own ranking of the kept batches and its HR and MRR
    of the hour, as the system would give them."""
    top_n = int(run.config["nar"]["metrics_top_n"])
    kept = state["keeper"].keep_batches
    probs = [torch.softmax(lg.double(), -1) for lg in ref_out["logits"]]
    ranked, top = {}, []
    for j, (p, labels, negs) in enumerate(zip(probs, ref_out["labels"], ref_out["negs"])):
        ids = torch.cat([labels[..., None].long(), negs], -1)
        order = torch.sort(p, dim=-1, descending=True, stable=True).indices
        top.append(ids.gather(-1, order)[..., :top_n])
        if j in kept:
            ranked[j] = (ids.gather(-1, order), p.gather(-1, order).float())
    hr, mrr = _hr_mrr(probs, [m.float() for m in ref_out["masks"]], top_n)
    return {"ranked": ranked, "top": top, "hr": hr, "mrr": mrr}


def _slots(ids, cand):
    """Each of ``ids`` [..., N] as its slot in ``cand`` [..., 1 + K] (-1
    where it is none of them)."""
    match = ids[..., None] == cand[..., None, :]
    return torch.where(match.any(-1), match.float().argmax(-1), -1)


def numbers(run, state, sys_out, ref_out) -> Dict[str, float]:
    """``rank_gap`` over the system's top N of every batch of the hour,
    ``prob_gap`` over the kept batches' probabilities, ``metric_faults``:
    the hour's HR and MRR against the reference's arithmetic on the
    system's own top N (hits counted exactly; MRR to 1e-6, its float32
    sum's rounding), and ``negative_faults``."""
    top_n = int(run.config["nar"]["metrics_top_n"])
    probs = [torch.softmax(lg.double(), -1) for lg in ref_out["logits"]]
    faults = ref_out["faults"] + 10 ** 6 * abs(len(sys_out["top"]) - len(probs))
    rank = prob = 0.0
    hits = rr = count = 0.0
    for j, (lg, mask, labels, negs) in enumerate(zip(ref_out["logits"], ref_out["masks"],
                                                    ref_out["labels"], ref_out["negs"])):
        if j >= len(sys_out["top"]):
            break
        cand = torch.cat([labels[..., None].long(), negs], -1)
        top = sys_out["top"][j][..., :top_n].long().to(cand.device)
        slots = _slots(top, cand)
        faults += int(((slots < 0) & mask[..., None]).sum())
        m = mask.reshape(-1)
        sel = slots.reshape(-1, top_n)[m].clamp_min(0)
        if sel.shape[0]:
            rank = max(rank, ck.rank_gap(lg.reshape(-1, lg.shape[-1])[m], sel))
        hit = top == labels[..., None].long()
        first = hit.float().argmax(-1).double()
        hits += float((hit.any(-1) & mask).sum())
        rr += float((torch.where(hit.any(-1), 1.0 / (1.0 + first), 0.0) * mask).sum())
        count += float(mask.sum())
        if j in sys_out["ranked"]:
            ids, p_sys = sys_out["ranked"][j]
            slots_all = _slots(ids[..., :top_n].long().to(cand.device), cand)
            a = ck.log_p(p_sys[..., :top_n].reshape(-1, top_n)[m].to(lg.device))
            b = ck.log_p(probs[j].reshape(-1, probs[j].shape[-1])[m].gather(
                -1, slots_all.reshape(-1, top_n)[m].clamp_min(0)))
            if a.numel():
                prob = max(prob, float((a - b).abs().max()))
    hit_faults = abs(round(sys_out["hr"] * count) - hits)
    mrr_faults = float(abs(sys_out["mrr"] - rr / max(count, 1.0)) > 1e-6)
    return {"rank_gap": rank, "prob_gap": prob, "metric_faults": hit_faults + mrr_faults,
            "negative_faults": float(faults)}

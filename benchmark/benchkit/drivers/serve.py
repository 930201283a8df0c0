"""Serving: one closed-loop client calling ``NARServer.recommend``.

Set-up makes the articles, the history hour that fills the live click
buffer, ``distinct_batches`` requests of ``batch_sessions`` live sessions
and the weights from the seed, builds the server on them and warms it up.
The window calls ``recommend`` on one request after another (the
candidates are the server's default: the buffer's most recent distinct
articles), each timed on the host clock from the call to the returned ids,
until ``seconds`` have passed; the stream is not advanced inside it.  The
answers of ``check_calls`` calls drawn from the seed among the first
``check_from_first_calls``, one of them holding the longest session, are
kept; after the window the reference scores those requests again."""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import check as ck
from .. import flops, system, trace, traffic, weights
from ..common import process_seconds
from .common import no_gc, ref_inputs, reference_module, seeds, to_device


def setup(run, device):
    cfg, mix = run.config, run.traffic
    ref = reference_module(cfg)
    t = time.perf_counter()
    model = ref.Model(cfg)
    seed_w, _ = seeds(run.seed)
    r_corpus, r_hist, r_req, r_pick = traffic.rngs(run.seed, 4)
    corpus = traffic.make_corpus(cfg, r_corpus, mix["item_zipf"])
    hist = traffic.hour_sessions(corpus, cfg, mix, r_hist, int(mix["sessions_per_hour"]),
                                 -1, 10 ** 9)
    b, d = int(mix["batch_sessions"]), int(mix["distinct_batches"])
    live = traffic.hour_sessions(corpus, cfg, mix, r_req, b * d, 0, 10 ** 7)
    with no_gc():
        dicts = traffic.serving_sessions(live)
        requests = [dicts[i::d] for i in range(d)]  # each request spans the hour
        sessions = [system.to_sessions(r) for r in requests]
    longest = int(np.argmax([max(len(s["items"]) for s in r) for r in requests]))
    first = int(mix["check_from_first_calls"])
    picks = sorted(set(r_pick.choice(first, int(mix["check_calls"]) - 1, replace=False).tolist())
                   | {longest})
    t = run.phase("traffic", t)
    w = weights.make_weights(model, seed_w, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = run.phase("weights", t)
    server = system.make_server(cfg, corpus, w, traffic.history_clicks(hist), device)
    del w
    t = run.phase("system", t)
    for i in range(int(mix["warmup_calls"])):
        server.recommend(sessions[i % d], top_k=int(mix["top_k"]),
                         num_candidates=int(mix["num_candidates"]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    run.phase("warm-up", t)
    return dict(ref=ref, model=model, corpus=corpus, hist=hist, requests=requests,
                sessions=sessions, server=server, picks=set(picks), answers={},
                seed_w=seed_w)


def _work(run, model, requests, calls: List[int]) -> Dict[str, float]:
    mix = run.traffic
    k = int(mix["num_candidates"])
    shapes = flops.Shapes.of(model)
    rows = fl = steps = 0.0
    d = len(requests)
    per = []
    for r in requests:
        enc = sum(min(len(s["items"]), model.t) for s in r)
        per.append((enc, len(r), flops.model_flops(shapes, enc, len(r), k, k, train=False)))
    for i in calls:
        enc, n, f = per[i % d]
        steps += enc
        rows += n
        fl += f
    return {"valid_rows": steps, "sessions": rows, "model_flops": fl, "calls": len(calls),
            "candidates": k, "grid_rows": float(len(calls) * len(requests[0]) * model.t)}


def window(run, state, device):
    server, sessions, mix = state["server"], state["sessions"], run.traffic
    d = len(sessions)
    top_k, n_cand = int(mix["top_k"]), int(mix["num_candidates"])
    picks, answers = state["picks"], state["answers"]
    lat: List[float] = []
    gc.collect()
    gc.freeze()
    run.setup_s = process_seconds()
    i, last_pick = 0, max(picks)
    w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        ids, scores = server.recommend(sessions[i % d], top_k=top_k, num_candidates=n_cand)
        lat.append(time.perf_counter() - t0)
        if i in picks:
            answers[i] = (ids, scores)
        i += 1
        if time.perf_counter() - w0 >= run.seconds and i > last_pick:
            break
    run.window_s = time.perf_counter() - w0
    run.attempted = i
    run.e2e["recommend_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    run.host["latency_s"] = lat
    run.work = _work(run, state["model"], state["requests"], list(range(i)))
    if run.trace:
        n_traced = int(mix["trace_calls"])

        def go():
            for j in range(n_traced):
                with trace.span("recommend"):
                    server.recommend(sessions[(i + j) % d], top_k=top_k, num_candidates=n_cand)
            return n_traced

        run.trace_summary = trace.profile(go, run.tmpdir, device.type == "cuda")
        run.work["trace"] = _work(run, state["model"], state["requests"],
                                  list(range(i, i + n_traced)))
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def free(state):
    state.pop("server", None)


def reference_outputs(run, state, device, precision: str = "f32"):
    """The reference's logits [B, 1 + K] of each kept request, over the
    candidates it works out from its own click stream."""
    ref, model = state["ref"], state["model"]
    inp, stream = ref_inputs(ref, model, state["corpus"], state["hist"], device)
    cands = ref.recent_distinct(stream.buffer_ids, int(run.traffic["num_candidates"]))
    cands_t = torch.as_tensor(cands, device=device)
    w = weights.make_weights(model, state["seed_w"], device)
    d = len(state["requests"])
    out = {"cands": cands_t, "logits": {}}
    with torch.no_grad():
        for i in sorted(state["answers"]):
            batch = to_device(ref.serving_batch(model, state["requests"][i % d]), device)
            c = cands_t[None].expand(batch["session_size"].shape[0], -1)
            out["logits"][i] = ref.serve_logits(model, w, batch, c, inp, ref.Precision(precision))
    return out


def system_outputs(run, state):
    return {i: (torch.as_tensor(ids), torch.as_tensor(sc))
            for i, (ids, sc) in state["answers"].items()}


def as_system(run, state, ref_out):
    """The reference's own answers (its top ``k`` over the candidates, with
    their probabilities), as the system would give them."""
    k = int(run.traffic["top_k"])
    cands = ref_out["cands"]
    out = {}
    for i, logits in ref_out["logits"].items():
        p = torch.softmax(logits, -1)
        slots = ck.top_slots(torch.where(cands[None] != 0, p[:, 1:], -1.0), k)
        out[i] = (cands[slots].cpu(), p[:, 1:].gather(-1, slots).cpu())
    return out


def numbers(run, state, sys_out, ref_out) -> Dict[str, float]:
    cands = ref_out["cands"]
    rank, score, faults = 0.0, 0.0, 0
    for i, logits in ref_out["logits"].items():
        ids, sc = sys_out[i]
        ids = ids.to(cands.device).long()
        match = ids[..., None] == cands[None, None, :]  # [B, k, K]
        found = match.any(-1)
        distinct = torch.sort(ids, -1).values
        faults += int((~found).sum()) + int((distinct[:, 1:] == distinct[:, :-1]).sum())
        slots = match.float().argmax(-1)  # [B, k]
        cand_logits = logits[:, 1:].masked_fill(cands[None] == 0, -torch.inf)
        rank = max(rank, ck.rank_gap(cand_logits, slots))
        p_ref = torch.softmax(logits.double(), -1)[:, 1:].gather(-1, slots)
        score = max(score, float((ck.log_p(sc.to(p_ref.device)) - ck.log_p(p_ref)).abs().max()))
    return {"rank_gap": rank, "score_gap": score, "answer_faults": float(faults)}

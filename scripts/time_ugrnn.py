#!/usr/bin/env python3
"""Time one tree's UGRNN kernels (K2f, K2b) and its serving call on one
NVIDIA card, so that one call can compare two trees in turns.

    python3 scripts/time_ugrnn.py [--root DIR] [--label NAME]

Imports ``chameleon_recsys_tpu_torch`` from ``--root`` (default: this
checkout), e.g. a ``git archive`` of a parent commit unpacked into a
gitignored directory, and every timing helper from this checkout's
``chip_smoke.py`` (``queued_ms``, ``cuda_ms``, ``launch_split``, the G1
server), so that both trees are measured by the same code.  Inputs are
seeded and random at the G1 widths (T 19, U 255), session lengths uniform in
1..19.  Prints the card's name and power limit, then one JSON line per
measurement, in this order:

- ``recommend``: ``NARServer.recommend`` at batch 1 and 32 on a G1 server
  with random weights (500 candidates, top 10): p50 and p99 over 100 calls
  on the host clock, before any profiler session in the process;
- ``fwd``: K2f at batch 1, 32 and 256 in bf16 and at 32 and 256 in f32,
  without the training outputs and with them (the f32 states, and the f32
  stash where the tree's forward writes it): device ms by CUDA events over
  calls queued ahead (``*_ms``) and by plain CUDA events over back-to-back
  calls (``events_ms``), and the wrapper's host time a call
  (``host_ms_per_call``: 100 calls on the host clock, not waiting for the
  card);
- ``bwd``: K2b at batch 256 in bf16 and f32, the same two clocks;
- ``recommend_host``: the first profiler session of the process: one b32
  call's host time by operation (torch profiler, CPU activity: the top
  host events by self time, the CUDA runtime calls among them, mean over 20
  calls), and the host-clock p50 of ``recommend`` again after it;
- ``bwd_split``: K2b at batch 256 split by device launch (torch profiler,
  every record kept; ``chip_smoke.launch_split`` fails on an uneven
  session).

Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
T = 19
SERVE_BATCHES = (1, 32)


def load_chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its helpers import the
    package only inside their bodies, from ``sys.path``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def lengths_mask(batch, seed):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, T + 1, (batch,), generator=g)
    return torch.arange(T)[None] < lengths[:, None]


def recommend_p50(server, sessions, pool, top_k, calls=100):
    """{batch: (p50, p99)} of ``recommend`` in ms on the host clock."""
    out = {}
    for bs in SERVE_BATCHES:
        cand = np.broadcast_to(pool, (bs, pool.shape[0]))
        times = []
        for i in range(calls + 5):
            t0 = time.perf_counter()
            server.recommend(sessions[:bs], candidates=cand, top_k=top_k)
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        out[bs] = (statistics.median(times), times[int(0.99 * len(times)) - 1])
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_ugrnn: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chameleon_recsys_tpu_torch as port
    from chameleon_recsys_tpu_torch.data.synthetic import (
        make_synthetic_corpus,
        synthetic_hour_sessions,
    )
    from chameleon_recsys_tpu_torch.ops.kernels import ugrnn

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    print(f"time_ugrnn {args.label}: package at {Path(port.__file__).resolve().parent}")

    def emit(kind, **fields):
        print(json.dumps({"label": args.label, "kind": kind, **fields}))

    # serving first, before any profiler session
    cfg, session_schema, article_schema = smoke.g1_setup(port)
    corpus = make_synthetic_corpus(article_schema, ace_dim=250)
    sessions = synthetic_hour_sessions(corpus, session_schema, 0, 2 * cfg.batch_size,
                                       cfg.max_session_length)
    server = smoke.make_server(port, cfg, session_schema, article_schema, corpus, seed=0,
                               device="cuda")
    server.observe(sessions[: cfg.batch_size])
    server.observe(sessions[cfg.batch_size:])
    pool = server.default_candidates(smoke.NUM_CANDIDATES)
    for bs, (p50, p99) in recommend_p50(server, sessions, pool, smoke.TOP_K).items():
        emit("recommend", batch=bs, p50_ms=p50, p99_ms=p99)

    stash = "return_acts" in inspect.signature(ugrnn.ugrnn_scan_kernel).parameters
    for dtype, batches in ((torch.bfloat16, (1, 32, 256)), (torch.float32, (32, 256))):
        for batch in batches:
            x, w, m = smoke.ugrnn_inputs(lengths_mask(batch, batch), dtype, seed=batch)
            variants = {"": {}, "_with_states": {"return_state": True}}
            if stash:
                variants["_with_states_and_stash"] = {"return_acts": True}
            fields = {"dtype": str(dtype)[6:], "batch": batch}
            for name, kwargs in variants.items():
                def call():
                    return ugrnn.ugrnn_scan_kernel(x, w, m, **kwargs)
                fields[f"ms{name}"] = smoke.queued_ms(call, iters=200)
                fields[f"events_ms{name}"] = smoke.cuda_ms(call, iters=200)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                ugrnn.ugrnn_scan_kernel(x, w, m)
            fields["host_ms_per_call"] = (time.perf_counter() - t0) * 10
            torch.cuda.synchronize()
            emit("fwd", **fields)

    bwd_calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, w, m = smoke.ugrnn_inputs(lengths_mask(256, 7), dtype, seed=7)
        if stash:
            _, hs, acts = ugrnn.ugrnn_scan_kernel(x, w, m, return_acts=True)
            kwargs = {"acts": acts}
        else:
            _, hs = ugrnn.ugrnn_scan_kernel(x, w, m, return_state=True)
            kwargs = {}
        g = (torch.randn(*hs.shape, generator=torch.Generator().manual_seed(8))
             .to(dtype).cuda())

        def bwd(x=x, w=w, m=m, hs=hs, g=g, kwargs=kwargs):
            return ugrnn.ugrnn_scan_bwd_kernel(x, w, m, hs, g, **kwargs)

        bwd_calls[dtype] = bwd
        emit("bwd", dtype=str(dtype)[6:], batch=256, ms=smoke.queued_ms(bwd, iters=50),
             events_ms=smoke.cuda_ms(bwd, iters=50))

    # the first profiler session: recommend b32's host time by operation
    from torch.profiler import ProfilerActivity, profile

    calls = 20
    cand = np.broadcast_to(pool, (32, pool.shape[0]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            server.recommend(sessions[:32], candidates=cand, top_k=smoke.TOP_K)
        torch.cuda.synchronize()
    host = sorted(((e.key, e.self_cpu_time_total / calls / 1e3, e.count / calls)
                   for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda r: -r[1])
    after = recommend_p50(server, sessions, pool, smoke.TOP_K)
    emit("recommend_host", batch=32, calls=calls,
         self_cpu_ms_per_call=sum(r[1] for r in host),
         top=[{"op": k[:80], "self_cpu_ms": ms, "count": n} for k, ms, n in host[:15]],
         p50_ms_after_profiling={str(bs): v[0] for bs, v in after.items()})

    for dtype, bwd in bwd_calls.items():
        emit("bwd_split", dtype=str(dtype)[6:], batch=256,
             split=[{"kernel": name.replace("(anonymous namespace)::", "").split("(")[0][:80],
                     "us": us} for name, us in smoke.launch_split(bwd, 5)])
    return 0


if __name__ == "__main__":
    sys.exit(main())

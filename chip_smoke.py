#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path (``NARServer.observe`` / ``recommend``) at the
G1 configuration's full width with random weights from a seed, and every
hand-written kernel of that path:

1. builds each kernel from ``chameleon_recsys_tpu_torch/csrc`` (one ``nvcc``
   per source, started together) and reports the build time;
2. holds each kernel against its plain PyTorch twin on the card, at the
   shapes the serving path gives it, with the tolerance stated;
3. zeroes the launch counters, observes 2 x 256 synthetic sessions and
   recommends top-10 of 500 candidates at batch 1 and 32, reads the counters
   (the UGRNN kernel must launch twice per ``recommend``) and checks every
   result (shape, finite, ids from the pool, scores sorted);
4. checks the served scores against the same model on the CPU, where the
   kernel wrappers run their plain twins, on a small input in float32;
5. times each kernel, its plain twin and ``recommend`` with CUDA events or a
   synchronised host clock.

Prints the card's name and power limit first, a JSON line of per-kernel
numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits 1 before printing any result.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM
H100_F32_FLOP_PER_S = 67e12  # CUDA cores, no tensor cores
SERVE_BATCHES = (1, 32)
NUM_CANDIDATES = 500
TOP_K = 10


def check(condition, message):
    if not condition:
        raise RuntimeError(f"chip_smoke: {message}")


def g1_setup(port):
    """The G1 reproduction schemas and NARConfig (bench.py::_g1_setup), with
    the session RNN on the hand-written kernel."""
    FeatureSpec = port.FeatureSpec
    num_items = 46033
    article_schema = port.ArticleFeaturesSchema(features=(
        FeatureSpec("article_id", "categorical", num_items),
        FeatureSpec("created_at_ts", "numerical", dtype="int"),
        FeatureSpec("category_id", "categorical", 461),
    ))
    session_schema = port.SessionFeaturesSchema(
        single=(
            FeatureSpec("user_id", "categorical", 322897),
            FeatureSpec("session_id", "numerical", dtype="int"),
            FeatureSpec("session_start", "numerical", dtype="int"),
            FeatureSpec("session_size", "numerical", dtype="int"),
        ),
        sequence=(
            FeatureSpec("event_timestamp", "numerical", dtype="int"),
            FeatureSpec("item_clicked", "categorical", num_items),
            FeatureSpec("environment", "categorical", 5),
            FeatureSpec("deviceGroup", "categorical", 6),
            FeatureSpec("os", "categorical", 23),
            FeatureSpec("country", "categorical", 12),
            FeatureSpec("region", "categorical", 29),
            FeatureSpec("local_hour_sin", "numerical", dtype="float"),
            FeatureSpec("local_hour_cos", "numerical", dtype="float"),
            FeatureSpec("weekday", "numerical", dtype="float"),
            FeatureSpec("referrer_class", "categorical", 8),
        ),
    )
    cfg = port.NARConfig(
        car_embedding_size=1024,
        rnn_units=255,
        rnn_num_layers=2,
        negative_samples=50,
        negative_sample_from_buffer=3000,
        recent_clicks_buffer_max_size=20000,
        recent_clicks_for_normalization=5000,
        batch_size=256,
        max_session_length=20,
        metrics_top_n=10,
        keep_prob=1.0,
        compute_dtype="bfloat16",
        use_pallas_scorer=True,
        approx_negative_topk=True,
        use_pallas_rnn=True,
    )
    return cfg, session_schema, article_schema


def tiny_setup(port):
    """A small float32 configuration for the CPU-vs-card check."""
    FeatureSpec = port.FeatureSpec
    num_items = 200
    article_schema = port.ArticleFeaturesSchema(features=(
        FeatureSpec("article_id", "categorical", num_items),
        FeatureSpec("created_at_ts", "numerical", dtype="int"),
        FeatureSpec("category_id", "categorical", 12),
    ))
    session_schema = port.SessionFeaturesSchema(sequence=(
        FeatureSpec("event_timestamp", "numerical", dtype="int"),
        FeatureSpec("item_clicked", "categorical", num_items),
        FeatureSpec("device", "categorical", 5),
        FeatureSpec("os", "categorical", 23),
        FeatureSpec("hour_sin", "numerical", dtype="float"),
    ))
    cfg = port.NARConfig(
        car_embedding_size=32, rnn_units=24, rnn_num_layers=2,
        matching_layer_sizes=(16, 8), recent_clicks_buffer_max_size=128,
        recent_clicks_for_normalization=64, batch_size=8, max_session_length=8,
        use_pallas_rnn=True,
    )
    return cfg, session_schema, article_schema


def make_server(port, cfg, session_schema, article_schema, corpus, seed, device):
    from chameleon_recsys_tpu_torch.state.stream_state import init_stream_state

    model = port.NARModel(
        cfg, session_schema, article_schema, corpus.ace_matrix.shape[1]
    )
    model.reset_parameters(torch.Generator().manual_seed(seed))
    stream = init_stream_state(cfg, article_schema.num_items, device=device)
    return port.NARServer(
        cfg, session_schema, article_schema, model.state_dict(), stream,
        corpus.ace_matrix, corpus.metadata, device=device,
    )


def cuda_ms(fn, iters, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ugrnn_inputs(mask, dtype, seed):
    """Random x_proj / W_hh at the G1 RNN widths (T=19, U=255) for a CPU
    ``mask`` [B, T], all on the card."""
    g = torch.Generator().manual_seed(seed)
    (batch, t), units = mask.shape, 255
    x = torch.randn(batch, t, 2 * units, generator=g) * 0.5
    w = torch.randn(units, 2 * units, generator=g) * (2.0 / (3 * units)) ** 0.5
    return x.to(dtype).cuda(), w.to(dtype).cuda(), mask.cuda()


def ugrnn_bound_ms(x, w, mask):
    """Least time for the recurrence on these inputs: x read at valid steps,
    W_hh and the mask once, every output written once; f32 arithmetic
    (the kernel widens) of h.W_hh and the gates at valid steps only."""
    b, t, two_u = x.shape
    units = two_u // 2
    valid = int(mask.sum())
    size = x.element_size()
    n_bytes = (valid * two_u * size + w.numel() * w.element_size()
               + mask.numel() + b * t * units * size)
    n_ops = valid * units * (2 * two_u + 10)
    return max(n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_FLOP_PER_S) * 1e3, (
        "bytes" if n_bytes / H100_BYTES_PER_S > n_ops / H100_F32_FLOP_PER_S
        else "operations"
    )


def profile_recommend(server, sessions, pool, p50_ms, bs=32, calls=10):
    """Device time by kernel over ``calls`` recommend() calls (torch
    profiler, device-side events only), and that time's share of the
    unprofiled p50: the share of a request the card is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cand = np.broadcast_to(pool, (bs, NUM_CANDIDATES))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            server.recommend(sessions[:bs], candidates=cand, top_k=TOP_K)
    kernels = [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    if not kernels:
        print("profile: the profiler saw no device time")
        return
    busy_us = sum(k[1] for k in kernels) / calls
    launches = sum(k[2] for k in kernels) / calls
    print(f"profile recommend b{bs}: device busy {busy_us:.1f} us per call, "
          f"{launches:.0f} device kernels/copies per call; busy share of the "
          f"unprofiled p50 {busy_us / (p50_ms * 1e3):.3f}")
    for name, us, count in sorted(kernels, key=lambda k: -k[1])[:8]:
        print(f"  {us / calls:9.1f} us/call  x{count / calls:<5.1f} {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # without the package (the script alone) this raises before any output
    import chameleon_recsys_tpu_torch as port
    from chameleon_recsys_tpu_torch.data.synthetic import (
        make_synthetic_corpus,
        synthetic_hour_sessions,
    )
    from chameleon_recsys_tpu_torch.ops.kernels import build, ugrnn

    # the card's name and power limit, as nvidia-smi gives them
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    # float32 parity: matmuls in full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build every kernel of the path ----
    t0 = time.perf_counter()
    build.build(["ugrnn_fwd"])
    print(f"build: {time.perf_counter() - t0:.3f} s for ugrnn_fwd")
    log = build.build_log.get("ugrnn_fwd", "")
    registers = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
    if registers:
        print(f"  ptxas: {len(registers)} instantiations, registers "
              f"{min(registers)}-{max(registers)}, spill bytes {spills}")

    # ---- G1 server with a live stream ----
    cfg, session_schema, article_schema = g1_setup(port)
    corpus = make_synthetic_corpus(article_schema, ace_dim=250)
    sessions = synthetic_hour_sessions(
        corpus, session_schema, 0, 2 * cfg.batch_size, cfg.max_session_length
    )
    server = make_server(
        port, cfg, session_schema, article_schema, corpus, seed=0, device="cuda"
    )

    # ---- 3. the main path, counted ----
    captured = {}
    hook = server.model.rnn.register_forward_pre_hook(
        lambda module, args: captured.__setitem__(args[0].shape[0], args[1])
    )
    ugrnn.launches = 0
    server.observe(sessions[: cfg.batch_size])
    server.observe(sessions[cfg.batch_size:])
    pool = server.default_candidates(NUM_CANDIDATES)
    results = {}
    per_call = []
    for bs in SERVE_BATCHES:
        before = ugrnn.launches
        cand = np.broadcast_to(pool, (bs, NUM_CANDIDATES))
        results[bs] = server.recommend(sessions[:bs], candidates=cand, top_k=TOP_K)
        per_call.append(ugrnn.launches - before)
    torch.cuda.synchronize()
    main_launches = ugrnn.launches
    hook.remove()
    print(f"main path: ugrnn_fwd launches {main_launches}, per recommend {per_call}")
    check(per_call == [cfg.rnn_num_layers] * len(SERVE_BATCHES),
          f"UGRNN kernel launches per recommend {per_call}")
    check(int((pool != 0).sum()) == NUM_CANDIDATES, "live pool under 500 items")
    pool_ids = set(pool.tolist()) - {0}
    for bs, (ids, scores) in results.items():
        check(ids.shape == (bs, TOP_K) and scores.shape == (bs, TOP_K),
              f"batch {bs}: shapes {ids.shape} {scores.shape}")
        check(np.isfinite(scores).all(), f"batch {bs}: non-finite scores")
        check(set(ids.reshape(-1).tolist()) <= pool_ids, f"batch {bs}: ids off pool")
        check((np.diff(scores, axis=1) <= 0).all(), f"batch {bs}: scores unsorted")
        for row in ids:
            check(len(set(row.tolist())) == TOP_K, f"batch {bs}: repeated ids")
        print(f"recommend b{bs}: ids[0] {ids[0].tolist()} "
              f"scores[0][:3] {scores[0][:3].tolist()}")

    # ---- 2. each kernel against its plain twin at the serving shapes ----
    serve_mask = captured[max(SERVE_BATCHES)]
    g = torch.Generator().manual_seed(1)
    lengths = torch.randint(1, serve_mask.shape[1] + 1, (256,), generator=g)
    train_like_mask = torch.arange(serve_mask.shape[1])[None] < lengths[:, None]
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
    errors = {}
    for name, mask in (("b32_serve", serve_mask.cpu()), ("b256", train_like_mask)):
        for dtype in (torch.bfloat16, torch.float32):
            x, w, m = ugrnn_inputs(mask, dtype, seed=2)
            out = ugrnn.ugrnn_scan_kernel(x, w, m)
            ref = ugrnn.ugrnn_scan_reference(x, w, m)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            errors[(name, dtype)] = err
            print(f"ugrnn_fwd vs plain [{mask.shape[0]},19,510] {dtype}: "
                  f"max_abs_err {err:.3e} (tolerance {tolerance[dtype]:.0e})")
            check(err <= tolerance[dtype], f"ugrnn_fwd disagrees: {err}")

    # ---- 4. served scores against the CPU on a small float32 input ----
    tcfg, tsess, tart = tiny_setup(port)
    tcorpus = make_synthetic_corpus(tart, ace_dim=8)
    tsessions = synthetic_hour_sessions(tcorpus, tsess, 0, 24, tcfg.max_session_length)
    tcand = np.stack([
        np.random.RandomState(i).choice(np.arange(1, 200), 30, replace=False)
        for i in range(6)
    ]).astype(np.int32)
    outs = {}
    for device in ("cpu", "cuda"):
        tserver = make_server(port, tcfg, tsess, tart, tcorpus, seed=3, device=device)
        tserver.observe(tsessions[:16])
        outs[device] = tserver.recommend(tsessions[16:22], candidates=tcand, top_k=30)
    (cpu_ids, cpu_scores), (gpu_ids, gpu_scores) = outs["cpu"], outs["cuda"]
    score_err = float(np.abs(gpu_scores - cpu_scores).max())
    gaps = np.abs(np.diff(cpu_scores, axis=1))
    separated = np.ones(cpu_scores.shape, bool)
    separated[:, 1:] &= gaps > 1e-5
    separated[:, :-1] &= gaps > 1e-5
    print(f"small f32 serve, card vs CPU: max score diff {score_err:.3e} "
          f"(tolerance rtol 1e-4 + atol 1e-6)")
    check(np.allclose(gpu_scores, cpu_scores, rtol=1e-4, atol=1e-6),
          "small serve: card and CPU scores disagree")
    check((gpu_ids[separated] == cpu_ids[separated]).all(),
          "small serve: card and CPU rankings disagree")

    # ---- 5. times ----
    x, w, m = ugrnn_inputs(serve_mask.cpu(), torch.bfloat16, seed=2)
    kernel_ms = cuda_ms(lambda: ugrnn.ugrnn_scan_kernel(x, w, m), iters=200)
    plain_ms = cuda_ms(lambda: ugrnn.ugrnn_scan_reference(x, w, m), iters=20)
    bound_ms, bound_by = ugrnn_bound_ms(x, w, m)
    print(f"ugrnn_fwd [32,19,510] bf16: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    for mask in (serve_mask[:1].cpu(), train_like_mask):
        xb, wb, mb = ugrnn_inputs(mask, torch.bfloat16, seed=2)
        ms = cuda_ms(lambda: ugrnn.ugrnn_scan_kernel(xb, wb, mb), iters=100)
        bms, _ = ugrnn_bound_ms(xb, wb, mb)
        print(f"ugrnn_fwd [{mask.shape[0]},19,510] bf16: kernel {ms:.4f} ms, "
              f"bound {bms:.5f} ms")
    p50 = {}
    for bs in SERVE_BATCHES:
        cand = np.broadcast_to(pool, (bs, NUM_CANDIDATES))
        times = []
        for i in range(105):
            t0 = time.perf_counter()
            server.recommend(sessions[:bs], candidates=cand, top_k=TOP_K)
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        p50[bs] = statistics.median(times)
        print(f"recommend b{bs} (host clock, synchronised): p50 "
              f"{p50[bs]:.3f} ms, p99 {times[98]:.3f} ms, max {times[-1]:.3f} ms "
              f"over {len(times)} calls")
    profile_recommend(server, sessions, pool, p50[32])

    print(json.dumps({"kernels": [{
        "name": "ugrnn_fwd",
        "route": "cuda",
        "source": "chameleon_recsys_tpu_torch/csrc/ugrnn_fwd.cu",
        "replaces": "chameleon_recsys_tpu/ops/pallas/ugrnn_pallas.py:51",
        "launches": main_launches,
        "max_abs_err": errors[("b32_serve", torch.bfloat16)],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

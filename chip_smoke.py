#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths at the G1 configuration's full width with random
weights from a seed, the serving path (``NARServer.observe`` / ``recommend``),
the eval step (``train.steps.eval_step``), the train step
(``train.steps.train_step``, valid-row compaction at the bench's capacity,
with the fused scorer's nc stash and without it) and the temporal harness
(``train.temporal.TemporalHarness``: hour-by-hour train and eval with two
baselines, checkpoint/resume, ``NARServer.from_checkpoint``), and every
hand-written kernel of those paths:

1. builds each kernel from ``chameleon_recsys_tpu_torch/csrc`` (one ``nvcc``
   per source, started together) and reports the build time and what ptxas
   says of each (registers, spills; the forward's and the backward's entries
   one by one, with the dynamic shared memory of the forward and of the
   backward's row kernel at the G1 widths),
   and what the scorer's gate (``cand_scorer.kernel_takes``) says of the G1
   widths;
2. serving, counted: zeroes the launch counters, observes 2 x 256 synthetic
   sessions and recommends top-10 of 500 candidates at batch 1 and 32, reads
   the counters (the UGRNN kernel must launch twice per ``recommend``, on
   its resident instantiation; on every counted path the UGRNN kernels must
   run resident only, ``ugrnn.resident_takes``) and checks every result
   (shape, finite, ids from the pool, scores sorted);
3. eval, counted: warms a stream over two synthetic hours, zeroes the
   counters, runs ``eval_step`` over four batches of 256 sessions of the next
   hour, reads the counters (per step the fused scorer once, the UGRNN
   kernel twice) and checks the metrics and rankings;
4. train, counted: warms a stream over two synthetic hours, sizes the
   valid-row capacity as ``bench.py`` does (the largest valid-click count of
   the batches, rounded up to 128, at most B*T), zeroes the counters, runs
   two train steps (per step the scorer's stash forward once, its backward
   once, the UGRNN forward and backward twice each, no eval forward), checks
   that no click is dropped and every loss is finite, then trains 20 steps
   on one batch and checks that the loss falls; then measures the peak
   device memory of one step with the stash on and off and runs two
   counted steps with ``_STASH_NC`` off (per step the eval forward and the
   backward that recomputes nc once each, no stash forward or backward);
5. the temporal harness, counted: hours 0-3 of 512 synthetic sessions, one
   training hour per eval, recently popular and sequential rules beside
   CHAMELEON; checks the launches, the device HR/MRR against the host
   suite's and the stream's restore after every eval, and prints each eval
   row, the train throughput and each eval hour's wall time and phases;
   then saves a checkpoint, loads it into a fresh harness, serves a
   batch-32 request from the file (``NARServer.from_checkpoint``) against a
   server on the live model, and trains and evaluates one more hour on
   both harnesses, then on two resumes with a planted fault (the sampler's
   generator re-seeded, Adam's state dropped) that the resume check must
   catch;
6. holds each kernel against its plain PyTorch twin on the card: the UGRNN
   forward at batch 1, 32 and 256 and the backward at the train shape (from
   the forward's f32 stash, against the twin that recomputes the gates; the
   stash against that recompute), the UGRNN streaming instantiations at
   widths past the resident layout (700 and 1024 units), the fused scorer
   forward on the operands of the eval path's first step (bf16, rebuilt by
   ``train.steps.eval_scorer_operands``), its stash forward, backward and
   recompute backward on the operands of the train path's first step
   (``train_scorer_operands``; the recompute backward also bit for bit
   against the stash backward on the stash forward's nc), and all of them on
   random operands at the G1 shapes, a float32 shape and an odd shape;
7. checks the served scores, one eval step and one train step against the
   same code on the CPU, where the kernel wrappers run their plain twins, on
   a small float32 input;
8. times each kernel, its plain twin, ``recommend``, the eval step and the
   train step (with the stash and without) with CUDA events or a
   synchronised host clock, and breaks one request, one eval step and one
   train step with the stash and one without down by device kernel (torch
   profiler); fails unless two launches of the scorer's forward (K1f on the
   eval operands, K1fs on the train operands) give the same bits; times
   ``torch.matmul`` of the CAR product alone at the eval shape (the
   yardstick of that part of K1f, on a line of its own) and splits one K1f
   by device launch; times the UGRNN forward at batch 1, 32 and 256 (bf16,
   f32 at 32 and 256; with the training outputs and without; bf16 also at
   T 1, 4 and 19) beside its chain floor (the resident layout's exchange
   and cluster barriers alone, ``ugrnn_chain_floor``) and its clusters, and
   the UGRNN backward at the train batch, failing unless two launches give
   the same bits: by CUDA events over calls queued behind a device-side
   wait (``queued_ms``: the host's dispatch leaves no gaps), before any
   profiler session; after the train step's profiles, splits the UGRNN
   backward by launch (the chain, dW_hh's partials, their sum) and times
   its chain launch at T 1, 4 and 19 (torch profiler, every record kept:
   a session that is not ``calls`` repeats of one launch sequence is
   profiled again, eight times at most);
9. holds the scorer backward's GEMM core (``csrc/sm90_gemm.cuh``) alone
   against ``torch.matmul`` at dpre's shape (134,400 x 1024 by 1024^T, bf16)
   and times both (its own line: it is no TPU kernel), splits one backward
   (K1b) at the train path's operands by device launch (torch profiler),
   and fails unless two backward launches on those operands give the same
   bits.

Prints the card's name and power limit first, a JSON line of per-kernel
numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits 1 before printing any result.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM
H100_F32_FLOP_PER_S = 67e12  # CUDA cores, no tensor cores
H100_BF16_FLOP_PER_S = 989e12  # tensor cores, dense
# queued_ms: the card waits this many cycles a timed call (0.25 ms at 2 GHz)
# while the host queues the calls
QUEUE_CYCLES_PER_CALL = 500_000
SERVE_BATCHES = (1, 32)
NUM_CANDIDATES = 500
TOP_K = 10
EVAL_BATCHES = 4
TRAIN_STEPS = 2  # counted, over two batches
LOSS_STEPS = 20  # on one batch: the loss must fall
HARNESS_SESSIONS = 512  # sessions an hour: two batches of 256
HARNESS_HOURS = 4  # hours 0-3: train four hours, evaluate three
# a resumed hour against the original: the loss's relative difference, HR's
# and MRR's, the largest parameter difference after the hour's training.
# pool_gather's index_add_ backward sums with atomics on the card, so a
# sound resume may differ in the last f32 bits (read on an H100: parameters
# 5.2e-7, the rest 0); a re-seeded generator or dropped Adam state read
# loss >= 2.2e-4, HR >= 3.9e-4, MRR >= 1.7e-3, parameters >= 2.8e-4.  HR and
# MRR allow about one ranked click of ~5,000 to flip
RESUME_TOL = {"loss": 1e-5, "hr": 2.5e-4, "mrr": 2.5e-4, "param": 1e-5}
KERNELS = ("ugrnn_fwd", "ugrnn_bwd", "cand_score_fwd", "cand_score_bwd")  # sources
KERNEL_NAMES = ("ugrnn_fwd", "ugrnn_bwd", "cand_score_fwd", "cand_score_fwd_stash",
                "cand_score_bwd", "cand_score_bwd_recompute")
# the UGRNN kernels' instantiations (ugrnn.resident_takes picks one per
# width): the G1 paths must run the resident ones only
UGRNN_INSTANTIATIONS = ("ugrnn_fwd_resident", "ugrnn_fwd_stream", "ugrnn_bwd_resident",
                        "ugrnn_bwd_stream")
ROOT = Path(__file__).resolve().parent
SCORER_GRADS = ("di", "du", "dp", "dcar_w", "dcar_b", "dw1", "db1", "dw2",
                "db2", "dw3", "db3", "dw4")


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
    """A small float32 configuration for the CPU-vs-card checks; three
    matching layers, so that eval reaches the fused scorer."""
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
        matching_layer_sizes=(16, 8, 8), recent_clicks_buffer_max_size=128,
        recent_clicks_for_normalization=64, batch_size=8, max_session_length=8,
        eval_negative_samples=5, eval_negative_sample_from_buffer=30,
        negative_samples=5, negative_sample_from_buffer=30,
        metrics_top_n=4, use_pallas_rnn=True, use_pallas_scorer=True,
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


def to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def warm_stream(stream, batches, cfg, device):
    """Fold the clicks of collated ``batches`` into ``stream``."""
    from chameleon_recsys_tpu_torch.state.stream_state import update_stream_state
    from chameleon_recsys_tpu_torch.train.steps import _batch_all_clicks

    for batch in batches:
        stream = update_stream_state(
            stream, *_batch_all_clicks(to_device(batch, device)), cfg
        )
    return stream


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


def queued_ms(fn, iters, warmup=5):
    """Device ms of one ``fn()`` by CUDA events over ``iters`` back-to-back
    calls queued behind a device-side wait (``torch.cuda._sleep``), so that
    the host's dispatch leaves no gap between them: the kernels' own time,
    also where the host dispatches a call more slowly than the card runs it.
    Fails unless the card was still waiting when the host had queued every
    call (the wait is lengthened and the timing repeated twice first)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = QUEUE_CYCLES_PER_CALL * iters
    for _ in range(3):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 4
    check(False, f"queued_ms: the card caught up with the host over {iters} calls")


def ugrnn_inputs(mask, dtype, seed, units=255):
    """Random x_proj / W_hh at the G1 RNN widths (T=19, U=255, or ``units``)
    for a CPU ``mask`` [B, T], all on the card."""
    g = torch.Generator().manual_seed(seed)
    batch, t = mask.shape
    x = torch.randn(batch, t, 2 * units, generator=g) * 0.5
    w = torch.randn(units, 2 * units, generator=g) * (2.0 / (3 * units)) ** 0.5
    return x.to(dtype).cuda(), w.to(dtype).cuda(), mask.cuda()


def ugrnn_bwd_inputs(mask, dtype, seed=7):
    """The UGRNN backward's operands on the card: ``ugrnn_inputs``, the
    forward kernel's f32 states and stash, and a seeded cotangent."""
    from chameleon_recsys_tpu_torch.ops.kernels import ugrnn

    x, w, m = ugrnn_inputs(mask, dtype, seed)
    _, hs, acts = ugrnn.ugrnn_scan_kernel(x, w, m, return_acts=True)
    g = (torch.randn(*hs.shape, generator=torch.Generator().manual_seed(seed + 1))
         .to(dtype).cuda())
    return x, w, m, hs, acts, g


def bound(n_bytes, n_ops, flop_per_s):
    """(least ms for the work, what bounds it)."""
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_ops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


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
    return bound(n_bytes, n_ops, H100_F32_FLOP_PER_S)


def cand_score_bound_ms(operands):
    """(least ms, what bounds it, operations) for the fused scorer on these
    operands: every input read once and the [N] f32 scores written once;
    2 N (C C + C M1 + M1 M2 + M2 M3) + 2 N M3 operations at the dtype's
    peak (bf16 tensor cores, or f32 CUDA cores: the kernel uses no TF32)."""
    i_rows, _, _, _, _, w1, _, w2, _, w3 = operands[:10]
    n, c = i_rows.shape
    m1, m2, m3 = w1.shape[1], w2.shape[1], w3.shape[1]
    n_bytes = sum(t.numel() * t.element_size() for t in operands) + n * 4
    n_ops = 2 * n * (c * c + c * m1 + m1 * m2 + m2 * m3) + 2 * n * m3
    rate = (H100_BF16_FLOP_PER_S if i_rows.dtype == torch.bfloat16
            else H100_F32_FLOP_PER_S)
    return bound(n_bytes, n_ops, rate) + (n_ops,)


def _scorer_rate(dtype):
    return H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 else H100_F32_FLOP_PER_S


def cand_score_stash_bound_ms(operands):
    """(least ms, what bounds it) for the training forward: the forward's
    work, plus the [N, C] nc written once."""
    i_rows = operands[0]
    _, _, n_ops = cand_score_bound_ms(operands)
    n_bytes = (sum(t.numel() * t.element_size() for t in operands)
               + i_rows.shape[0] * 4 + i_rows.numel() * i_rows.element_size())
    return bound(n_bytes, n_ops, _scorer_rate(i_rows.dtype))


def cand_score_bwd_bound_ms(operands):
    """(least ms, what bounds it) for the scorer's backward: the 12
    operands, nc and the f32 cotangent read once, the 12 gradients written
    once; 2 N (2 C C + 3 C M1 + 3 M1 M2 + 3 M2 M3) operations (the two
    C-wide products of the CAR layer, three of each matching layer)."""
    i_rows, _, _, _, _, w1, _, w2, _, w3 = operands[:10]
    n, c = i_rows.shape
    m1, m2, m3 = w1.shape[1], w2.shape[1], w3.shape[1]
    operand_bytes = sum(t.numel() * t.element_size() for t in operands)
    n_bytes = 2 * operand_bytes + i_rows.numel() * i_rows.element_size() + n * 4
    n_ops = 2 * n * (2 * c * c + 3 * c * m1 + 3 * m1 * m2 + 3 * m2 * m3)
    return bound(n_bytes, n_ops, _scorer_rate(i_rows.dtype))


def cand_score_bwd_recompute_bound_ms(operands):
    """(least ms, what bounds it) for the backward that recomputes nc: the
    12 operands and the f32 cotangent read once, the 12 gradients written
    once (no nc read); K1b's operations plus the CAR product once more,
    2 N (3 C C + 3 C M1 + 3 M1 M2 + 3 M2 M3)."""
    i_rows, _, _, _, _, w1, _, w2, _, w3 = operands[:10]
    n, c = i_rows.shape
    m1, m2, m3 = w1.shape[1], w2.shape[1], w3.shape[1]
    operand_bytes = sum(t.numel() * t.element_size() for t in operands)
    n_bytes = 2 * operand_bytes + n * 4
    n_ops = 2 * n * (3 * c * c + 3 * c * m1 + 3 * m1 * m2 + 3 * m2 * m3)
    return bound(n_bytes, n_ops, _scorer_rate(i_rows.dtype))


def ugrnn_bwd_bound_ms(x, w, mask):
    """Least time for the UGRNN backward on these inputs: the forward's f32
    pre-activations read at valid steps, W_hh and the mask once, the f32
    states and the cotangent read once, dx_proj and dW_hh written once; f32
    arithmetic of the carry and dW_hh (2 x 2 U 2U) and the gates at valid
    steps only (the gate recompute, h_prev . W_hh, is the forward's stash)."""
    b, t, two_u = x.shape
    units = two_u // 2
    valid = int(mask.sum())
    size = x.element_size()
    n_bytes = (valid * two_u * 4 + 2 * w.numel() * w.element_size()
               + mask.numel() + b * t * units * (4 + size) + b * t * two_u * size)
    n_ops = valid * units * (2 * 2 * two_u + 20)
    return bound(n_bytes, n_ops, H100_F32_FLOP_PER_S)


def ugrnn_chain_floor_ms(batch, dtype, t=19, units=255):
    """Device ms (``queued_ms``) of the resident forward's chain alone at
    (batch, t, units): the same clusters running t steps of the h exchange
    and cluster barriers, no arithmetic (``ugrnn_chain_floor``)."""
    from chameleon_recsys_tpu_torch.ops.kernels import build

    fn = build.load("ugrnn_fwd").ugrnn_chain_floor
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    sink = torch.empty(1 << 16, dtype=torch.float32, device="cuda")
    code = 1 if dtype == torch.bfloat16 else 0

    def run():
        err = fn(batch, t, units, code, sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"ugrnn_chain_floor launch failed: cudaError {err}")

    return queued_ms(run, iters=200)


def ugrnn_fwd_layout(batch, dtype, units=255):
    """(CTAs a cluster, batch rows a cluster) of the resident forward's
    launch at this batch (``ugrnn_fwd_layout``)."""
    from chameleon_recsys_tpu_torch.ops.kernels import build

    fn = build.load("ugrnn_fwd").ugrnn_fwd_layout
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    layout = (ctypes.c_int * 2)()
    check(fn(batch, units, 1 if dtype == torch.bfloat16 else 0, layout) == 1,
          f"no resident forward layout at batch {batch}")
    return tuple(layout)


def close_normwise(out, ref, tol, outliers=1e-4):
    """(ok, max abs error, normwise error, elements off): ||out - ref|| within
    tol ||ref|| and at most a share ``outliers`` of the elements off by more
    than tol max|ref| (leaky_relu's derivative jumps at 0, and a
    pre-activation within f32 summation noise of 0 takes the other slope in
    one of the two sums)."""
    diff = (out.float() - ref.float()).abs()
    scale = max(ref.float().abs().max().item(), 1e-30)
    norm_err = (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()
    off = int((diff > tol * scale).sum())
    ok = norm_err <= tol and off <= outliers * diff.numel()
    return ok, diff.max().item(), norm_err, off


def check_scorer_train_kernels(name, operands, g, tol):
    """The stash forward and the backward against their twins on one set of
    operands; returns (nc max error, the backward's largest max error)."""
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer

    scores, nc = cand_scorer.cand_score_kernel(*operands, return_nc=True)
    ref_scores, ref_nc = cand_scorer.cand_score_reference(*operands, return_nc=True)
    torch.cuda.synchronize()
    nc_tol = 1e-5 if nc.dtype == torch.float32 else 2.0 ** -8
    nc_err = (nc.float() - ref_nc.float()).abs().max().item()
    score_err = (scores - ref_scores).abs().max().item()
    score_tol = tol * max(ref_scores.abs().max().item(), 1e-30)
    print(f"cand_score_fwd (stash) vs plain {name} {list(operands[0].shape)} "
          f"{operands[0].dtype}: nc max_abs_err {nc_err:.3e} (tolerance "
          f"{nc_tol:.3e}), scores {score_err:.3e} (tolerance {score_tol:.3e})")
    check(nc_err <= nc_tol and score_err <= score_tol,
          f"cand_score_fwd (stash) disagrees on {name}")
    del scores, nc, ref_scores
    grads = cand_scorer.cand_score_bwd_kernel(*operands, ref_nc, g)
    ref = cand_scorer.cand_score_bwd_reference(*operands, ref_nc, g)
    torch.cuda.synchronize()
    worst = 0.0
    report = []
    for gname, got, want in zip(SCORER_GRADS, grads, ref):
        ok, err, norm_err, off = close_normwise(got, want, tol)
        worst = max(worst, err)
        report.append(f"{gname} {err:.2e}/{norm_err:.1e}/{off}")
        check(ok, f"cand_score_bwd disagrees on {name}: {gname} max {err:.3e}, "
                  f"normwise {norm_err:.3e}, {off} elements off")
    print(f"cand_score_bwd vs plain {name} {operands[0].dtype} (output max_abs_err/"
          f"normwise/elements beyond {tol} x max|ref|): " + ", ".join(report))
    return nc_err, worst


def check_recompute_kernel(name, operands, g, tol):
    """The backward that recomputes nc against its twin (K1b's normwise
    tolerance and outlier share), and against the stash backward on the nc
    the stash forward writes, which it must equal bit for bit; returns the
    largest max error against the twin."""
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer

    grads = cand_scorer.cand_score_bwd_recompute_kernel(*operands, g)
    ref = cand_scorer.cand_score_bwd_reference(*operands, None, g)
    torch.cuda.synchronize()
    worst = 0.0
    report = []
    for gname, got, want in zip(SCORER_GRADS, grads, ref):
        ok, err, norm_err, off = close_normwise(got, want, tol)
        worst = max(worst, err)
        report.append(f"{gname} {err:.2e}/{norm_err:.1e}/{off}")
        check(ok, f"cand_score_bwd_recompute disagrees on {name}: {gname} max "
                  f"{err:.3e}, normwise {norm_err:.3e}, {off} elements off")
    del ref
    _, nc = cand_scorer.cand_score_kernel(*operands, return_nc=True)
    stash = cand_scorer.cand_score_bwd_kernel(*operands, nc, g)
    torch.cuda.synchronize()
    vs_stash = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(grads, stash))
    print(f"cand_score_bwd_recompute vs plain {name} {operands[0].dtype} (output "
          f"max_abs_err/normwise/elements beyond {tol} x max|ref|): "
          + ", ".join(report) + f"; largest difference from cand_score_bwd on "
          f"the stash forward's nc: {vs_stash:.3e}")
    check(vs_stash == 0.0, f"cand_score_bwd_recompute differs from cand_score_bwd "
                           f"on {name} by {vs_stash:.3e}")
    return worst


def scorer_inputs(bt, k, c, m1, m2, m3, dtype, seed):
    """Random fused-scorer operands on the card, scaled as the model's
    initialisers scale them."""
    g = torch.Generator().manual_seed(seed)

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype).cuda()

    return [
        mk(bt * k, c, scale=0.5), mk(bt, c, scale=0.5), mk(bt, c, scale=0.5),
        mk(c, c, scale=c ** -0.5), mk(c, scale=0.1),
        mk(c, m1, scale=(2 / c) ** 0.5), mk(m1, scale=0.1),
        mk(m1, m2, scale=(2 / m1) ** 0.5), mk(m2, scale=0.1),
        mk(m2, m3, scale=(2 / m2) ** 0.5), mk(m3, scale=0.1),
        mk(m3, scale=m3 ** -0.5),
    ]


def launch_split(fn, calls):
    """[(kernel name, mean device us)] for each launch of one ``fn()`` call,
    in launch order, over ``calls`` profiled calls (torch profiler, device
    events only).  A session counts only where its device events are
    ``calls`` repeats of one launch sequence, every record kept; the
    profiler now and then records no device event, or one of an earlier
    session, so a session that is not is profiled again, and after eight
    such sessions the split fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        per_call = len(events) // calls
        if (events and per_call * calls == len(events)
                and names == names[:per_call] * calls):
            return [
                (events[i].name,
                 sum(events[c * per_call + i].time_range.elapsed_us()
                     for c in range(calls)) / calls)
                for i in range(per_call)
            ]
        print(f"launch split: {len(events)} device events over {calls} calls, not "
              f"{calls} repeats of one sequence; profiling again")
    check(False, f"launch split: no even session in eight over {calls} calls: "
                 + ", ".join(f"{name[:60]} x{n}" for name, n in
                             collections.Counter(e.name for e in events).items()))


def print_split(label, split):
    total = sum(us for _, us in split)
    print(f"split {label}: {len(split)} launches, {total / 1e3:.4f} ms device time")
    for i, (name, us) in enumerate(split):
        short = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        print(f"  {i:2d} {us / 1e3:9.4f} ms  {short.split('(')[0][:90]}")


def ptxas_entries(log):
    """(kernel, registers, spill store bytes, static shared bytes) for each
    entry function in an ``nvcc -Xptxas -v`` log."""
    entries = []
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'")[0]
        registers = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores", block)
        smem = re.search(r"(\d+) bytes smem", block)
        entries.append((name, int(registers.group(1)) if registers else 0,
                        int(spills.group(1)) if spills else 0,
                        int(smem.group(1)) if smem else 0))
    return entries


def device_profile(label, fn, calls, host_ms):
    """Device time by kernel over ``calls`` calls of ``fn`` (torch profiler,
    device-side events only), and that time's share of the unprofiled
    ``host_ms`` per call: the share of a call the card is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    if not kernels:
        print(f"profile {label}: the profiler saw no device time")
        return
    busy_us = sum(k[1] for k in kernels) / calls
    launches = sum(k[2] for k in kernels) / calls
    print(f"profile {label}: device busy {busy_us:.1f} us per call, "
          f"{launches:.0f} device kernels/copies per call; busy share of the "
          f"unprofiled {host_ms:.3f} ms {busy_us / (host_ms * 1e3):.3f}")
    for name, us, count in sorted(kernels, key=lambda k: -k[1])[:8]:
        print(f"  {us / calls:9.1f} us/call  x{count / calls:<5.1f} {name[:100]}")


def gemm_core_phase(rows, c):
    """The scorer backward's GEMM core (``csrc/sm90_gemm.cuh``) alone at
    dpre's shape, C = A B^T with A [rows, c] and B [c, c] in bf16 (random,
    seeded), against ``torch.matmul`` of the same operands: the max error
    (tolerance one bf16 rounding of the largest |C| plus f32 noise), the
    core's ms and TFLOP/s and torch.matmul's ms as the product's yardstick,
    on one line of its own."""
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer

    g = torch.Generator().manual_seed(40)
    a = torch.randn(rows, c, generator=g).to(torch.bfloat16).cuda()
    b = (torch.randn(c, c, generator=g) * c ** -0.5).to(torch.bfloat16).cuda()
    out = cand_scorer.sm90_gemm_kernel(a, b)
    ref = a.float() @ b.float().T
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    tol = 2.0 ** -8 * ref.abs().max().item() + 1e-3
    del out, ref
    core_ms = cuda_ms(lambda: cand_scorer.sm90_gemm_kernel(a, b), iters=20)
    matmul_ms = cuda_ms(lambda: torch.matmul(a, b.T), iters=20)
    flop = 2 * rows * c * c
    print("gemm core " + json.dumps({
        "source": "chameleon_recsys_tpu_torch/csrc/sm90_gemm.cuh",
        "shape": [rows, c, c], "max_abs_err": err, "tolerance": tol,
        "ms": core_ms, "tflop_per_s": flop / core_ms / 1e9,
        "library_ms": matmul_ms, "library_tflop_per_s": flop / matmul_ms / 1e9,
    }))
    check(err <= tol, f"the GEMM core disagrees with torch.matmul: {err} > {tol}")


def check_eval_outputs(step, batch, metrics, fetches, cfg):
    """One eval step's results at G1: finite metrics that agree with the
    batch, rankings that permute each step's candidates, probabilities
    sorted and summing to one, and no negative clicked in its own session."""
    from chameleon_recsys_tpu_torch.train.steps import valid_click_mask

    for key, value in metrics.items():
        check(bool(torch.isfinite(value.float()).all()),
              f"eval step {step}: {key} not finite")
    mask = valid_click_mask(batch["session_size"], cfg.max_inputs_length)
    label_count = float(metrics["label_count"])
    check(label_count == float(mask.sum()),
          f"eval step {step}: label_count {label_count} != valid clicks")
    check(0 <= float(metrics["hit_sum"]) <= label_count,
          f"eval step {step}: hit_sum out of range")
    ids, probs = fetches["predicted_ids"], fetches["predicted_probs"]
    cand = torch.cat([fetches["labels"][..., None], fetches["neg_items"]], -1)
    check(ids.shape == cand.shape == probs.shape
          and ids.shape[-1] == cfg.eval_negative_samples + 1,
          f"eval step {step}: shapes {tuple(ids.shape)} {tuple(cand.shape)}")
    check(torch.equal(ids.sort(-1).values, cand.sort(-1).values),
          f"eval step {step}: a ranking is not a permutation of its candidates")
    check(bool((probs[..., 1:] <= probs[..., :-1]).all()),
          f"eval step {step}: probabilities not sorted")
    check(float((probs.sum(-1) - 1).abs().max()) <= 1e-5,
          f"eval step {step}: probabilities do not sum to 1")
    all_clicked = torch.cat([batch["item_clicked"], batch["label_last_item"]], 1)
    neg = fetches["neg_items"]
    own = ((neg[..., None] == all_clicked[:, None, None, :]).any(-1)
           & (neg != 0) & mask[..., None])
    check(not bool(own.any()), f"eval step {step}: a negative from its own session")


def hour_batches(corpus, session_schema, cfg, hour, n):
    """Collated (numpy) batches of ``n`` synthetic sessions of ``hour``."""
    from chameleon_recsys_tpu_torch.data.collate import batches_from_sessions
    from chameleon_recsys_tpu_torch.data.synthetic import synthetic_hour_sessions

    b, length = cfg.batch_size, cfg.max_session_length
    return list(batches_from_sessions(
        synthetic_hour_sessions(corpus, session_schema, hour, n, length),
        session_schema, b, length,
    ))


def launch_counts():
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer, ugrnn

    return {
        "cand_score_fwd": cand_scorer.launches,
        "cand_score_fwd_stash": cand_scorer.stash_launches,
        "cand_score_bwd": cand_scorer.bwd_launches,
        "cand_score_bwd_recompute": cand_scorer.bwd_recompute_launches,
        "ugrnn_fwd": ugrnn.launches,
        "ugrnn_bwd": ugrnn.bwd_launches,
        "ugrnn_fwd_resident": ugrnn.resident_launches,
        "ugrnn_fwd_stream": ugrnn.stream_launches,
        "ugrnn_bwd_resident": ugrnn.bwd_resident_launches,
        "ugrnn_bwd_stream": ugrnn.bwd_stream_launches,
    }


def zero_launch_counts():
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer, ugrnn

    cand_scorer.launches = cand_scorer.stash_launches = cand_scorer.bwd_launches = 0
    cand_scorer.bwd_recompute_launches = 0
    ugrnn.launches = ugrnn.bwd_launches = 0
    ugrnn.resident_launches = ugrnn.stream_launches = 0
    ugrnn.bwd_resident_launches = ugrnn.bwd_stream_launches = 0


def ugrnn_expected(fwd, bwd):
    """The UGRNN counts of a G1 path with ``fwd`` forward and ``bwd``
    backward launches: every one on the resident instantiation."""
    return {"ugrnn_fwd": fwd, "ugrnn_bwd": bwd, "ugrnn_fwd_resident": fwd,
            "ugrnn_fwd_stream": 0, "ugrnn_bwd_resident": bwd, "ugrnn_bwd_stream": 0}


def train_capacity(batches, cfg):
    """``bench.py``'s capacity: the largest valid-click count of the
    batches, rounded up to 128 rows, at most B*T."""
    from chameleon_recsys_tpu_torch.train.steps import valid_click_mask

    t = cfg.max_inputs_length
    max_valid = max(int(valid_click_mask(b["session_size"], t).sum()) for b in batches)
    return min(-(-max_valid // 128) * 128, cfg.batch_size * t)


def train_phase(port, server, cfg, session_schema, article_schema, corpus):
    """The train path at G1 width, counted: a stream warmed over two hours,
    two train steps over two batches of the next hour, then 20 steps on one
    batch.  Returns the launch counts of the counted run, the train state
    after it all, the batches, the first step's scorer operands and the
    capacity."""
    from chameleon_recsys_tpu_torch.state.stream_state import init_stream_state
    from chameleon_recsys_tpu_torch.train.steps import (
        init_train_state,
        train_scorer_operands,
        train_step,
    )

    b = cfg.batch_size
    warm = warm_stream(
        init_stream_state(cfg, corpus.num_items, device="cuda"),
        hour_batches(corpus, session_schema, cfg, 0, 2 * b)
        + hour_batches(corpus, session_schema, cfg, 1, 2 * b), cfg, "cuda",
    )
    batches = [to_device(batch, "cuda") for batch in
               hour_batches(corpus, session_schema, cfg, 3, TRAIN_STEPS * b)]
    capacity = train_capacity(batches, cfg)
    tcfg = dataclasses.replace(cfg, train_valid_row_capacity=capacity)
    model = port.NARModel(tcfg, session_schema, article_schema,
                          corpus.ace_matrix.shape[1]).to("cuda")
    model.load_state_dict(server.model.state_dict())
    seed = 21
    # the first step's scorer operands: the same model, stream, batch and
    # generator seed draw the same negatives (the UGRNN forward runs here,
    # before the counters are zeroed)
    operands = train_scorer_operands(
        model, warm, batches[0], server.ace_matrix, server.metadata,
        generator=torch.Generator(device="cuda").manual_seed(seed),
    )
    torch.cuda.synchronize()

    zero_launch_counts()
    state = init_train_state(model, warm, torch.Generator(device="cuda").manual_seed(seed))
    per_step = []
    for i in range(TRAIN_STEPS):
        before = launch_counts()
        state, metrics = train_step(state, batches[i % len(batches)],
                                    server.ace_matrix, server.metadata)
        torch.cuda.synchronize()
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        values = {k: float(v) for k, v in metrics.items()}
        print(f"train step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in values.items()))
        check(all(np.isfinite(v) for v in values.values()),
              f"train step {i}: a metric is not finite")
        check(values["dropped_clicks"] == 0, f"train step {i}: clicks dropped")
        check(values["clicks"] <= capacity, f"train step {i}: clicks over capacity")
    counts = launch_counts()
    expected = {"cand_score_fwd": 0, "cand_score_fwd_stash": 1, "cand_score_bwd": 1,
                "cand_score_bwd_recompute": 0, **ugrnn_expected(cfg.rnn_num_layers,
                                                                cfg.rnn_num_layers)}
    print(f"train path (capacity {capacity} rows of {b * cfg.max_inputs_length}): "
          f"launches {counts}, per step {per_step}")
    check(per_step == [expected] * TRAIN_STEPS,
          f"kernel launches per train step {per_step}")

    losses = []
    for _ in range(LOSS_STEPS):
        state, metrics = train_step(state, batches[0], server.ace_matrix,
                                    server.metadata)
        losses.append(float(metrics["loss"]))
    print(f"loss over {LOSS_STEPS} steps on one batch: {losses[0]:.6f} -> "
          f"{losses[-1]:.6f} (min {min(losses):.6f})")
    check(all(np.isfinite(losses)), "train: a loss is not finite")
    check(losses[-1] < losses[0], "train: the loss does not fall on one batch")
    return counts, state, batches, operands, capacity


def recompute_phase(state, batches, server, cfg):
    """The train path with ``_STASH_NC`` off, counted: the peak device memory
    of one train step with the stash on and with it off, then two counted
    steps (per step the eval forward once, the recompute backward once, the
    UGRNN forward and backward twice each, no stash forward or stash
    backward).  Returns the launch counts of the counted run, the state and
    the peaks in bytes."""
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer
    from chameleon_recsys_tpu_torch.train.steps import train_step

    peaks = {}
    for stash in (True, False):
        cand_scorer._STASH_NC = stash
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, _ = train_step(state, batches[0], server.ace_matrix, server.metadata)
        torch.cuda.synchronize()
        peaks[stash] = torch.cuda.max_memory_allocated()
    print(f"peak device memory of one G1 train step: stash on "
          f"{peaks[True] / 2**30:.4f} GiB, off {peaks[False] / 2**30:.4f} GiB "
          f"({(peaks[True] - peaks[False]) / 2**20:.1f} MiB less)")

    zero_launch_counts()
    per_step = []
    for i in range(TRAIN_STEPS):
        before = launch_counts()
        state, metrics = train_step(state, batches[i % len(batches)],
                                    server.ace_matrix, server.metadata)
        torch.cuda.synchronize()
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        values = {k: float(v) for k, v in metrics.items()}
        print(f"train step without the stash {i}: "
              + ", ".join(f"{k} {v:.6g}" for k, v in values.items()))
        check(all(np.isfinite(v) for v in values.values()),
              f"train step without the stash {i}: a metric is not finite")
        check(values["dropped_clicks"] == 0, f"train step {i}: clicks dropped")
    cand_scorer._STASH_NC = True
    counts = launch_counts()
    expected = {"cand_score_fwd": 1, "cand_score_fwd_stash": 0, "cand_score_bwd": 0,
                "cand_score_bwd_recompute": 1, **ugrnn_expected(cfg.rnn_num_layers,
                                                                cfg.rnn_num_layers)}
    print(f"train path without the stash: launches {counts}, per step {per_step}")
    check(per_step == [expected] * TRAIN_STEPS,
          f"kernel launches per train step without the stash {per_step}")
    return counts, state, peaks


def harness_phase(port, cfg, session_schema, article_schema, corpus, model_dir):
    """The temporal harness at G1 width, counted: synthetic hours of
    HARNESS_SESSIONS sessions, one training hour per eval, hours 0-3 (train
    4 hours, evaluate 3) with recently popular and sequential rules, the
    capacity sized as ``train_capacity`` over the hours it trains.  Checks
    the launches (per train step the train path's, per eval step the eval
    path's), the reference's cross-check (device HR/MRR against the host
    suite's CHAMELEON columns) and that every eval restores the stream.
    Returns the harness, its hour source, a factory of fresh harnesses of
    the same configuration and the launch counts."""
    from chameleon_recsys_tpu_torch.baselines import (
        RecentlyPopularRecommender,
        SequentialRulesRecommender,
    )
    from chameleon_recsys_tpu_torch.config import RunConfig
    from chameleon_recsys_tpu_torch.data.synthetic import synthetic_hour_sessions
    from chameleon_recsys_tpu_torch.train.temporal import BenchmarkSpec, TemporalHarness

    n, hours = HARNESS_SESSIONS, range(HARNESS_HOURS)
    capacity = train_capacity(
        [b for h in hours for b in hour_batches(corpus, session_schema, cfg, h, n)], cfg)
    hcfg = dataclasses.replace(cfg, train_valid_row_capacity=capacity)
    run_cfg = RunConfig(model_dir=str(model_dir), training_hours_for_each_eval=1,
                        random_seed=31)

    def source(hour):
        return synthetic_hour_sessions(corpus, session_schema, hour, n,
                                       cfg.max_session_length)

    def make():
        return TemporalHarness(
            hcfg, run_cfg, session_schema, article_schema, corpus.ace_matrix,
            corpus.metadata,
            benchmarks=[BenchmarkSpec(RecentlyPopularRecommender, {}),
                        BenchmarkSpec(SequentialRulesRecommender,
                                      {"max_clicks_dist": 10,
                                       "dist_between_clicks_decay": "div"})],
            device="cuda",
        )

    harness = make()
    walls = {"train": [], "eval": []}
    train_hour, evaluate_hour = harness.train_hour, harness.evaluate_hour

    def timed_train_hour(sessions):
        t0 = time.perf_counter()
        stats = train_hour(sessions)
        torch.cuda.synchronize()
        walls["train"].append(time.perf_counter() - t0)
        return stats

    def checked_evaluate_hour(sessions):
        before = {k: v.clone() for k, v in harness.state.stream._asdict().items()}
        t0 = time.perf_counter()
        row = evaluate_hour(sessions)
        torch.cuda.synchronize()
        walls["eval"].append(time.perf_counter() - t0)
        restored = all(torch.equal(getattr(harness.state.stream, k), v)
                       for k, v in before.items())
        print(f"harness eval hour {len(walls['eval'])}: {walls['eval'][-1]:.3f} s "
              f"wall; phases (s) " + ", ".join(
                  f"{k} {v:.4f}" for k, v in harness.last_eval_phase_seconds.items())
              + f"; stream restored {restored}")
        check(restored, "harness: the stream after an eval is not its snapshot")
        return row

    harness.train_hour = timed_train_hour
    harness.evaluate_hour = checked_evaluate_hour
    zero_launch_counts()
    rows = harness.run(source, hours)
    torch.cuda.synchronize()
    counts = launch_counts()
    train_steps = HARNESS_HOURS * -(-n // cfg.batch_size)
    eval_steps = (HARNESS_HOURS - 1) * -(-n // cfg.batch_size)
    layers = cfg.rnn_num_layers
    expected = {"cand_score_fwd": eval_steps, "cand_score_fwd_stash": train_steps,
                "cand_score_bwd": train_steps, "cand_score_bwd_recompute": 0,
                **ugrnn_expected(layers * (train_steps + eval_steps),
                                 layers * train_steps)}
    print(f"harness (G1, {n} sessions an hour, capacity {capacity}, hours "
          f"{list(hours)}): launches {counts}; train hours "
          + ", ".join(f"{w:.3f}" for w in walls["train"]) + " s wall")
    check(counts == expected, f"harness launches {counts}, expected {expected}")
    check(len(rows) == HARNESS_HOURS - 1, f"harness: {len(rows)} eval rows")
    for i, row in enumerate(rows):
        columns = {k: v for k, v in row.items()
                   if k.endswith(("_chameleon", "_pop_recent", "_sr"))}
        print(f"harness eval row {i}: hitrate_at_n {row['hitrate_at_n']:.6f}, "
              f"mrr_at_n {row['mrr_at_n']:.6f}, clicks {row['clicks_count']}, "
              f"train_sessions_per_s {row['train_sessions_per_s']}; "
              + ", ".join(f"{k} {v:.6f}" for k, v in columns.items()))
        check(all(np.isfinite(v) for v in columns.values()),
              f"harness eval row {i}: a column is not finite")
        # the device's hit count and the host suite's are the same integers;
        # the reciprocal ranks are f32 sums on the card, f64 on the host
        check(row["hitrate_at_n"] == row["hitrate_at_n_chameleon"],
              f"harness eval row {i}: device HR != host HR")
        check(abs(row["mrr_at_n"] - row["mrr_at_n_chameleon"])
              <= 1e-5 * row["mrr_at_n_chameleon"],
              f"harness eval row {i}: device MRR != host MRR")
    return harness, source, make, counts


def checkpoint_phase(port, harness, source, make, corpus):
    """Checkpoint and resume at G1 width: save, load into a fresh harness,
    serve from the file against a server on the live model and stream, then
    train and evaluate one more hour on both harnesses and hold them to
    ``RESUME_TOL``; then two resumes with a planted fault each, which the
    same tolerances must catch."""
    t0 = time.perf_counter()
    path = harness.save_checkpoint()
    save_s = time.perf_counter() - t0
    resumed = make()
    t0 = time.perf_counter()
    resumed.load_checkpoint(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    print(f"checkpoint: {path.stat().st_size} bytes, save {save_s:.3f} s, load "
          f"{load_s:.3f} s")
    check((resumed.hours_trained, resumed.evals_done)
          == (harness.hours_trained, harness.evals_done), "checkpoint: cursors differ")

    args = (harness.cfg, harness.session_schema, harness.article_schema)
    live = port.NARServer(*args, harness.state.model.state_dict(),
                          harness.state.stream, corpus.ace_matrix, corpus.metadata,
                          device="cuda")
    loaded = port.NARServer.from_checkpoint(path, *args, corpus.ace_matrix,
                                            corpus.metadata, device="cuda")
    request = source(HARNESS_HOURS)[:32]
    candidates = np.broadcast_to(live.default_candidates(NUM_CANDIDATES),
                                 (len(request), NUM_CANDIDATES))
    ids, scores = live.recommend(request, candidates=candidates, top_k=TOP_K)
    got_ids, got_scores = loaded.recommend(request, candidates=candidates, top_k=TOP_K)
    print(f"from_checkpoint b32: top-10 equal to the live server's "
          f"{np.array_equal(got_ids, ids)}, largest score difference "
          f"{float(np.abs(got_scores - scores).max()):.3e}")
    check(np.array_equal(got_ids, ids) and np.array_equal(got_scores, scores),
          "from_checkpoint: the served top-10 differs from the live server's")

    def next_hour(h):
        stats = h.train_hour(source(HARNESS_HOURS))
        return stats, h.evaluate_hour(source(HARNESS_HOURS + 1))

    original = next_hour(harness)
    params = [p.detach().clone() for p in harness.state.model.parameters()]

    def readings(h, label):
        """One more hour on ``h`` against the original harness's: the loss's
        relative difference, HR's and MRR's, and the largest parameter
        difference after the hour's training."""
        (stats_a, row_a), (stats_b, row_b) = original, next_hour(h)
        diffs = {
            "loss": abs(stats_a["avg_ce_loss"] - stats_b["avg_ce_loss"])
            / abs(stats_a["avg_ce_loss"]),
            "hr": abs(row_a["hitrate_at_n"] - row_b["hitrate_at_n"]),
            "mrr": abs(row_a["mrr_at_n"] - row_b["mrr_at_n"]),
            "param": max((p - q).abs().max().item()
                         for p, q in zip(params, h.state.model.parameters())),
        }
        print(f"resume ({label}), one more hour: avg_ce_loss "
              f"{stats_b['avg_ce_loss']:.7f} vs {stats_a['avg_ce_loss']:.7f}, "
              f"hitrate_at_n {row_b['hitrate_at_n']:.6f} vs {row_a['hitrate_at_n']:.6f}, "
              f"mrr_at_n {row_b['mrr_at_n']:.6f} vs {row_a['mrr_at_n']:.6f}; "
              "differences " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()))
        return diffs

    def beyond(diffs):
        return sorted(k for k, v in diffs.items() if v > RESUME_TOL[k])

    sound = beyond(readings(resumed, "sound"))
    check(not sound, f"resume: the next hour differs beyond the tolerance in {sound}")
    # planted faults: a resume that re-seeds the sampler's generator, and one
    # that starts Adam afresh; the tolerances must tell each from a sound one
    del resumed
    faults = {
        "generator re-seeded": lambda h: h.state.generator.manual_seed(
            h.run_cfg.random_seed),
        "Adam state dropped": lambda h: h.state.optimizer.state.clear(),
    }
    for label, plant in faults.items():
        faulty = make()
        faulty.load_checkpoint(path)
        plant(faulty)
        caught = beyond(readings(faulty, f"planted fault: {label}"))
        check(caught, f"resume: the planted fault '{label}' passes the tolerances")
        del faulty


def train_cpu_vs_card(port, corpus_fn):
    """One train step of a small float32 model with compaction on the CPU
    and on the card, with the same uniforms (numpy, seeded): the loss, every
    gradient and the stream."""
    from chameleon_recsys_tpu_torch.data.collate import collate_sessions
    from chameleon_recsys_tpu_torch.data.synthetic import synthetic_hour_sessions
    from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
    from chameleon_recsys_tpu_torch.state.stream_state import init_stream_state
    from chameleon_recsys_tpu_torch.train.steps import init_train_state, train_step

    cfg, sess, art = tiny_setup(port)
    corpus = corpus_fn(art, ace_dim=8)
    b, length = cfg.batch_size, cfg.max_session_length
    warm = collate_sessions(synthetic_hour_sessions(corpus, sess, 0, b, length),
                            sess, b, length)
    batch = collate_sessions(synthetic_hour_sessions(corpus, sess, 1, b, length),
                             sess, b, length)
    capacity = -(-train_capacity([batch], cfg) // 8) * 8
    cfg = dataclasses.replace(cfg, train_valid_row_capacity=min(capacity, 48),
                              novelty_reg_factor=0.1)
    rows = min(cfg.train_valid_row_capacity, b * cfg.max_inputs_length)
    m = cfg.negative_sample_from_buffer
    nc = min(cfg.negative_samples * cfg.neg_sampling_multiplying_factor, b * length + m)
    rng = np.random.RandomState(6)
    uniforms = [rng.uniform(size=shape).astype(np.float32) for shape in (
        (cfg.recent_clicks_buffer_max_size,), (b * length + m,), (rows, nc)
    )]
    base = port.NARModel(cfg, sess, art, corpus.ace_matrix.shape[1])
    base.reset_parameters(torch.Generator().manual_seed(4))
    out = {}
    for device in ("cpu", "cuda"):
        model = port.NARModel(cfg, sess, art, corpus.ace_matrix.shape[1]).to(device)
        model.load_state_dict(base.state_dict())
        stream = warm_stream(
            init_stream_state(cfg, art.num_items, device=device), [warm], cfg, device
        )
        before = launch_counts()
        state, metrics = train_step(
            init_train_state(model, stream, torch.Generator(device=device)),
            to_device(batch, device), torch.from_numpy(corpus.ace_matrix).to(device),
            {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in corpus.metadata.items()},
            uniforms=SamplerUniforms(*(torch.from_numpy(u).to(device) for u in uniforms)),
        )
        after = launch_counts()
        if device == "cuda":
            torch.cuda.synchronize()
            check(after["cand_score_bwd"] - before["cand_score_bwd"] == 1
                  and after["ugrnn_bwd"] - before["ugrnn_bwd"] == cfg.rnn_num_layers,
                  "small train step: the card step did not run the backward kernels")
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        out[device] = (state.stream, metrics, grads)
    (cpu_stream, cpu_metrics, cpu_grads), (gpu_stream, gpu_metrics, gpu_grads) = (
        out["cpu"], out["cuda"]
    )
    # per leaf ||card - cpu|| <= 1e-4 ||cpu|| + 1e-5: the floor is for leaves
    # whose gradient is 0 in exact arithmetic (matching_out_bias: the softmax
    # ignores a shift of every score), f32 noise on either side (9.5e-7
    # apart on an H100)
    excess = {
        n: ((gpu_grads[n] - g).norm() - 1e-4 * g.norm()).item()
        for n, g in cpu_grads.items()
    }
    worst = max(excess, key=excess.get)
    print(f"small f32 train step, card vs CPU: loss {float(gpu_metrics['loss']):.7g} "
          f"vs {float(cpu_metrics['loss']):.7g}; gradients: largest "
          f"||card - cpu|| - 1e-4 ||cpu|| is {excess[worst]:.3e} ({worst}; "
          f"tolerance 1e-5)")
    for key in ("loss", "ce_loss", "reg_loss"):
        a, c = float(gpu_metrics[key]), float(cpu_metrics[key])
        check(abs(a - c) <= 1e-5 * abs(c), f"small train: {key} {a} vs {c}")
    for key in ("sessions", "clicks", "dropped_clicks"):
        check(float(gpu_metrics[key]) == float(cpu_metrics[key]),
              f"small train: metric {key} differs")
    check(excess[worst] <= 1e-5, "small train: card and CPU gradients disagree")
    for name, value in cpu_stream._asdict().items():
        check(torch.equal(getattr(gpu_stream, name).cpu(), value),
              f"small train: stream field {name} differs")


def eval_phase(server, cfg, session_schema, corpus):
    """The eval path at G1 width, counted: four eval steps in a row, the
    stream carried from each to the next.  Returns the launch counts of the
    run, the collated batches, the warm stream the run started from and the
    fused scorer's operands of the first step."""
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer, ugrnn
    from chameleon_recsys_tpu_torch.state.stream_state import init_stream_state
    from chameleon_recsys_tpu_torch.train.steps import eval_scorer_operands, eval_step

    b = cfg.batch_size
    warm = warm_stream(
        init_stream_state(cfg, corpus.num_items, device="cuda"),
        hour_batches(corpus, session_schema, cfg, 0, 2 * b)
        + hour_batches(corpus, session_schema, cfg, 1, 2 * b), cfg, "cuda",
    )
    batches = [to_device(batch, "cuda") for batch in
               hour_batches(corpus, session_schema, cfg, 2, EVAL_BATCHES * b)]
    model = server.model
    seed = 11

    zero_launch_counts()
    generator = torch.Generator(device="cuda").manual_seed(seed)
    stream = warm
    per_step = []
    results = []
    for batch in batches:
        before = (cand_scorer.launches, ugrnn.launches, ugrnn.resident_launches)
        stream, metrics, fetches = eval_step(
            model, stream, batch, server.ace_matrix, server.metadata,
            generator=generator,
        )
        results.append((metrics, fetches))
        per_step.append((cand_scorer.launches - before[0],
                         ugrnn.launches - before[1],
                         ugrnn.resident_launches - before[2]))
    torch.cuda.synchronize()
    counts = {"cand_score_fwd": cand_scorer.launches, "ugrnn_fwd": ugrnn.launches,
              "ugrnn_fwd_resident": ugrnn.resident_launches,
              "ugrnn_fwd_stream": ugrnn.stream_launches}
    print(f"eval path: launches {counts}, per step (cand_score_fwd, ugrnn_fwd, "
          f"ugrnn_fwd_resident) {per_step}")
    check(per_step == [(1, cfg.rnn_num_layers, cfg.rnn_num_layers)] * len(batches),
          f"kernel launches per eval step {per_step}")
    for i, (batch, (metrics, fetches)) in enumerate(zip(batches, results)):
        check_eval_outputs(i, batch, metrics, fetches, cfg)
        hr = float(metrics["hit_sum"]) / float(metrics["label_count"])
        print(f"eval step {i}: " + ", ".join(
            f"{k} {float(v):.6g}" for k, v in metrics.items()
        ) + f", HR@{cfg.metrics_top_n} {hr:.4f}")
    # the first step's scorer operands: the same stream, batch and generator
    # seed draw the same negatives (these launch no kernel)
    operands = eval_scorer_operands(
        model, warm, batches[0], server.ace_matrix, server.metadata,
        generator=torch.Generator(device="cuda").manual_seed(seed),
    )
    return counts, batches, warm, operands


def eval_cpu_vs_card(port, corpus_fn):
    """One eval step of a small float32 model on the CPU and on the card,
    with the same uniforms (numpy, seeded)."""
    from chameleon_recsys_tpu_torch.data.collate import collate_sessions
    from chameleon_recsys_tpu_torch.data.synthetic import synthetic_hour_sessions
    from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
    from chameleon_recsys_tpu_torch.state.stream_state import init_stream_state
    from chameleon_recsys_tpu_torch.train.steps import eval_step

    cfg, sess, art = tiny_setup(port)
    corpus = corpus_fn(art, ace_dim=8)
    b, length = cfg.batch_size, cfg.max_session_length
    warm = collate_sessions(synthetic_hour_sessions(corpus, sess, 0, b, length),
                            sess, b, length)
    batch = collate_sessions(synthetic_hour_sessions(corpus, sess, 1, b, length),
                             sess, b, length)
    m = cfg.eval_negative_sample_from_buffer
    nc = min(cfg.eval_negative_samples * cfg.neg_sampling_multiplying_factor,
             b * length + m)
    rng = np.random.RandomState(5)
    uniforms = [rng.uniform(size=shape).astype(np.float32) for shape in (
        (cfg.recent_clicks_buffer_max_size,), (b * length + m,), (b, length, nc)
    )]
    model = port.NARModel(cfg, sess, art, corpus.ace_matrix.shape[1])
    model.reset_parameters(torch.Generator().manual_seed(4))
    out = {}
    for device in ("cpu", "cuda"):
        stream = warm_stream(
            init_stream_state(cfg, art.num_items, device=device), [warm], cfg, device
        )
        out[device] = eval_step(
            model.to(device), stream, to_device(batch, device),
            torch.from_numpy(corpus.ace_matrix).to(device),
            {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in corpus.metadata.items()},
            generator=torch.Generator(device=device),
            uniforms=SamplerUniforms(*(torch.from_numpy(u).to(device)
                                       for u in uniforms)),
        )
    (cpu_stream, cpu_metrics, cpu_fetches), (gpu_stream, gpu_metrics, gpu_fetches) = (
        out["cpu"], out["cuda"]
    )
    cpu_probs = cpu_fetches["predicted_probs"].numpy()
    gpu_probs = gpu_fetches["predicted_probs"].cpu().numpy()
    gaps = np.abs(np.diff(cpu_probs, axis=-1))
    separated = np.ones(cpu_probs.shape, bool)
    separated[..., 1:] &= gaps > 1e-5
    separated[..., :-1] &= gaps > 1e-5
    print(f"small f32 eval step, card vs CPU: max prob diff "
          f"{float(np.abs(gpu_probs - cpu_probs).max()):.3e} (tolerance rtol "
          f"1e-4 + atol 1e-6); ce_loss {float(gpu_metrics['ce_loss']):.7g} vs "
          f"{float(cpu_metrics['ce_loss']):.7g}")
    check(np.allclose(gpu_probs, cpu_probs, rtol=1e-4, atol=1e-6),
          "small eval: card and CPU probabilities disagree")
    check((gpu_fetches["predicted_ids"].cpu().numpy()[separated]
           == cpu_fetches["predicted_ids"].numpy()[separated]).all(),
          "small eval: card and CPU rankings disagree")
    for key in ("labels", "neg_items", "clicked_items"):
        check(torch.equal(gpu_fetches[key].cpu(), cpu_fetches[key]),
              f"small eval: fetch {key} differs")
    for key in ("hit_sum", "label_count", "clicks", "sessions"):
        check(float(gpu_metrics[key]) == float(cpu_metrics[key]),
              f"small eval: metric {key} differs")
    # f32 sums of fractions and of logs, added in another order on the card
    for key, rel in (("rr_sum", 1e-6), ("ce_loss", 1e-4)):
        a, c = float(gpu_metrics[key]), float(cpu_metrics[key])
        check(abs(a - c) <= rel * abs(c), f"small eval: metric {key} {a} vs {c}")
    for name, value in cpu_stream._asdict().items():
        check(torch.equal(getattr(gpu_stream, name).cpu(), value),
              f"small eval: stream field {name} differs")


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
    from chameleon_recsys_tpu_torch.ops.kernels import build, cand_scorer, ugrnn
    from chameleon_recsys_tpu_torch.train.steps import eval_step

    # the card's name and power limit, as nvidia-smi gives them
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    # float32 parity: matmuls in full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build every kernel of the paths ----
    t0 = time.perf_counter()
    build.build(KERNELS)
    print(f"build: {time.perf_counter() - t0:.3f} s for {', '.join(KERNELS)}")
    for name in KERNELS:
        log = build.build_log.get(name, "")
        registers = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
        if registers:
            print(f"  ptxas {name}: {len(registers)} instantiations, registers "
                  f"{min(registers)}-{max(registers)}, spill bytes {spills}")
    # the backward's row kernel and GEMM instantiations, one by one (dynamic
    # shared memory is set at launch: the row kernel's, the core's 97.1 KB)
    for entry, registers, spill, smem in ptxas_entries(
            build.build_log.get("cand_score_bwd", "")):
        if any(k in entry for k in ("rows_kernel", "gemm_kernel")):
            print(f"  ptxas cand_score_bwd {entry}: {registers} registers, "
                  f"{spill} bytes spill stores, {smem} bytes static smem")
    # the forward's two kernels (bf16 on wgmma + TMA, f32 on the CUDA cores)
    # and the dynamic shared memory each sets at launch at the G1 widths
    for entry, registers, spill, smem in ptxas_entries(
            build.build_log.get("cand_score_fwd", "")):
        print(f"  ptxas cand_score_fwd {entry}: {registers} registers, "
              f"{spill} bytes spill stores, {smem} bytes static smem")
    fwd_smem = build.load("cand_score_fwd").cand_score_fwd_smem_bytes
    fwd_smem.argtypes = [ctypes.c_int] * 5
    fwd_smem.restype = ctypes.c_longlong
    print(f"  cand_score_fwd dynamic shared memory at C 1024, M 128/64/32: bf16 "
          f"{fwd_smem(1024, 128, 64, 32, 1)} bytes, f32 {fwd_smem(1024, 128, 64, 32, 0)}")
    rows_smem = build.load("cand_score_bwd").cand_score_bwd_rows_smem_bytes
    rows_smem.argtypes = [ctypes.c_int] * 4
    rows_smem.restype = ctypes.c_longlong
    print(f"  cand_score_bwd row kernel dynamic shared memory at M 128/64/32: bf16 "
          f"{rows_smem(128, 64, 32, 1)} bytes, f32 {rows_smem(128, 64, 32, 0)}")
    for dtype in (torch.bfloat16, torch.float32):
        for train in (False, True):
            takes = cand_scorer.kernel_takes(1024, 128, 64, 32, dtype, train=train)
            print(f"  gate: kernel_takes(C 1024, M 128/64/32, {str(dtype)[6:]}, "
                  f"train={train}) {takes}")
            check(takes, "the scorer's gate refuses the G1 widths")

    # ---- G1 server with a live stream ----
    cfg, session_schema, article_schema = g1_setup(port)
    corpus = make_synthetic_corpus(article_schema, ace_dim=250)
    sessions = synthetic_hour_sessions(
        corpus, session_schema, 0, 2 * cfg.batch_size, cfg.max_session_length
    )
    server = make_server(
        port, cfg, session_schema, article_schema, corpus, seed=0, device="cuda"
    )

    # ---- 2. the serving path, counted ----
    captured = {}
    hook = server.model.rnn.register_forward_pre_hook(
        lambda module, args: captured.__setitem__(args[0].shape[0], args[1])
    )
    zero_launch_counts()
    server.observe(sessions[: cfg.batch_size])
    server.observe(sessions[cfg.batch_size:])
    pool = server.default_candidates(NUM_CANDIDATES)
    results = {}
    per_call = []
    for bs in SERVE_BATCHES:
        before = (ugrnn.launches, ugrnn.resident_launches)
        cand = np.broadcast_to(pool, (bs, NUM_CANDIDATES))
        results[bs] = server.recommend(sessions[:bs], candidates=cand, top_k=TOP_K)
        per_call.append((ugrnn.launches - before[0], ugrnn.resident_launches - before[1]))
    torch.cuda.synchronize()
    serve_counts = {"ugrnn_fwd": ugrnn.launches,
                    "ugrnn_fwd_resident": ugrnn.resident_launches,
                    "ugrnn_fwd_stream": ugrnn.stream_launches}
    hook.remove()
    print(f"serving path: launches {serve_counts}, per recommend (ugrnn_fwd, "
          f"ugrnn_fwd_resident) {per_call}; cand_score_fwd launches "
          f"{cand_scorer.launches}")
    check(per_call == [(cfg.rnn_num_layers, cfg.rnn_num_layers)] * len(SERVE_BATCHES),
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

    # ---- 3. the eval path, counted ----
    eval_counts, eval_batches, eval_stream, scorer_operands = eval_phase(
        server, cfg, session_schema, corpus
    )
    # ---- 4. the train path, counted, with the stash and without ----
    train_counts, train_state, train_batches, train_operands, capacity = train_phase(
        port, server, cfg, session_schema, article_schema, corpus
    )
    recompute_counts, train_state, peaks = recompute_phase(
        train_state, train_batches, server, cfg
    )
    # ---- 5. the temporal harness at G1 width, counted; checkpoint/resume ----
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as workdir:
        harness, source, make, harness_counts = harness_phase(
            port, cfg, session_schema, article_schema, corpus, workdir
        )
        checkpoint_phase(port, harness, source, make, corpus)
        del harness, make
    paths = (serve_counts, eval_counts, train_counts, recompute_counts, harness_counts)
    main_launches = {k: sum(path.get(k, 0) for path in paths)
                     for k in KERNEL_NAMES + UGRNN_INSTANTIATIONS}
    print(f"launches over the counted paths: {main_launches}")
    check(main_launches["ugrnn_fwd_stream"] == main_launches["ugrnn_bwd_stream"] == 0,
          "a G1 path ran a streaming UGRNN kernel")

    # ---- 6. each kernel against its plain twin ----
    serve_mask = captured[max(SERVE_BATCHES)]
    g = torch.Generator().manual_seed(1)
    lengths = torch.randint(1, serve_mask.shape[1] + 1, (256,), generator=g)
    train_like_mask = torch.arange(serve_mask.shape[1])[None] < lengths[:, None]
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
    errors = {}
    for name, mask in (("b1_serve", serve_mask[:1].cpu()), ("b32_serve", serve_mask.cpu()),
                       ("b256", train_like_mask)):
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
    # the fused scorer on the eval path's own operands (bf16, G1 eval shape;
    # random weights keep those scores under ~0.04, so the tolerance is 2e-2
    # of the largest score, a few bf16 roundings of it), then on random
    # operands whose scores are O(1): at the G1 eval shape in bf16 (2e-2), a
    # smaller float32 shape (1e-5) and an odd shape in both dtypes
    scorer_cases = [("g1_eval", scorer_operands, None)] + [
        (f"{'x'.join(map(str, shape))}_{str(dtype)[6:]}",
         scorer_inputs(*shape, dtype=dtype, seed=3),
         1e-5 if dtype == torch.float32 else 2e-2)
        for shape, dtype in (
            ((4864, 50, 1024, 128, 64, 32), torch.bfloat16),
            ((256, 50, 1024, 128, 64, 32), torch.float32),
            ((13, 7, 40, 24, 16, 8), torch.float32),
            ((13, 7, 40, 24, 16, 8), torch.bfloat16),
        )
    ]
    with torch.inference_mode():
        for name, operands, tol in scorer_cases:
            out = cand_scorer.cand_score_kernel(*operands)
            ref = cand_scorer.cand_score_reference(*operands)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = 2e-2 * scale if tol is None else tol
            errors[name] = err
            print(f"cand_score_fwd vs plain {name} {list(operands[0].shape)} "
                  f"{operands[0].dtype}: max_abs_err {err:.3e} (tolerance "
                  f"{tol:.3e}), |scores| max {scale:.4f}")
            check(err <= tol, f"cand_score_fwd disagrees on {name}: {err}")
        del scorer_cases, operands, out, ref

    # the UGRNN backward at the train batch, bf16 and f32, from the forward's
    # stash, against the twin that recomputes the gates from the states
    # (tolerance tied to the largest |ref| of each output: 2e-2 bf16, 2e-4
    # f32); the stash against that recompute (1e-5, the states' tolerance)
    for dtype in (torch.bfloat16, torch.float32):
        x, w, m, hs, acts, g_out = ugrnn_bwd_inputs(train_like_mask, dtype)
        got = ugrnn.ugrnn_scan_bwd_kernel(x, w, m, hs, g_out, acts=acts)
        ref = ugrnn.ugrnn_scan_bwd_reference(x, w, m, hs, g_out)
        h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1)
        stash_err = (acts - (x.float() + h_prev @ w.float())).abs().max().item()
        torch.cuda.synchronize()
        print(f"ugrnn_fwd stash vs recompute [256,19,510] {dtype}: max_abs_err "
              f"{stash_err:.3e} (tolerance 1e-05)")
        check(stash_err <= 1e-5, f"the UGRNN stash differs from the recompute: {stash_err}")
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        errs = []
        for gname, a, e in zip(("dx_proj", "dW_hh"), got, ref):
            err = (a.float() - e.float()).abs().max().item()
            scale = e.float().abs().max().item()
            errs.append(err)
            print(f"ugrnn_bwd vs plain [256,19,510] {dtype} {gname}: max_abs_err "
                  f"{err:.3e} (tolerance {tol * scale:.3e})")
            check(err <= tol * scale, f"ugrnn_bwd disagrees: {gname} {err}")
        errors[("ugrnn_bwd", dtype)] = max(errs)
    # the streaming instantiations, past the resident layout's edge (bf16
    # 656 / 648 units, f32 456), forward and backward against the twins
    for units in (700, 1024):
        for dtype in (torch.bfloat16, torch.float32):
            x, w, m = ugrnn_inputs(train_like_mask[:4], dtype, seed=12, units=units)
            before = launch_counts()
            out, hs, acts = ugrnn.ugrnn_scan_kernel(x, w, m, return_acts=True)
            g_out = (torch.randn(*hs.shape, generator=torch.Generator().manual_seed(13))
                     .to(dtype).cuda())
            got = ugrnn.ugrnn_scan_bwd_kernel(x, w, m, hs, g_out, acts=acts)
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
            ref_out, ref_hs = ugrnn.ugrnn_scan_reference(x, w, m, return_state=True)
            ref = ugrnn.ugrnn_scan_bwd_reference(x, w, m, hs, g_out)
            errs = [(out.float() - ref_out.float()).abs().max().item(),
                    (hs - ref_hs).abs().max().item()]
            tols = [tolerance[dtype], 1e-5]
            tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
            for a, e in zip(got, ref):
                errs.append((a.float() - e.float()).abs().max().item())
                tols.append(tol * e.float().abs().max().item())
            print(f"ugrnn streaming [4,19,{2 * units}] {dtype}: launches {moved}; "
                  f"max_abs_err out/states/dx_proj/dW_hh "
                  + "/".join(f"{e:.2e}" for e in errs) + " (tolerances "
                  + "/".join(f"{t:.2e}" for t in tols) + ")")
            check(moved == {"ugrnn_fwd": 1, "ugrnn_fwd_stream": 1, "ugrnn_bwd": 1,
                            "ugrnn_bwd_stream": 1},
                  f"the streaming UGRNN kernels did not run at {units} units: {moved}")
            check(all(e <= t for e, t in zip(errs, tols)),
                  f"a streaming UGRNN kernel disagrees at {units} units {dtype}")

    # the stash forward and the backward on the train path's own operands
    # (bf16, the compacted G1 shape) with a cotangent of the size the loss
    # gives (N(0, 1) / (rows * temperature)), then on random operands whose
    # scores are O(1): the G1 train shape in bf16, a float32 shape (the
    # CUDA-core branch) and the odd shape in both dtypes
    def cotangent(operands, seed):
        bt, k = operands[1].shape[0], operands[0].shape[0] // operands[1].shape[0]
        g = torch.randn(bt, k, generator=torch.Generator().manual_seed(seed))
        return (g / (bt * cfg.softmax_temperature)).cuda()

    train_cases = [("g1_train", train_operands, 2e-2)] + [
        (f"{'x'.join(map(str, shape))}_{str(dtype)[6:]}",
         scorer_inputs(*shape, dtype=dtype, seed=9),
         2e-4 if dtype == torch.float32 else 2e-2)
        for shape, dtype in (
            ((capacity, 50, 1024, 128, 64, 32), torch.bfloat16),
            ((256, 50, 1024, 128, 64, 32), torch.float32),
            ((13, 7, 40, 24, 16, 8), torch.float32),
            ((13, 7, 40, 24, 16, 8), torch.bfloat16),
        )
    ]
    with torch.no_grad():
        for i, (name, operands, tol) in enumerate(train_cases):
            g_case = cotangent(operands, 10 + i)
            nc_err, bwd_err = check_scorer_train_kernels(name, operands, g_case, tol)
            errors[("stash", name)] = nc_err
            errors[("bwd", name)] = bwd_err
            errors[("recompute", name)] = check_recompute_kernel(
                name, operands, g_case, tol)
    del train_cases

    # ---- 7. served scores, an eval and a train step against the CPU ----
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
    eval_cpu_vs_card(port, make_synthetic_corpus)
    train_cpu_vs_card(port, make_synthetic_corpus)

    # ---- 8. times ----
    # K2f at serving batches 1 and 32 and the train batch 256, with the
    # training outputs (states and stash) and without, beside the chain
    # floor and the launch's clusters; then at T 1, 4 and 19 (the slope is a
    # step's cost, the intercept the set-up, loading W_hh, and the launch).
    # Device time by CUDA events over calls queued ahead (queued_ms; plain
    # events over back-to-back calls, beside it, read the host's dispatch
    # where that is the slower).  No profiler session runs before the
    # wall-clock timings below: the UGRNN kernels' profiles come last
    x, w, m = ugrnn_inputs(serve_mask.cpu(), torch.bfloat16, seed=2)
    ugrnn_ms = queued_ms(lambda: ugrnn.ugrnn_scan_kernel(x, w, m), iters=200)
    ugrnn_events_ms = cuda_ms(lambda: ugrnn.ugrnn_scan_kernel(x, w, m), iters=200)
    ugrnn_plain_ms = cuda_ms(lambda: ugrnn.ugrnn_scan_reference(x, w, m), iters=20)
    ugrnn_bound, ugrnn_bound_by = ugrnn_bound_ms(x, w, m)
    print(f"ugrnn_fwd [32,19,510] bf16 (serving mask): kernel {ugrnn_ms:.4f} ms by "
          f"queued CUDA events ({ugrnn_events_ms:.4f} ms by plain CUDA events over "
          f"back-to-back calls), plain {ugrnn_plain_ms:.4f} ms, bound "
          f"{ugrnn_bound:.5f} ms ({ugrnn_bound_by})")
    for dtype, masks in ((torch.bfloat16, (serve_mask[:1].cpu(), serve_mask.cpu(),
                                           train_like_mask)),
                         (torch.float32, (serve_mask.cpu(), train_like_mask))):
        for mask in masks:
            xb, wb, mb = ugrnn_inputs(mask, dtype, seed=2)
            ms = queued_ms(lambda: ugrnn.ugrnn_scan_kernel(xb, wb, mb), iters=200)
            train_ms = queued_ms(lambda: ugrnn.ugrnn_scan_kernel(xb, wb, mb,
                                                                 return_acts=True),
                                 iters=200)
            floor_ms = ugrnn_chain_floor_ms(mask.shape[0], dtype)
            n, rows = ugrnn_fwd_layout(mask.shape[0], dtype)
            bms, _ = ugrnn_bound_ms(xb, wb, mb)
            print(f"ugrnn_fwd [{mask.shape[0]},19,510] {str(dtype)[6:]}: kernel "
                  f"{ms:.4f} ms, with states and stash {train_ms:.4f} ms, chain floor "
                  f"{floor_ms:.4f} ms, bound {bms:.5f} ms; clusters of {n} CTAs, "
                  f"{rows} rows each")
    for batch in (1, 32, 256):
        xb, wb, mb = ugrnn_inputs(train_like_mask[:batch], torch.bfloat16, seed=2)
        steps = {}
        for t in (1, 4, 19):
            xt, mt = xb[:, :t].contiguous(), mb[:, :t].contiguous()
            steps[t] = queued_ms(lambda: ugrnn.ugrnn_scan_kernel(xt, wb, mt), iters=200)
        print(f"ugrnn_fwd [{batch},T,510] bf16 by step count: "
              + ", ".join(f"T {t} {ms:.4f} ms" for t, ms in steps.items())
              + f"; {(steps[19] - steps[1]) / 18 * 1e3:.2f} us a step")
    with torch.inference_mode():
        scorer_ms = cuda_ms(
            lambda: cand_scorer.cand_score_kernel(*scorer_operands), iters=20, warmup=3
        )
        scorer_plain_ms = cuda_ms(
            lambda: cand_scorer.cand_score_reference(*scorer_operands), iters=3,
            warmup=1,
        )
    scorer_bound, scorer_bound_by, scorer_ops = cand_score_bound_ms(scorer_operands)
    tflop = scorer_ops / 1e12
    print(f"cand_score_fwd {list(scorer_operands[0].shape)} bf16 (G1 eval): kernel "
          f"{scorer_ms:.4f} ms ({tflop / scorer_ms * 1e3:.1f} TFLOP/s), plain "
          f"{scorer_plain_ms:.4f} ms, bound {scorer_bound:.5f} ms ({scorer_bound_by})")
    # two launches give the same bits (no float atomics in the forward)
    with torch.inference_mode():
        first = cand_scorer.cand_score_kernel(*scorer_operands)
        second = cand_scorer.cand_score_kernel(*scorer_operands)
        (s1, nc1), (s2, nc2) = (cand_scorer.cand_score_kernel(*train_operands, return_nc=True)
                                for _ in range(2))
        torch.cuda.synchronize()
        same = [torch.equal(first, second), torch.equal(s1, s2), torch.equal(nc1, nc2)]
        print(f"cand_score_fwd twice on the G1 eval operands: scores bit-equal {same[0]}; "
              f"cand_score_fwd (stash) twice on the G1 train operands: scores bit-equal "
              f"{same[1]}, nc bit-equal {same[2]}")
        check(all(same), "the scorer's forward is not deterministic")
        del first, second, s1, s2, nc1, nc2
        # the CAR product alone on torch.matmul: [N, C] x [C, C] in bf16
        rows, car_w = scorer_operands[0], scorer_operands[3]
        car_ms = cuda_ms(lambda: torch.matmul(rows, car_w), iters=20, warmup=3)
        car_flop = 2 * rows.shape[0] * rows.shape[1] * car_w.shape[1]
        print("CAR product " + json.dumps({
            "shape": [rows.shape[0], rows.shape[1], car_w.shape[1]],
            "library": "torch.matmul", "library_ms": car_ms,
            "library_tflop_per_s": car_flop / car_ms / 1e9,
            "cand_score_fwd_ms": scorer_ms, "cand_score_fwd_share_of_work":
            car_flop / scorer_ops,
        }))
        del rows, car_w
    # the same row count at other widths: what the CAR product (C^2) and the
    # matching layers (M) each cost in this kernel
    for shape in ((4864, 50, 1024, 16, 8, 8), (4864, 50, 512, 128, 64, 32)):
        operands = scorer_inputs(*shape, dtype=torch.bfloat16, seed=6)
        ms = cuda_ms(lambda: cand_scorer.cand_score_kernel(*operands), iters=10,
                     warmup=2)
        bms, _, ops = cand_score_bound_ms(operands)
        print(f"cand_score_fwd bf16 BT,K,C,M1,M2,M3={shape}: kernel {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TFLOP/s), bound {bms:.5f} ms")
        del operands

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
    cand32 = np.broadcast_to(pool, (32, NUM_CANDIDATES))
    device_profile(
        "recommend b32",
        lambda: server.recommend(sessions[:32], candidates=cand32, top_k=TOP_K),
        10, p50[32],
    )

    generator = torch.Generator(device="cuda").manual_seed(12)
    step_batch = eval_batches[0]

    def one_eval_step():
        return eval_step(server.model, eval_stream, step_batch, server.ace_matrix,
                         server.metadata, generator=generator)

    step_ms = cuda_ms(one_eval_step, iters=20, warmup=3)
    sessions_per_batch = int((step_batch["session_size"] > 0).sum())
    print(f"eval_step b{cfg.batch_size} (CUDA events over 20 steps): "
          f"{step_ms:.3f} ms per batch, {sessions_per_batch / step_ms * 1e3:.1f} "
          f"sessions/s")
    device_profile("eval_step", one_eval_step, 5, step_ms)

    # the train path's kernels at the compacted G1 train shape
    with torch.no_grad():
        ops = train_operands
        # the eval forward at the train shape: the stash-off train step's forward
        fwd_train_ms = cuda_ms(lambda: cand_scorer.cand_score_kernel(*ops), iters=10,
                               warmup=2)
        stash_ms = cuda_ms(lambda: cand_scorer.cand_score_kernel(*ops, return_nc=True),
                           iters=10, warmup=2)
        stash_plain_ms = cuda_ms(
            lambda: cand_scorer.cand_score_reference(*ops, return_nc=True),
            iters=2, warmup=1)
        _, nc = cand_scorer.cand_score_kernel(*ops, return_nc=True)
        g = cotangent(ops, 30)
        bwd_ms = cuda_ms(lambda: cand_scorer.cand_score_bwd_kernel(*ops, nc, g),
                         iters=5, warmup=2)
        bwd_plain_ms = cuda_ms(lambda: cand_scorer.cand_score_bwd_reference(*ops, nc, g),
                               iters=1, warmup=1)
        # no float atomics anywhere: two launches give the same bits
        first = cand_scorer.cand_score_bwd_kernel(*ops, nc, g)
        second = cand_scorer.cand_score_bwd_kernel(*ops, nc, g)
        torch.cuda.synchronize()
        same = [name for name, a, b in zip(SCORER_GRADS, first, second)
                if torch.equal(a, b)]
        print(f"cand_score_bwd twice on the G1 train operands: bit-equal in "
              f"{len(same)} of {len(SCORER_GRADS)} gradients")
        check(len(same) == len(SCORER_GRADS), "cand_score_bwd is not deterministic")
        del first, second
        bwd_split = launch_split(lambda: cand_scorer.cand_score_bwd_kernel(*ops, nc, g), 3)
        del nc
        recompute_split = launch_split(
            lambda: cand_scorer.cand_score_bwd_recompute_kernel(*ops, g), 3)
        fwd_split = launch_split(lambda: cand_scorer.cand_score_kernel(*scorer_operands), 3)
        recompute_ms = cuda_ms(
            lambda: cand_scorer.cand_score_bwd_recompute_kernel(*ops, g), iters=5,
            warmup=2)
        recompute_plain_ms = cuda_ms(
            lambda: cand_scorer.cand_score_bwd_reference(*ops, None, g), iters=1,
            warmup=1)
    stash_bound, stash_bound_by = cand_score_stash_bound_ms(train_operands)
    bwd_bound, bwd_bound_by = cand_score_bwd_bound_ms(train_operands)
    n_rows, c = train_operands[0].shape
    m1, m2, m3 = (train_operands[i].shape[1] for i in (5, 7, 9))
    bwd_ops = 2 * n_rows * (2 * c * c + 3 * c * m1 + 3 * m1 * m2 + 3 * m2 * m3)
    print(f"cand_score_fwd {list(train_operands[0].shape)} bf16 (G1 train, the "
          f"forward without the stash): kernel {fwd_train_ms:.4f} ms")
    print(f"cand_score_fwd (stash) {list(train_operands[0].shape)} bf16 (G1 train): "
          f"kernel {stash_ms:.4f} ms, plain {stash_plain_ms:.4f} ms, bound "
          f"{stash_bound:.5f} ms ({stash_bound_by})")
    print(f"cand_score_bwd {list(train_operands[0].shape)} bf16 (G1 train): kernel "
          f"{bwd_ms:.4f} ms ({bwd_ops / bwd_ms / 1e9:.1f} TFLOP/s), plain "
          f"{bwd_plain_ms:.4f} ms, bound {bwd_bound:.5f} ms ({bwd_bound_by})")
    recompute_bound, recompute_bound_by = cand_score_bwd_recompute_bound_ms(
        train_operands)
    recompute_ops = bwd_ops + 2 * n_rows * c * c
    print(f"cand_score_bwd_recompute {list(train_operands[0].shape)} bf16 (G1 train): "
          f"kernel {recompute_ms:.4f} ms ({recompute_ops / recompute_ms / 1e9:.1f} "
          f"TFLOP/s), plain {recompute_plain_ms:.4f} ms, bound {recompute_bound:.5f} ms "
          f"({recompute_bound_by})")
    print_split(f"cand_score_bwd {list(train_operands[0].shape)} bf16", bwd_split)
    print_split(f"cand_score_bwd_recompute {list(train_operands[0].shape)} bf16",
                recompute_split)
    print_split(f"cand_score_fwd {list(scorer_operands[0].shape)} bf16 (G1 eval)", fwd_split)
    gemm_core_phase(n_rows, c)
    print(f"scorer kernels of one G1 train step: without the stash (forward + "
          f"recompute backward) {fwd_train_ms + recompute_ms:.4f} ms, with it (stash "
          f"forward + stash backward) {stash_ms + bwd_ms:.4f} ms, difference "
          f"{fwd_train_ms + recompute_ms - stash_ms - bwd_ms:.4f} ms")
    # K2b at the train batch from the forward's stash: timed (its split by
    # launch comes with the profiles, last) and two launches bit-equal; f32
    # once
    for dtype in (torch.bfloat16, torch.float32):
        xb, wb, mb, hsb, actsb, gb = ugrnn_bwd_inputs(train_like_mask, dtype)

        def bwd():
            return ugrnn.ugrnn_scan_bwd_kernel(xb, wb, mb, hsb, gb, acts=actsb)

        k2b_ms = queued_ms(bwd, iters=50)
        k2b_events_ms = cuda_ms(bwd, iters=50)
        first, second = bwd(), bwd()
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(first, second)]
        print(f"ugrnn_bwd twice on [256,19,510] {str(dtype)[6:]}: dx_proj, dW_hh "
              f"bit-equal {same}")
        check(all(same), "ugrnn_bwd is not deterministic")
        del first, second
        bound_ms_, bound_by_ = ugrnn_bwd_bound_ms(xb, wb, mb)
        if dtype == torch.bfloat16:
            ugrnn_bwd_ms = k2b_ms
            ugrnn_bwd_plain_ms = cuda_ms(
                lambda: ugrnn.ugrnn_scan_bwd_reference(xb, wb, mb, hsb, gb, acts=actsb),
                iters=5, warmup=1)
            ugrnn_bwd_bound, ugrnn_bwd_bound_by = bound_ms_, bound_by_
        print(f"ugrnn_bwd [256,19,510] {str(dtype)[6:]}: kernel {k2b_ms:.4f} ms by "
              f"queued CUDA events ({k2b_events_ms:.4f} ms by plain CUDA events), "
              f"bound {bound_ms_:.5f} ms ({bound_by_})"
              + (f", plain {ugrnn_bwd_plain_ms:.4f} ms" if dtype == torch.bfloat16 else ""))

    train_holder = [train_state]
    train_batch = train_batches[0]

    def one_train_step():
        from chameleon_recsys_tpu_torch.train.steps import train_step

        train_holder[0], _ = train_step(train_holder[0], train_batch,
                                        server.ace_matrix, server.metadata)

    train_ms = cuda_ms(one_train_step, iters=10, warmup=2)
    train_sessions = int((train_batch["session_size"] > 0).sum())
    print(f"train_step b{cfg.batch_size} capacity {capacity} (CUDA events over 10 "
          f"steps): {train_ms:.3f} ms per batch, "
          f"{train_sessions / train_ms * 1e3:.1f} sessions/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_profile("train_step", one_train_step, 3, train_ms)
    cand_scorer._STASH_NC = False
    nostash_ms = cuda_ms(one_train_step, iters=10, warmup=2)
    device_profile("train_step without the stash", one_train_step, 3, nostash_ms)
    cand_scorer._STASH_NC = True
    print(f"train_step without the stash (CUDA events over 10 steps): "
          f"{nostash_ms:.3f} ms per batch against {train_ms:.3f} ms with it; peak "
          f"device memory of one step {peaks[False] / 2**30:.4f} against "
          f"{peaks[True] / 2**30:.4f} GiB")
    # the UGRNN backward's profiles, after every wall-clock timing: split by
    # launch (the chain, dW_hh's partials, their sum) in both dtypes, and
    # its chain launch at T 1, 4 and 19 (bf16; the slope is a step's cost)
    for dtype in (torch.float32, torch.bfloat16):
        xb, wb, mb, hsb, actsb, gb = ugrnn_bwd_inputs(train_like_mask, dtype)
        print_split(f"ugrnn_bwd [256,19,510] {str(dtype)[6:]}", launch_split(
            lambda: ugrnn.ugrnn_scan_bwd_kernel(xb, wb, mb, hsb, gb, acts=actsb), 5))
    chain = {}
    for t in (1, 4, 19):  # bf16, the causal prefix of the same operands
        xt, mt, hst, actst, gt = (v[:, :t].contiguous() for v in (xb, mb, hsb, actsb, gb))
        chain[t] = launch_split(
            lambda: ugrnn.ugrnn_scan_bwd_kernel(xt, wb, mt, hst, gt, acts=actst), 5)[0][1]
    print("ugrnn_bwd chain launch [256,T,510] bf16 by step count (torch profiler): "
          + ", ".join(f"T {t} {us / 1e3:.4f} ms" for t, us in chain.items())
          + f"; {(chain[19] - chain[1]) / 18:.2f} us a step")

    print(json.dumps({"kernels": [
        {
            "name": "ugrnn_fwd",
            "route": "cuda",
            "source": "chameleon_recsys_tpu_torch/csrc/ugrnn_fwd.cu",
            "replaces": "chameleon_recsys_tpu/ops/pallas/ugrnn_pallas.py:51",
            "launches": main_launches["ugrnn_fwd"],
            "max_abs_err": errors[("b32_serve", torch.bfloat16)],
            "ms": ugrnn_ms,
            "plain_ms": ugrnn_plain_ms,
            "bound_ms": ugrnn_bound,
            "bound_by": ugrnn_bound_by,
            "library_ms": None,
        },
        {
            "name": "ugrnn_bwd",
            "route": "cuda",
            "source": "chameleon_recsys_tpu_torch/csrc/ugrnn_bwd.cu",
            "replaces": "chameleon_recsys_tpu/ops/pallas/ugrnn_pallas.py:80",
            "launches": main_launches["ugrnn_bwd"],
            "max_abs_err": errors[("ugrnn_bwd", torch.bfloat16)],
            "ms": ugrnn_bwd_ms,
            "plain_ms": ugrnn_bwd_plain_ms,
            "bound_ms": ugrnn_bwd_bound,
            "bound_by": ugrnn_bwd_bound_by,
            "library_ms": None,
        },
        {
            "name": "cand_score_fwd",
            "route": "cuda",
            "source": "chameleon_recsys_tpu_torch/csrc/cand_score_fwd.cu",
            "replaces": "chameleon_recsys_tpu/ops/pallas/cand_scorer.py:172",
            "launches": main_launches["cand_score_fwd"],
            "max_abs_err": errors["g1_eval"],
            "ms": scorer_ms,
            "plain_ms": scorer_plain_ms,
            "bound_ms": scorer_bound,
            "bound_by": scorer_bound_by,
            "library_ms": None,
        },
        {
            "name": "cand_score_fwd_stash",
            "route": "cuda",
            "source": "chameleon_recsys_tpu_torch/csrc/cand_score_fwd.cu",
            "replaces": "chameleon_recsys_tpu/ops/pallas/cand_scorer.py:291",
            "launches": main_launches["cand_score_fwd_stash"],
            "max_abs_err": errors[("stash", "g1_train")],
            "ms": stash_ms,
            "plain_ms": stash_plain_ms,
            "bound_ms": stash_bound,
            "bound_by": stash_bound_by,
            "library_ms": None,
        },
        {
            "name": "cand_score_bwd",
            "route": "cuda",
            "source": "chameleon_recsys_tpu_torch/csrc/cand_score_bwd.cu",
            "replaces": "chameleon_recsys_tpu/ops/pallas/cand_scorer.py:283",
            "launches": main_launches["cand_score_bwd"],
            "max_abs_err": errors[("bwd", "g1_train")],
            "ms": bwd_ms,
            "plain_ms": bwd_plain_ms,
            "bound_ms": bwd_bound,
            "bound_by": bwd_bound_by,
            "library_ms": None,
        },
        {
            "name": "cand_score_bwd_recompute",
            "route": "cuda",
            "source": "chameleon_recsys_tpu_torch/csrc/cand_score_bwd.cu",
            "replaces": "chameleon_recsys_tpu/ops/pallas/cand_scorer.py:275",
            "launches": main_launches["cand_score_bwd_recompute"],
            "max_abs_err": errors[("recompute", "g1_train")],
            "ms": recompute_ms,
            "plain_ms": recompute_plain_ms,
            "bound_ms": recompute_bound,
            "bound_by": recompute_bound_by,
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

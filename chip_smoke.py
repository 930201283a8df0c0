#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths at the G1 configuration's full width with random
weights from a seed, the serving path (``NARServer.observe`` / ``recommend``),
the eval step (``train.steps.eval_step``), the train step
(``train.steps.train_step``, valid-row compaction at the bench's capacity,
with the fused scorer's nc stash and without it) and the temporal harness
(``train.temporal.TemporalHarness``: hour-by-hour train and eval with two
baselines, checkpoint/resume, ``NARServer.from_checkpoint``), the G1
pipeline through its CLIs (``cli.make_pseudo_g1`` -> ``nar_preprocess_gcom``
-> ``nar_trainer_gcom``) and the Adressa chain through its CLIs
(``cli.make_pseudo_adressa`` -> ``acr_preprocess_adressa`` ->
``acr_trainer_adressa`` -> ``nar_preprocess_adressa`` ->
``nar_trainer_adressa``), the dense train path with dropout, the G1 sweep
(``cli.nar_hypertuning_gcom``) and G1 ACR with the ACE baselines
(``cli.acr_preprocess_gcom`` -> ``acr_trainer_gcom``, ``ace_baselines_cli``),
the neural baselines through their CLIs (``cli.run_gru4rec``,
``cli.run_sr_gnn``), the native host code (the C++ session loader under
``--use_native_loader`` and the session-kNN's C++ predictor), the train
step with grouped compaction, ACR in bf16, multi-GPU training through the
sharded steps, the quality example on the learnable synthetic streams, and
every hand-written kernel of those paths:

1. builds each kernel from ``chameleon_recsys_tpu_torch/csrc`` (one ``nvcc``
   per source, started together; beside them, in a thread, the native
   libraries from ``chameleon_recsys_tpu_torch/native`` with ``g++``, with
   their build seconds and whether zlib's header is there) and reports the
   build time and what ptxas
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
   catch; beside the pickle, the directory checkpoint
   (``save_checkpoint_dcp``, ``torch.distributed.checkpoint``) at the same
   point, its load bit-equal and its next hour against the pickle-resumed
   one's;
6. the G1 pipeline through its CLIs, on the card: a pseudo-G1 bundle at the
   published shape (46,033 articles, 250-wide ACEs, 2,600 sessions an hour
   on average, seed 7; 11 hourly files, on 4 processes), its session
   TFRecords (4 processes), then ``nar_trainer_gcom.main`` in this process
   with ``scripts/run_nar_train_gcom_full.sh``'s flags over files 0-10
   (train 0-4, evaluate 5, train 5-9, evaluate 10, train 10), six
   baselines, the scalars, the histograms and an artifact store; checks the
   exit, the eval CSV (two rows, every baseline's columns, finite, the
   device HR equal to the host suite's), the synced copy against
   ``model_dir``, that the peak device memory grew and that no kernel
   launched (the CLI's default path is the plain one); prints the
   bundle's and the preprocessing's seconds, the sessions of each hour,
   every train and eval hour's wall, the eval hours' phases and each
   baseline's wall and CPU seconds in the benchmark tier; the session-kNN
   takes its C++ predictor, as the JAX CLI's does (its counters: native
   calls only);
7. the Adressa chain through its CLIs, on the card: a pseudo-Adressa bundle
   at the published shape (13,000 articles, 80 categories, a 20,000-word
   100-dim word2vec file, 2,600 sessions an hour on average, seed 11; 11
   hours), ``acr_preprocess_adressa``, ``acr_trainer_adressa`` (CNN, batch
   8, one epoch), ``nar_preprocess_adressa`` (Europe/Oslo) and
   ``nar_trainer_adressa`` over the 11 hourly files (train 0-4, evaluate 5,
   train 5-9, evaluate 10, train 10), each with its ``scripts/run_*``
   flags; checks each run, the ACR step losses, the ACE matrix ([13,001,
   250], finite, row 0 the mean), the eval
   CSV (two rows, six baselines, the device HR equal to the host suite's)
   and that no kernel launched on either trainer; prints each CLI's wall,
   ACR ms a step, every train and eval hour's wall, the eval hours'
   phases, HR@5 and MRR@5 per recommender and the peak device memory; then
   20 ACR steps at the published width on the CPU and on the card from the
   same weights and batches, the losses and the ACE held against each
   other (the ACR step's device busy share is profiled last, after 15);
8. the dense train path with dropout, counted: the G1 config at keep_prob
   0.8 with the UGRNN kernels on, compaction at the bench's capacity, ten
   steps (per step K2f and K2b twice, no scorer kernel), timed by CUDA
   events with the peak device memory, its busy share and top device
   operations profiled after 15; then one dense step of a small float32
   model on the CPU and on the card with the same dropout masks;
9. the G1 sweep through ``nar_hypertuning_gcom.main`` on phase 6's session
   files 0-5 with ``scripts/run_nar_train_gcom_full.sh``'s flags and an ML
   Engine JSON spec (``dropout_keep_prob`` 0.8 and 1.0, two trials, two at a
   time): each trial's wall and objective, the order, no kernel launch;
10. G1 ACR and the ACE baselines through their CLIs: a G1-layout articles
   CSV from the pseudo-Adressa generator's 13,000 articles and a 300-dim
   word2vec file, ``acr_preprocess_gcom`` and ``acr_trainer_gcom`` (the GRU
   autoencoder) with their ``scripts/run_*`` flags cut to one epoch, then
   ``ace_baselines_cli`` for LSA, W2V-TF-IDF and doc2vec (5 epochs): each
   wall, the autoencoder's ms a step (its busy share profiled after 15),
   each ACE matrix's shape ([13,001, 250], W2V-TF-IDF the word width 300)
   with row 0 the mean, no kernel launch;
11. the neural baselines through their CLIs, on the card, on phase 6's
   session files 0-10 and the eval negatives its trainer wrote:
   ``run_gru4rec`` with ``scripts/run_gru4rec_gcom.sh``'s flags (364,047
   items, one GRU layer of 300, bpr-max 0.5, 200 negatives, batch 128) and
   ``run_sr_gnn`` with its defaults (hidden 100, one GNN step) at the same
   ``--num_items``; checks each run, its eval CSV (two rows, the model's
   columns, finite) and that no kernel launched; prints each CLI's wall,
   every train and eval hour's wall, the peak device memory, GRU4Rec's
   parameter and optimizer-state bytes and its dense update's time, a train
   step's time by CUDA events (its busy share and top device operations
   profiled after 15); then a few steps of each at that width on the CPU
   and on the card from the same weights and draws, the losses and the
   parameters held against each other;
12. the kernels, after phases 13-15 below: (a) holds each kernel against
   its plain PyTorch twin on the card: the UGRNN
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
   (b) checks the served scores, one eval step and one train step against
   the same code on the CPU, where the kernel wrappers run their plain
   twins, on a small float32 input;
   (c) times each kernel, its plain twin, ``recommend``, the eval step and the
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
   (d) holds the scorer backward's GEMM core (``csrc/sm90_gemm.cuh``) alone
   against ``torch.matmul`` at dpre's shape (134,400 x 1024 by 1024^T, bf16)
   and times both (its own line: it is no TPU kernel), splits one backward
   (K1b) at the train path's operands by device launch (torch profiler),
   and fails unless two backward launches on those operands give the same
   bits;
13. the native host code, on the card's host, after phase 11: phase 6's
   ``nar_trainer_gcom`` run again on its files 0-10 with
   ``--use_native_loader``; checks the run, every baseline column bit-equal
   to phase 6's, that the session-kNN predicted on its C++ path only, each
   file's C++ batches array for array against the Python reader and
   collation, and the session-kNN's predictions on eval hour 10's first
   batch natively and on the numpy row loop bit-equal; prints the loader's
   and the Python reader's seconds per file, both predictors' walls, and
   the benchmark tier's seconds and share of eval hour 10;
14. grouped compaction, counted: the G1 train step at phase 4's capacity
   with ``train_compaction_groups`` 4 (per step the stash forward and the
   backward of the fused scorer once, the UGRNN forward and backward twice
   each), each step's ``dropped_clicks`` against the groups' overflow
   counted on the host, the loss over 20 steps on one batch finite and
   falling, and the ms a step by CUDA events beside the one-group step's;
15. ACR in bf16: phase 7's CNN classifier (ACE 250, batch 8) and phase 10's
   GRU autoencoder (GRU 512, 30 tokens, batch 32) at their published
   widths, 20 steps each in bf16 and in f32 from the same weights and
   batches, on the card and on the CPU; checks the losses (finite,
   falling), the bf16 ACE within ``ACR_BF16_TOL`` of the f32 ACE at the
   initial weights, and the card's bf16 run against the CPU's (the ACE
   before and after the steps, the losses), and prints the bf16
   ACE's distance from f32 after the steps, the ms a step and (profiled
   last) the busy share of each;
16. multi-GPU on the one card, counted: three worlds of spawned ranks through
   the sharded programs (``parallel/sharded.py``) at the G1 width of
   ``scripts/g1_mesh_parity.py`` (46,034 items, capacity 2,688 in one group
   a data rank): 1 x 1 over NCCL, 2 x 1 and 1 x 2 (the item embedding and
   the ACE matrix row-sharded, 23,017 rows a rank) over gloo with both ranks
   on the card (NCCL refuses two ranks on one device); in each, per rank, the
   sharded eval step (the fused scorer once, the UGRNN forward twice) and
   two train steps (as phase 4's), held on rank 0 against the one-device
   steps with ``train_compaction_groups`` = the data parallelism on the same
   global batches, weights and draws (``MESH_TOL``; the integer stream
   exactly; for the two-rank worlds the first train step in float32 too,
   Adam's moments within 1e-4 every element and 1e-3 normwise a
   parameter), the replicated parameters bit-equal across the ranks; prints
   each world's collectives per step by kind and its ms a train step by
   CUDA events.  Then the multi-GPU entry point, ``parallel/dryrun.py``,
   over a 2 x 2 world of four ranks on the card (gloo): the harness with a
   ``MeshPlan`` through two train hours, the eval hour with the host tier
   on each data index, a checkpoint gathered, restored and replayed, its
   kernel launches counted on every rank.  In the 1 x 2 world each rank
   also writes its state through the directory checkpoint (its own rows of
   the sharded tables, its own file; none holds the whole item table) and
   resumes it, bit-equal, and the next step against the pickle-resumed
   one's.  Run beside phase 13, on phase 6's files: phase 6's CLI with
   ``--data_parallelism 1``, a world of one over NCCL through
   ``mesh_from_args``, its baseline columns bit-equal to phase 6's;
17. the quality example (``cli/train_nar_synthetic.py``) on the card at the
   sizes RESULTS.md publishes: A (Markov stream, 800 items, 9 hours of 96
   sessions), D (churning catalog, 1,500 items, 16 hours of 320 sessions,
   top 3 of 51) and B (10,000 items, 24 hours of 768 sessions, CAR 1024,
   UGRNN 255 x 2, 50 negatives) with both kernel flags on in float32,
   counted (every one of K2f, K2b, K1f, K1fs and K1b launched); each
   per-eval-hour table and ``train_sessions_per_s``; the quality checks
   (A: CHAMELEON's HR@10 above popularity's at every eval; D: the last
   HR@3 above co-occurrence's and SR's; B: the last HR@10 above the
   first); the five kernels at B's shapes in float32 against their twins,
   timed beside their bounds; A's hours 0-4 on the card and on its host's
   CPU with the same weights and draws (baseline columns bit-equal,
   CHAMELEON within ``SYNTHETIC_CPU_TOL``).

Prints the card's name and power limit first, a JSON line of per-kernel
numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits 1 before printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import csv
import ctypes
import dataclasses
import json
import math
import re
import shlex
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from chameleon_recsys_tpu_torch.utils.profiling import cuda_ms, device_profile, launch_split

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM
H100_F32_FLOP_PER_S = 67e12  # CUDA cores, no tensor cores
H100_BF16_FLOP_PER_S = 989e12  # tensor cores, dense
# f32-accurate work on the TF32 tensor cores (495 TFLOP/s dense), split into
# three TF32 products (the scorer's f32 kernels): a third of the TF32 rate
H100_SPLIT_TF32_FLOP_PER_S = 495e12 / 3
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
# the G1 pipeline through its CLIs: a pseudo-G1 bundle at the published
# shape, and the first hourly files of scripts/run_nar_train_gcom_full.sh's
# range, the fewest that give two evals at its 5 training hours an eval
G1_CLI_BUNDLE = {"--num_articles": "46033", "--ace_dim": "250",
                 "--mean_sessions_per_hour": "2600", "--seed": "7"}
G1_CLI_FILES = 11  # train 0-4, eval 5, train 5-9, eval 10, train 10
G1_CLI_WORKERS = "4"  # processes of the bundle generator and the preprocessing
G1_SCRIPT = "scripts/run_nar_train_gcom_full.sh"
# the Adressa chain through its CLIs: a pseudo-Adressa bundle at the
# published shape (data/pseudo_adressa.py, cli/make_pseudo_adressa.py), cut
# to its first hours, the fewest that give two evals at
# scripts/run_nar_train_adressa_local.sh's 5 training hours an eval; each
# CLI with its script's flags
ADRESSA_BUNDLE = {"--num_articles": "13000", "--sessions_per_hour": "2600",
                  "--vocab_size": "20000", "--seed": "11"}
ADRESSA_CLI_FILES = 11  # train 0-4, eval 5, train 5-9, eval 10, train 10
ADRESSA_SCRIPTS = {
    "acr_preprocess_adressa": "scripts/run_acr_preprocessing_adressa.sh",
    "acr_trainer_adressa": "scripts/run_acr_training_adressa_local.sh",
    "nar_preprocess_adressa": "scripts/run_nar_preprocessing_adressa.sh",
    "nar_trainer_adressa": "scripts/run_nar_train_adressa_local.sh",
}
ACR_PROFILE_STEPS = 20  # ACR steps under the profiler: the device busy share
ACR_CPU_STEPS = 20  # ACR steps on the CPU and on the card from the same weights
# the card's ACR (f32, TF32 off) against the CPU's over ACR_CPU_STEPS steps:
# each step's task loss (relative) and the ACE (absolute) within
# tests/test_torch_cuda.py's tolerance
ACR_CARD_TOL = {"loss": 1e-4, "ace": 1e-4}
# the suffixes of the G1 trainer's six baselines (session-kNN's decay "div"
# names it v-sknn)
G1_BASELINES = ("pop_recent", "coocurrent", "item_knn", "v-sknn", "cb", "sr")
# a resumed hour against the original: the loss's relative difference, HR's
# and MRR's, the largest parameter difference after the hour's training.
# pool_gather's index_add_ backward sums with atomics on the card, so a
# sound resume may differ in the last f32 bits (read on an H100: parameters
# 5.2e-7, the rest 0); a re-seeded generator or dropped Adam state read
# loss >= 2.2e-4, HR >= 3.9e-4, MRR >= 1.7e-3, parameters >= 2.8e-4.  HR and
# MRR allow about one ranked click of ~5,000 to flip
RESUME_TOL = {"loss": 1e-5, "hr": 2.5e-4, "mrr": 2.5e-4, "param": 1e-5}
# the dense train path with dropout at G1 width: the keep probability (the
# reference's hypertuning grid, nar_mlengine_hypertuning.yaml) and its counted
# steps; the card against the CPU on a small model with the same masks: the
# losses (relative) and each gradient normwise
DROPOUT_KEEP = 0.8
DROPOUT_STEPS = 10
DROPOUT_CARD_TOL = 1e-4
# the G1 sweep through its CLI: phase 6's first session files, the fewest that
# give one eval at the script's 5 training hours an eval, and an ML Engine
# spec over the reference grid's dropout values, two trials at a time
SWEEP_FILES = 6
SWEEP_SPEC = {"trainingInput": {"hyperparameters": {
    "goal": "MAXIMIZE", "hyperparameterMetricTag": "mrr_at_n", "maxTrials": 2,
    "maxParallelTrials": 2, "params": [{"parameterName": "dropout_keep_prob",
                                        "type": "DISCRETE", "discreteValues": [0.8, 1.0]}]}}}
# G1 ACR through its CLIs: the pseudo-Adressa generator's 13,000 articles with
# a 300-dim word2vec file (G1's skip_s300), each CLI with its script's flags,
# the autoencoder cut to one of its 20 epochs and doc2vec to 5 of its 30
G1_ACR_SPEC = {"num_articles": 13000, "word_dim": 300, "seed": 11}
G1_ACR_SCRIPTS = {
    "acr_preprocess_gcom": "scripts/run_acr_preprocessing_gcom.sh",
    "acr_trainer_gcom": "scripts/run_acr_training_gcom_autoencoder.sh",
}
G1_ACR_EPOCHS = "1"
DOC2VEC_EPOCHS = "5"
# the neural baselines through their CLIs on phase 6's session files: GRU4Rec
# with its script's flags, SR-GNN with its CLI's defaults at the script's
# --num_items; NEURAL_CPU_STEPS steps of each at that width on the CPU and on
# the card (f32, TF32 off) from the same weights and draws: each step's loss
# (relative) and each parameter (normwise); NEURAL_PROFILE_STEPS profiled steps
GRU4REC_SCRIPT = "scripts/run_gru4rec_gcom.sh"
NEURAL_CPU_STEPS = 3
NEURAL_CARD_TOL = 1e-4
NEURAL_PROFILE_STEPS = 5
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


def g1_setup(port, num_items=46033):
    """The G1 reproduction schemas and NARConfig (bench.py::_g1_setup), with
    the session RNN on the hand-written kernel."""
    FeatureSpec = port.FeatureSpec
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


def cand_score_bound_ms(operands, cuda_cores=False):
    """(least ms, what bounds it, operations) for the fused scorer on these
    operands: every input read once and the [N] f32 scores written once;
    2 N (C C + C M1 + M1 M2 + M2 M3) + 2 N M3 operations at the dtype's
    peak (``_scorer_rate``: bf16 tensor cores; f32 as split TF32 on the
    tensor cores, or with ``cuda_cores`` on the CUDA cores)."""
    i_rows, _, _, _, _, w1, _, w2, _, w3 = operands[:10]
    n, c = i_rows.shape
    m1, m2, m3 = w1.shape[1], w2.shape[1], w3.shape[1]
    n_bytes = sum(t.numel() * t.element_size() for t in operands) + n * 4
    n_ops = 2 * n * (c * c + c * m1 + m1 * m2 + m2 * m3) + 2 * n * m3
    return bound(n_bytes, n_ops, _scorer_rate(i_rows.dtype, cuda_cores)) + (n_ops,)


def _scorer_rate(dtype, cuda_cores=False):
    """The peak rate of the scorer's work in ``dtype``: bf16 on the tensor
    cores; f32-accurate work at a third of the TF32 tensor cores' rate (the
    kernels' split TF32), or with ``cuda_cores`` the CUDA cores' f32 rate."""
    if dtype == torch.bfloat16:
        return H100_BF16_FLOP_PER_S
    return H100_F32_FLOP_PER_S if cuda_cores else H100_SPLIT_TF32_FLOP_PER_S


def cand_score_stash_bound_ms(operands, cuda_cores=False):
    """(least ms, what bounds it) for the training forward: the forward's
    work, plus the [N, C] nc written once."""
    i_rows = operands[0]
    _, _, n_ops = cand_score_bound_ms(operands)
    n_bytes = (sum(t.numel() * t.element_size() for t in operands)
               + i_rows.shape[0] * 4 + i_rows.numel() * i_rows.element_size())
    return bound(n_bytes, n_ops, _scorer_rate(i_rows.dtype, cuda_cores))


def cand_score_bwd_bound_ms(operands, cuda_cores=False):
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
    return bound(n_bytes, n_ops, _scorer_rate(i_rows.dtype, cuda_cores))


def cand_score_bwd_recompute_bound_ms(operands, cuda_cores=False):
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
    return bound(n_bytes, n_ops, _scorer_rate(i_rows.dtype, cuda_cores))


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
    largest max error against the twin.  In f32 the twin runs on the stash
    forward's nc: the twin's own (cuBLAS's f32 product, up to 2.6e-6 from
    the exactly rounded nc) flips leaky' where a pre-activation lies within
    that of 0, which only a forward repeating cuBLAS's summation order would
    match (``scripts/scorer_f32_accuracy.py`` measures it)."""
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer

    grads = cand_scorer.cand_score_bwd_recompute_kernel(*operands, g)
    _, nc = cand_scorer.cand_score_kernel(*operands, return_nc=True)
    ref = cand_scorer.cand_score_bwd_reference(
        *operands, nc if nc.dtype == torch.float32 else None, g)
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


def scorer_scratch_bytes(operands, which):
    """Bytes of scratch the scorer's forward (``which`` "fwd") or backward
    ("bwd") library asks for on these operands."""
    from chameleon_recsys_tpu_torch.ops.kernels import build

    i_rows, u = operands[0], operands[1]
    n, c = i_rows.shape
    m1, m2, m3 = (operands[i].shape[1] for i in (5, 7, 9))
    code = 1 if i_rows.dtype == torch.bfloat16 else 0
    if which == "fwd":
        fn = build.load("cand_score_fwd").cand_score_fwd_scratch_bytes
        fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
        args = (n, c, m1, m2, m3, code)
    else:
        fn = build.load("cand_score_bwd").cand_score_bwd_scratch_bytes
        fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6
        args = (n, n // u.shape[0], c, m1, m2, m3, code)
    fn.restype = ctypes.c_longlong
    return fn(*args)


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


def print_profile(label, fn, calls, host_ms):
    """Prints ``device_profile`` over ``calls`` calls of ``fn``: the card's
    busy time and launches a call, its share of the unprofiled ``host_ms`` a
    call (the share of a call the card is busy) and the top kernels."""
    prof = device_profile(fn, calls)
    if prof is None:
        print(f"profile {label}: the profiler saw no device time")
        return
    print(f"profile {label}: device busy {prof.busy_us:.1f} us per call, "
          f"{prof.launches:.0f} device kernels/copies per call; busy share of the "
          f"unprofiled {host_ms:.3f} ms {prof.busy_share(host_ms):.3f}")
    for name, us, count in prof.kernels[:8]:
        print(f"  {us:9.1f} us/call  x{count:<5.1f} {name[:100]}")


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
    from chameleon_recsys_tpu_torch.ops.kernels import launch_counts as counts

    return counts()


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
    # the directory backend at the same point: written, loaded into an
    # initialised harness, its parameters and Adam moments bit-equal
    t0 = time.perf_counter()
    directory = harness.save_checkpoint_dcp()
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    by_dcp = make()
    by_dcp.init_state()
    t0 = time.perf_counter()
    by_dcp.load_checkpoint_dcp(directory)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in directory.rglob("*") if f.is_file())
    same = [torch.equal(p, q) for p, q in zip(harness.state.model.parameters(),
                                               by_dcp.state.model.parameters())]
    same += [torch.equal(harness.state.optimizer.state[p][k], by_dcp.state.optimizer.state[q][k])
             for p, q in zip(harness.state.model.parameters(), by_dcp.state.model.parameters())
             for k in ("exp_avg", "exp_avg_sq")]
    print(f"checkpoint (directory, torch.distributed.checkpoint): {size} bytes in "
          f"{sum(1 for f in directory.rglob('*') if f.is_file())} files, save {save_s:.3f} s, "
          f"load {load_s:.3f} s; parameters and Adam moments bit-equal {all(same)}")
    check(all(same) and (by_dcp.hours_trained, by_dcp.evals_done)
          == (harness.hours_trained, harness.evals_done),
          "checkpoint (directory): the loaded state differs from the saved one")

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

    outcomes = {}

    def readings(h, label, against=original):
        """One more hour on ``h`` against the original harness's (or
        ``against``): the loss's relative difference, HR's and MRR's, and
        the largest parameter difference after the hour's training."""
        (stats_a, row_a), (stats_b, row_b) = against, next_hour(h)
        outcomes[label] = (stats_b, row_b)
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
    # the directory-resumed run against the pickle-resumed one (the
    # parameter difference is still from the original's)
    sound = beyond(readings(by_dcp, "sound, directory checkpoint", outcomes["sound"]))
    check(not sound, f"resume (directory): the next hour differs from the pickle-resumed "
                     f"run's beyond the tolerance in {sound}")
    del by_dcp
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


def script_flags(script, dropped):
    """The flags of ``script``'s ``python -m`` line but those in
    ``dropped`` (its paths and file range)."""
    text = (ROOT / script).read_text().replace("\\\n", " ")
    tokens = shlex.split(text[text.index("python -m"):].splitlines()[0])[3:]
    flags, i = [], 0
    while i < len(tokens):
        takes_value = i + 1 < len(tokens) and not tokens[i + 1].startswith("--")
        if tokens[i] not in dropped:
            flags += tokens[i: i + 1 + takes_value]
        i += 1 + takes_value
    return flags


def g1_script_flags():
    """The trainer flags of ``G1_SCRIPT`` but its paths and file range."""
    return script_flags(G1_SCRIPT, {
        "--train_set_path_regex", "--acr_module_articles_metadata_csv_path",
        "--acr_module_articles_content_embeddings_pickle_path", "--model_dir",
        "--train_files_from", "--train_files_up_to"})


@contextlib.contextmanager
def timed_trainer_cli(module, label):
    """Within the block ``module.main`` (a NAR trainer CLI) runs a harness
    that times every train and eval hour (synchronised host clock) and
    prints each eval hour's wall, phases and each baseline's share of the
    benchmark tier; yields ``(walls, sessions_read)``."""
    from chameleon_recsys_tpu_torch.baselines.benchmarks import BenchmarkRecommender

    walls = {"train": [], "eval": []}
    sessions_read = []
    # baseline -> [evaluate's wall seconds, its thread's CPU seconds]: the
    # tier runs the baselines on a thread pool, where a wall also holds the
    # waits for the interpreter lock and the CPU time does not
    tier = collections.defaultdict(lambda: [0.0, 0.0])
    tier_lock = threading.Lock()

    class TimedHarness(module.TemporalHarness):
        def train_hour(self, sessions):
            sessions_read.append(("train", len(sessions)))
            t0 = time.perf_counter()
            stats = super().train_hour(sessions)
            torch.cuda.synchronize()
            walls["train"].append(time.perf_counter() - t0)
            return stats

        def evaluate_hour(self, sessions):
            sessions_read.append(("eval", len(sessions)))
            tier.clear()
            t0 = time.perf_counter()
            row = super().evaluate_hour(sessions)
            torch.cuda.synchronize()
            walls["eval"].append(time.perf_counter() - t0)
            print(f"{label} eval hour {len(walls['eval'])}: {len(sessions)} sessions, "
                  f"{walls['eval'][-1]:.3f} s wall; phases (s) "
                  + ", ".join(f"{k} {v:.4f}" for k, v in self.last_eval_phase_seconds.items())
                  + "; benchmark tier by baseline (evaluate's wall / its thread's "
                  "CPU s) " + ", ".join(f"{k} {w:.4f} / {c:.4f}"
                                        for k, (w, c) in sorted(tier.items())))
            return row

    evaluate = BenchmarkRecommender.evaluate

    def timed_evaluate(self, *args, **kwargs):
        t0, c0 = time.perf_counter(), time.thread_time()
        try:
            return evaluate(self, *args, **kwargs)
        finally:
            wall, cpu = time.perf_counter() - t0, time.thread_time() - c0
            with tier_lock:
                tier[self.get_clf_suffix()][0] += wall
                tier[self.get_clf_suffix()][1] += cpu

    trainer_class = module.TemporalHarness
    module.TemporalHarness = TimedHarness
    BenchmarkRecommender.evaluate = timed_evaluate
    try:
        yield walls, sessions_read
    finally:
        module.TemporalHarness = trainer_class
        BenchmarkRecommender.evaluate = evaluate


def run_trainer_cli(module, argv, label):
    """``module.main(argv)`` on the card with the launch counters zeroed just
    before and read just after, timed by ``timed_trainer_cli``; checks the
    exit, that the steps ran on the card and that no kernel launched (the
    trainer CLIs' default path is the plain one).  Returns the counts and
    the eval CSV's rows."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    memory_before = torch.cuda.max_memory_allocated()
    with timed_trainer_cli(module, label) as (walls, sessions_read):
        zero_launch_counts()
        t0 = time.perf_counter()
        try:
            module.main(argv)
            rc = 0
        except SystemExit as exit_info:  # main exits only on an error
            rc = exit_info.code
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = launch_counts()
    memory_peak = torch.cuda.max_memory_allocated()
    print(f"{label}: rc {rc}, {run_s:.3f} s wall; sessions read by hour {sessions_read}; "
          "train hours " + ", ".join(f"{w:.3f}" for w in walls["train"])
          + " s wall; eval hours " + ", ".join(f"{w:.3f}" for w in walls["eval"])
          + f" s wall; peak device memory {memory_peak / 2**30:.3f} GiB "
          f"(before {memory_before / 2**30:.3f}); kernel launches {counts}")
    check(rc in (0, None), f"{label}: {module.__name__} exited with {rc}")
    check(memory_peak > memory_before, f"{label}: the steps did not run on the card")
    check(not any(counts.values()),
          f"{label}: a kernel launched on the CLI's default (plain) path: {counts}")
    model_dir = Path(argv[argv.index("--model_dir") + 1])
    with open(model_dir / "eval_stats_benchmarks.csv") as f:
        rows = list(csv.DictReader(f))
    for i, row in enumerate(rows):
        missing = [b for b in G1_BASELINES if f"hitrate_at_n_{b}" not in row]
        check(not missing, f"{label}: eval row {i} lacks the columns of {missing}")
        check(all(np.isfinite(float(v)) for v in row.values()),
              f"{label}: eval row {i}: a column is not finite")
        check(row["hitrate_at_n"] == row["hitrate_at_n_chameleon"],
              f"{label}: eval row {i}: device HR != host HR")
    return counts, rows


def g1_cli_phase(workdir):
    """The G1 pipeline through the port's CLIs, on the card: a pseudo-G1
    bundle at the published shape (``make_pseudo_g1``), its session
    TFRecords (``nar_preprocess_gcom``), then ``nar_trainer_gcom.main`` in
    this process with ``G1_SCRIPT``'s flags over its first ``G1_CLI_FILES``
    files, the scalars, histograms and an artifact store.  Checks the run,
    the eval CSV (two rows, every baseline's columns, the device HR equal to
    the host suite's), the synced copy against ``model_dir`` and that the
    steps ran on the card; prints the walls, the eval hours' phases and each
    baseline's share of the benchmark tier.  Returns the kernel launches of
    the run (the CLI's default path takes the plain branch: none), the
    trainer's flags and the eval CSV's rows."""
    from chameleon_recsys_tpu_torch.cli import (
        make_pseudo_g1,
        nar_preprocess_gcom,
        nar_trainer_gcom,
    )

    bundle, model_dir, store = (workdir / d for d in ("bundle", "model", "store"))
    t0 = time.perf_counter()
    make_pseudo_g1.main(["--output_dir", str(bundle), "--hours", str(G1_CLI_FILES),
                         "--num_workers", G1_CLI_WORKERS]
                        + [v for kv in G1_CLI_BUNDLE.items() for v in kv])
    bundle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nar_preprocess_gcom.main([
        "--input_clicks_csv_path_regex", str(bundle / "clicks" / "clicks_hour_*.csv"),
        "--output_sessions_tfrecords_path",
        str(bundle / "sessions" / "sessions_hour_*.tfrecord.gz"),
        "--num_workers", G1_CLI_WORKERS])
    preprocess_s = time.perf_counter() - t0
    print(f"g1 cli: pseudo-G1 bundle ({G1_CLI_FILES} hours, "
          + ", ".join(f"{k[2:]} {v}" for k, v in G1_CLI_BUNDLE.items())
          + f") {bundle_s:.3f} s, preprocessing {preprocess_s:.3f} s")

    argv = ["--train_set_path_regex", str(bundle / "sessions" / "sessions_hour_*.tfrecord.gz"),
            "--acr_module_articles_metadata_csv_path", str(bundle / "articles_metadata.csv"),
            "--acr_module_articles_content_embeddings_pickle_path",
            str(bundle / "articles_embeddings.pickle"), "--model_dir", str(model_dir),
            "--train_files_from", "0", "--train_files_up_to", str(G1_CLI_FILES),
            *g1_script_flags(), "--save_scalars", "--save_histograms",
            "--artifact_store_root", str(store), "--sync_artifacts_to", "run"]
    print(f"g1 cli: nar_trainer_gcom {' '.join(argv[8:])}")
    zero_sknn_counts()
    counts, rows = run_trainer_cli(nar_trainer_gcom, argv, "g1 cli")
    # the session-kNN takes its C++ predictor by default, as the JAX CLI's does
    native_calls, numpy_calls = sknn_counts()
    print(f"g1 cli: session-kNN predict calls on the C++ predictor (the default) "
          f"{native_calls}, on the numpy row loop {numpy_calls}")
    check(native_calls > 0 and numpy_calls == 0,
          f"g1 cli: the session-kNN ran {numpy_calls} predicts on numpy")
    expected_rows = (G1_CLI_FILES - 1) // 5
    check(len(rows) == expected_rows, f"g1 cli: {len(rows)} eval rows, expected "
          f"{expected_rows}")
    for i, row in enumerate(rows):
        values = {k: float(v) for k, v in row.items()}
        print(f"g1 cli eval row {i}: eval_hour {row['eval_hour']}, clicks "
              f"{row['clicks_count']}, sessions {row['sessions_count']}, "
              f"train_sessions_per_s {float(row['train_sessions_per_s']):.1f}; hitrate_at_n "
              + ", ".join(f"{b} {values[f'hitrate_at_n_{b}']:.4f}"
                          for b in ("chameleon",) + G1_BASELINES))
    synced = {p.relative_to(store / "run"): p.read_bytes()
              for p in (store / "run").rglob("*") if p.is_file()}
    local = {p.relative_to(model_dir): p.read_bytes()
             for p in model_dir.rglob("*") if p.is_file()}
    # the CLI writes checkpoint.pkl after its last export, as the JAX CLI does
    unsynced = sorted(str(p) for p in set(local) - set(synced))
    print(f"g1 cli: synced {sorted(str(p) for p in synced)}; only in model_dir {unsynced}")
    check(synced and all(local.get(p) == v for p, v in synced.items())
          and unsynced == ["checkpoint.pkl"],
          "g1 cli: the synced copy differs from model_dir")
    return counts, argv, rows


def acr_cpu_vs_card(articles, word_embeddings, encoders, class_weights):
    """``ACR_CPU_STEPS`` ACR train steps at the published ACR width (CNN
    3/4/5 x 128, ACE 250, batch 8, the pseudo-Adressa vocabulary and label
    heads) on the CPU and on the card, from the same weights (one seed) and
    the same batches; the card runs f32 without TF32, as the port's ACR
    does.  Holds the per-step task losses (relative) and the ACE of the
    articles trained on (absolute) within ``ACR_CARD_TOL``."""
    from chameleon_recsys_tpu_torch.acr.trainer import ACRTrainer
    from chameleon_recsys_tpu_torch.config import ACRConfig
    from chameleon_recsys_tpu_torch.models.acr import ACRLabelSpec

    class RecordingTrainer(ACRTrainer):
        def train_step(self, batch, weights):
            loss, task_loss = super().train_step(batch, weights)
            self.task_losses.append(task_loss)
            return loss, task_loss

    subset = {k: v[:ACR_CPU_STEPS * 8] for k, v in articles.items()}
    cfg = ACRConfig(text_feature_extractor="CNN", batch_size=8, training_epochs=1,
                    learning_rate=3e-4, l2_reg_lambda=1e-5, acr_embeddings_size=250,
                    word_embedding_size=word_embeddings.shape[1],
                    vocab_size=word_embeddings.shape[0])
    specs = (ACRLabelSpec("category0", len(encoders["category0"]), "multiclass"),
             ACRLabelSpec("keywords", len(encoders["keywords"]), "multilabel"))
    losses, aces = {}, {}
    for device in ("cpu", "cuda"):
        trainer = RecordingTrainer(
            cfg, word_embeddings, specs,
            {"category0": np.asarray(class_weights["category0"], np.float32)},
            device=device)
        trainer.task_losses = []
        trainer.fit(subset)
        losses[device] = torch.stack(trainer.task_losses).cpu().numpy()
        aces[device] = trainer.predict_all_ace(subset)
    loss_err = float(np.max(np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])))
    ace_err = float(np.max(np.abs(aces["cuda"] - aces["cpu"])))
    print(f"adressa acr cpu vs card: {len(losses['cpu'])} steps at batch 8, task loss "
          f"{losses['cpu'][0]:.5f} -> {losses['cpu'][-1]:.5f}; max relative loss "
          f"difference {loss_err:.3e} (tolerance {ACR_CARD_TOL['loss']}), max ACE "
          f"difference {ace_err:.3e} (tolerance {ACR_CARD_TOL['ace']})")
    check(len(losses["cpu"]) == ACR_CPU_STEPS, "adressa acr cpu vs card: step count")
    check(loss_err <= ACR_CARD_TOL["loss"], "adressa acr: card losses differ from the CPU's")
    check(ace_err <= ACR_CARD_TOL["ace"], "adressa acr: card ACE differs from the CPU's")


def recording_acr_trainer(base):
    """A subclass of the ACR trainer class ``base`` that records its step
    losses (device scalars, fetched after the run), its instance and
    corpus, its fit's steps and time (CUDA events over the epochs) and its
    train-set metrics; returns (the subclass, the record)."""
    record = {"step_losses": []}

    class RecordingACRTrainer(base):
        def train_step(self, batch, weights):
            loss, task_loss = super().train_step(batch, weights)
            record["step_losses"].append(task_loss)
            return loss, task_loss

        def fit(self, articles):
            record.update(trainer=self, articles=articles)
            steps = -(-len(articles["article_id"]) // self.cfg.batch_size)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            losses = super().fit(articles)
            end.record()
            torch.cuda.synchronize()
            record.update(steps=steps * self.cfg.training_epochs, losses=losses,
                          fit_ms=start.elapsed_time(end))
            return losses

        def evaluate(self, articles):
            record["metrics"] = super().evaluate(articles)
            return record["metrics"]

    return RecordingACRTrainer, record


def adressa_cli_phase(workdir):
    """The Adressa chain through the port's CLIs, on the card:
    ``make_pseudo_adressa`` at the published shape (``ADRESSA_BUNDLE``,
    ``ADRESSA_CLI_FILES`` hours), ``acr_preprocess_adressa``,
    ``acr_trainer_adressa``, ``nar_preprocess_adressa`` and
    ``nar_trainer_adressa`` in this process, each with its script's flags
    (``ADRESSA_SCRIPTS``).  Checks each run, the ACR step losses (one a
    step, finite), the ACE matrix (shape, finite, row 0 the mean), the eval
    CSV (two rows, every baseline's columns, the device HR equal to the
    host suite's), that the NAR steps ran on the card and that no kernel
    launched on either trainer; then ``acr_cpu_vs_card``.  Prints each
    CLI's wall, ACR ms a step (CUDA events over the epoch), every train and
    eval hour's wall, the eval hours' phases, HR@5 and MRR@5 per
    recommender and the peak device memory.  Returns the kernel launches of
    the two trainers (none) and a function that prints the device busy
    share of an ACR step (torch profiler over ``ACR_PROFILE_STEPS`` steps),
    which ``main`` calls after its other profiles.  The ACR train-set
    accuracy is printed, not checked: at the script's flags (one epoch at
    batch 8, lr 3e-4, class-balanced weights) the JAX package's ACR too
    ends near chance on the pseudo-Adressa corpus."""
    import zoneinfo

    from chameleon_recsys_tpu_torch.cli import (
        acr_preprocess_adressa,
        acr_trainer_adressa,
        make_pseudo_adressa,
        nar_preprocess_adressa,
        nar_trainer_adressa,
    )

    bundle, acr, model_dir = (workdir / d for d in ("bundle", "acr", "model"))
    sessions = workdir / "sessions" / "sessions_hour_*.tfrecord.gz"
    ace_path, resources = workdir / "acr_articles_metadata_embeddings.pickle", \
        workdir / "nar_preprocessing_resources.pickle"
    paths = {"--input_articles_json_path", "--input_word_embeddings_path", "--output_dir",
             "--train_set_path_regex", "--input_word_vocab_embeddings_path",
             "--input_label_encoders_path", "--output_acr_metadata_embeddings_path",
             "--input_clicks_json_path", "--output_sessions_tfrecords_path",
             "--output_nar_preprocessing_resources_path", "--acr_module_resources_path",
             "--nar_module_preprocessing_resources_path", "--model_dir"}
    flags = {name: script_flags(script, paths) for name, script in ADRESSA_SCRIPTS.items()}
    walls = {}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    timed("make_pseudo_adressa", make_pseudo_adressa.main,
          ["--output_dir", str(bundle), "--hours", str(ADRESSA_CLI_FILES), "--quiet"]
          + [v for kv in ADRESSA_BUNDLE.items() for v in kv])
    timed("acr_preprocess_adressa", acr_preprocess_adressa.main, [
        "--input_articles_json_path", str(bundle / "articles.jsonl"),
        "--input_word_embeddings_path", str(bundle / "w2v.txt"),
        "--output_dir", str(acr), *flags["acr_preprocess_adressa"]])

    # the ACR trainer: timed by CUDA events over its epoch, its step losses
    # (device scalars, fetched after the run) and its instance kept
    timed_class, record = recording_acr_trainer(acr_trainer_adressa.ACRTrainer)

    acr_argv = ["--train_set_path_regex", str(acr / "articles_tokenized_*.tfrecord.gz"),
                "--input_word_vocab_embeddings_path",
                str(acr / "acr_word_vocab_embeddings.pickle"),
                "--input_label_encoders_path", str(acr / "acr_label_encoders.pickle"),
                "--output_acr_metadata_embeddings_path", str(ace_path),
                *flags["acr_trainer_adressa"]]
    print(f"adressa cli: acr_trainer_adressa {' '.join(acr_argv[8:])}")
    trainer_class = acr_trainer_adressa.ACRTrainer
    acr_trainer_adressa.ACRTrainer = timed_class
    zero_launch_counts()
    try:
        timed("acr_trainer_adressa", acr_trainer_adressa.main, acr_argv)
    finally:
        acr_trainer_adressa.ACRTrainer = trainer_class
    acr_counts = launch_counts()
    trainer, articles = record["trainer"], record["articles"]
    encoders, _, ace = pickle_load(ace_path)
    n_articles = int(ADRESSA_BUNDLE["--num_articles"])
    row0_err = float(np.max(np.abs(ace[0] - ace[1:].mean(axis=0))))
    step_losses = torch.stack(record["step_losses"]).cpu().numpy()
    first, last = (float(step_losses[i].mean()) for i in (slice(0, 100), slice(-100, None)))
    chance = 1.0 / (len(encoders["category0"]) - 2)  # less <PAD> and <UNF>
    print(f"adressa cli: ACR {record['steps']} steps at batch {trainer.cfg.batch_size}, "
          f"{record['fit_ms'] / record['steps']:.3f} ms a step (CUDA events over the "
          f"epoch), task loss over the first / last 100 steps {first:.4f} / {last:.4f}, "
          f"epoch {record['losses'][-1]:.5f}; train-set metrics {record['metrics']} "
          f"(category0 chance {chance:.4f}); ACE matrix {list(ace.shape)} {ace.dtype}, "
          f"row 0 - mean of rows 1.. max {row0_err:.2e}; kernel launches {acr_counts}")
    check(len(step_losses) == record["steps"] and np.isfinite(step_losses).all(),
          "adressa cli: ACR step losses")
    check(ace.shape == (n_articles + 1, 250) and np.isfinite(ace).all(),
          f"adressa cli: ACE matrix {ace.shape}")
    check(row0_err <= 1e-6, "adressa cli: ACE row 0 is not the mean embedding")
    check(not any(acr_counts.values()), f"adressa cli: a kernel launched in ACR: "
          f"{acr_counts}")
    # the device's busy share of ACR steps (TF32 is off in this script, as
    # in the trainer's steps): one batch, timed, then profiled; run by main
    # after the other profiles (a profiler session this early left later
    # sessions short of their first launches)
    batch = {k: torch.as_tensor(v[:8], device="cuda") for k, v in articles.items()}
    weights = torch.ones(8, device="cuda")

    def profile_acr_step():
        host_ms = cuda_ms(lambda: trainer.train_step(batch, weights), ACR_PROFILE_STEPS)
        print_profile("adressa acr train step (batch 8, CNN)",
                      lambda: trainer.train_step(batch, weights), ACR_PROFILE_STEPS,
                      host_ms)

    zoneinfo.ZoneInfo("Europe/Oslo")  # raises where the tz database lacks it
    timed("nar_preprocess_adressa", nar_preprocess_adressa.main, [
        "--input_clicks_json_path", str(bundle / "clicks.jsonl"),
        "--output_sessions_tfrecords_path", str(sessions),
        "--output_nar_preprocessing_resources_path", str(resources),
        *flags["nar_preprocess_adressa"]])
    nar_argv = ["--train_set_path_regex", str(sessions),
                "--acr_module_resources_path", str(ace_path),
                "--nar_module_preprocessing_resources_path", str(resources),
                "--model_dir", str(model_dir), *flags["nar_trainer_adressa"],
                "--save_scalars"]
    print(f"adressa cli: nar_trainer_adressa {' '.join(nar_argv[8:])}; Europe/Oslo in "
          "the tz database")
    t0 = time.perf_counter()
    nar_counts, rows = run_trainer_cli(nar_trainer_adressa, nar_argv, "adressa cli")
    walls["nar_trainer_adressa"] = time.perf_counter() - t0
    n_files = len(list(sessions.parent.iterdir()))
    expected_rows = (n_files - 1) // 5
    check(n_files == ADRESSA_CLI_FILES and len(rows) == expected_rows,
          f"adressa cli: {n_files} hour files, {len(rows)} eval rows")
    for i, row in enumerate(rows):
        values = {k: float(v) for k, v in row.items()}
        print(f"adressa cli eval row {i}: eval_hour {row['eval_hour']}, clicks "
              f"{row['clicks_count']}, sessions {row['sessions_count']}; HR@5 / MRR@5 "
              + ", ".join(f"{b} {values[f'hitrate_at_n_{b}']:.4f} / "
                          f"{values[f'mrr_at_n_{b}']:.4f}"
                          for b in ("chameleon",) + G1_BASELINES))
    print("adressa cli walls (s): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    acr_cpu_vs_card(articles, trainer.model.word_embeddings.cpu().numpy(), encoders,
                    pickle_load(acr / "acr_label_encoders.pickle")["class_weights"])
    return {k: acr_counts[k] + nar_counts[k] for k in nar_counts}, profile_acr_step


def pickle_load(path):
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


@contextlib.contextmanager
def seeded_draws(seed):
    """Within the block the port's dropout masks (and the ACR autoencoder's
    noise) come from ``np.random.RandomState(seed)``, call by call: a run on
    the CPU and one on the card draw the same."""
    from chameleon_recsys_tpu_torch.models import acr as acr_models
    from chameleon_recsys_tpu_torch.ops import dropout as dropout_module

    rng = np.random.RandomState(seed)
    saved = dropout_module._draw_mask, acr_models._draw_noise
    dropout_module._draw_mask = lambda shape, keep, generator, device: torch.from_numpy(
        rng.rand(*shape) < keep).to(device)
    acr_models._draw_noise = lambda shape, generator, device: torch.from_numpy(
        rng.randn(*shape).astype(np.float32)).to(device)
    try:
        yield
    finally:
        dropout_module._draw_mask, acr_models._draw_noise = saved


def dropout_cpu_vs_card(port, corpus_fn):
    """One dense train step at ``DROPOUT_KEEP`` of the small float32 model
    (compaction, both kernel flags on) on the CPU and on the card, with the
    same uniforms and dropout masks (numpy, seeded): the losses (relative)
    and every gradient (``||card - cpu|| <= 1e-4 ||cpu|| + 1e-5``) within
    ``DROPOUT_CARD_TOL``; the card step launches K2f and K2b and no scorer
    kernel."""
    from chameleon_recsys_tpu_torch.data.collate import collate_sessions
    from chameleon_recsys_tpu_torch.data.synthetic import synthetic_hour_sessions
    from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
    from chameleon_recsys_tpu_torch.state.stream_state import init_stream_state
    from chameleon_recsys_tpu_torch.train.steps import init_train_state, train_step

    cfg, sess, art = tiny_setup(port)
    cfg = dataclasses.replace(cfg, keep_prob=DROPOUT_KEEP, train_valid_row_capacity=48)
    corpus = corpus_fn(art, ace_dim=8)
    b, length = cfg.batch_size, cfg.max_session_length
    warm, batch = (collate_sessions(synthetic_hour_sessions(corpus, sess, h, b, length),
                                    sess, b, length) for h in (0, 1))
    m = cfg.negative_sample_from_buffer
    nc = min(cfg.negative_samples * cfg.neg_sampling_multiplying_factor, b * length + m)
    rng = np.random.RandomState(7)
    uniforms = [rng.uniform(size=shape).astype(np.float32) for shape in (
        (cfg.recent_clicks_buffer_max_size,), (b * length + m,), (48, nc))]
    base = port.NARModel(cfg, sess, art, corpus.ace_matrix.shape[1])
    base.reset_parameters(torch.Generator().manual_seed(8))
    out = {}
    for device in ("cpu", "cuda"):
        model = port.NARModel(cfg, sess, art, corpus.ace_matrix.shape[1]).to(device)
        model.load_state_dict(base.state_dict())
        stream = warm_stream(init_stream_state(cfg, art.num_items, device=device), [warm],
                             cfg, device)
        before = launch_counts()
        with seeded_draws(9):
            _, metrics = train_step(
                init_train_state(model, stream, torch.Generator(device=device)),
                to_device(batch, device), torch.from_numpy(corpus.ace_matrix).to(device),
                {k: torch.from_numpy(np.asarray(v)).to(device)
                 for k, v in corpus.metadata.items()},
                uniforms=SamplerUniforms(*(torch.from_numpy(u).to(device) for u in uniforms)))
        launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        out[device] = (metrics, {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                       launched)
    (cpu_metrics, cpu_grads, _), (gpu_metrics, gpu_grads, launched) = out["cpu"], out["cuda"]
    excess = {n: ((gpu_grads[n] - g).norm() - DROPOUT_CARD_TOL * g.norm()).item()
              for n, g in cpu_grads.items()}
    worst = max(excess, key=excess.get)
    loss_err = max(abs(float(gpu_metrics[k]) - float(cpu_metrics[k])) / abs(float(cpu_metrics[k]))
                   for k in ("loss", "ce_loss"))
    print(f"dropout step (keep {DROPOUT_KEEP}, small f32) card vs CPU, the same masks: loss "
          f"{float(gpu_metrics['loss']):.7g} vs {float(cpu_metrics['loss']):.7g} (relative "
          f"{loss_err:.2e}, tolerance {DROPOUT_CARD_TOL}); gradients: largest ||card - cpu|| "
          f"- {DROPOUT_CARD_TOL} ||cpu|| {excess[worst]:.3e} ({worst}; tolerance 1e-5); card "
          f"launches {launched}")
    check(loss_err <= DROPOUT_CARD_TOL, "dropout step: card loss differs from the CPU's")
    check(excess[worst] <= 1e-5, "dropout step: card and CPU gradients disagree")
    check(launched == {"ugrnn_fwd": 2, "ugrnn_bwd": 2, "ugrnn_fwd_resident": 2,
                       "ugrnn_bwd_resident": 2},
          f"dropout step: the small card step's launches {launched}")


def dropout_phase(port, server, cfg, session_schema, article_schema, corpus):
    """(8) The dense train path with dropout at G1 width, counted: the G1
    config at ``keep_prob`` ``DROPOUT_KEEP`` with the UGRNN kernels on, a
    stream warmed over two hours, compaction at the bench's capacity;
    ``DROPOUT_STEPS`` steps over two batches of the next hour, timed by CUDA
    events, with the peak device memory.  Checks the launches (per step K2f
    and K2b twice each, on the resident instantiation, no scorer kernel), that
    no click is dropped, every loss finite; then ``dropout_cpu_vs_card``.
    Returns the launch counts and a function that profiles one step (the
    busy share and the top device operations), run by ``main`` after its
    other timings."""
    from chameleon_recsys_tpu_torch.data.synthetic import make_synthetic_corpus
    from chameleon_recsys_tpu_torch.state.stream_state import init_stream_state
    from chameleon_recsys_tpu_torch.train.steps import init_train_state, train_step

    b = cfg.batch_size
    warm = warm_stream(
        init_stream_state(cfg, corpus.num_items, device="cuda"),
        hour_batches(corpus, session_schema, cfg, 0, 2 * b)
        + hour_batches(corpus, session_schema, cfg, 1, 2 * b), cfg, "cuda")
    batches = [to_device(batch, "cuda") for batch in
               hour_batches(corpus, session_schema, cfg, 3, TRAIN_STEPS * b)]
    capacity = train_capacity(batches, cfg)
    dcfg = dataclasses.replace(cfg, keep_prob=DROPOUT_KEEP, train_valid_row_capacity=capacity)
    model = port.NARModel(dcfg, session_schema, article_schema,
                          corpus.ace_matrix.shape[1]).to("cuda")
    model.load_state_dict(server.model.state_dict())
    state = init_train_state(model, warm, torch.Generator(device="cuda").manual_seed(31))

    def step(i):
        nonlocal state
        state, metrics = train_step(state, batches[i % len(batches)], server.ace_matrix,
                                    server.metadata)
        return metrics

    step(0)  # first use: allocations, cuDNN/cuBLAS plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    per_step, metrics = [], []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for i in range(DROPOUT_STEPS):
        before = launch_counts()
        metrics.append(step(i))
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / DROPOUT_STEPS
    device_ms = start.elapsed_time(end) / DROPOUT_STEPS
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    print(f"dropout train path (keep {DROPOUT_KEEP}, capacity {capacity} rows of "
          f"{b * cfg.max_inputs_length}, {DROPOUT_STEPS} steps): {device_ms:.3f} ms a step "
          f"(CUDA events), {wall_ms:.3f} ms host wall, peak device memory "
          f"{peak / 2**30:.4f} GiB; loss {values[0]['loss']:.6g} -> {values[-1]['loss']:.6g}; "
          f"launches {counts}, per step {per_step[0]}")
    check(all(np.isfinite(v).all() for m in values for v in m.values()),
          "dropout train: a metric is not finite")
    check(all(m["dropped_clicks"] == 0 for m in values), "dropout train: clicks dropped")
    expected = {k: v for k, v in ugrnn_expected(cfg.rnn_num_layers,
                                                cfg.rnn_num_layers).items() if v}
    check(per_step == [expected] * DROPOUT_STEPS,
          f"kernel launches per dropout train step {per_step}")
    dropout_cpu_vs_card(port, make_synthetic_corpus)

    def profile_dropout_step():
        print_profile(f"dropout train step (keep {DROPOUT_KEEP}, capacity {capacity})",
                      lambda: step(0), 3, device_ms)

    return counts, profile_dropout_step


def sweep_phase(workdir):
    """(9) The G1 sweep through ``nar_hypertuning_gcom.main`` on phase 6's
    pseudo-G1 session TFRecords (files 0 to ``SWEEP_FILES`` - 1: train 0-4,
    evaluate 5) with ``G1_SCRIPT``'s flags and an ML Engine JSON spec
    (``SWEEP_SPEC``: ``dropout_keep_prob`` 0.8 and 1.0, two trials, two at a
    time), counted.  Checks each trial's eval row and objective, the order and
    ``sweep_results.json``, and that no kernel launched (the CLI's default
    path is the plain one); prints each trial's wall, objective and the
    order.  Returns the launch counts."""
    from chameleon_recsys_tpu_torch.cli import nar_hypertuning_gcom

    bundle = workdir / "bundle"
    spec = workdir / "sweep_spec.json"
    spec.write_text(json.dumps(SWEEP_SPEC))
    argv = ["--train_set_path_regex", str(bundle / "sessions" / "sessions_hour_*.tfrecord.gz"),
            "--acr_module_articles_metadata_csv_path", str(bundle / "articles_metadata.csv"),
            "--acr_module_articles_content_embeddings_pickle_path",
            str(bundle / "articles_embeddings.pickle"), "--model_dir", str(workdir / "sweep"),
            "--train_files_from", "0", "--train_files_up_to", str(SWEEP_FILES),
            *g1_script_flags(), "--sweep_spec", str(spec)]
    walls = {}

    class TimedHarness(nar_hypertuning_gcom.TemporalHarness):
        def run(self, hour_source, hours):
            t0 = time.perf_counter()
            rows = super().run(hour_source, hours)
            torch.cuda.synchronize()
            walls[Path(self.run_cfg.model_dir).name] = (self.cfg.keep_prob,
                                                        time.perf_counter() - t0)
            return rows

    harness_class = nar_hypertuning_gcom.TemporalHarness
    nar_hypertuning_gcom.TemporalHarness = TimedHarness
    print(f"sweep: nar_hypertuning_gcom {' '.join(argv[8:])}; spec {json.dumps(SWEEP_SPEC)}")
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        results = nar_hypertuning_gcom.main(argv)
    finally:
        nar_hypertuning_gcom.TemporalHarness = harness_class
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    for rank, r in enumerate(results):
        keep, wall = walls[f"trial_{r.trial_id:03d}"]
        print(f"sweep trial {r.trial_id} (rank {rank}): {r.overrides}, keep_prob {keep}, "
              f"{wall:.3f} s wall, mrr_at_n {r.objective:.6f}, hitrate_at_n "
              f"{r.metrics.get('hitrate_at_n', float('nan')):.6f}, eval clicks "
              f"{r.metrics.get('clicks_count')}, train_sessions_per_s "
              f"{r.metrics.get('train_sessions_per_s', float('nan')):.1f}")
    saved = json.loads((workdir / "sweep" / "sweep_results.json").read_text())
    print(f"sweep: {run_s:.3f} s wall for {len(results)} trials, order "
          f"{[r.trial_id for r in results]}; kernel launches {counts}")
    check(len(results) == 2 and sorted(r.overrides["keep_prob"] for r in results) == [0.8, 1.0],
          f"sweep: trials {[r.overrides for r in results]}")
    check(all(np.isfinite(r.objective) for r in results), "sweep: an objective is not finite")
    check(results[0].objective >= results[1].objective, "sweep: trials out of order")
    check([r["trial_id"] for r in saved] == [r.trial_id for r in results],
          "sweep: sweep_results.json differs from the run")
    check(all(r.metrics["hitrate_at_n"] == r.metrics["hitrate_at_n_chameleon"]
              for r in results), "sweep: device HR != host HR")
    check(not any(counts.values()), f"sweep: a kernel launched on the plain path: {counts}")
    return counts


def g1_articles(workdir):
    """A G1-layout articles CSV (article_id, category_id, created_at_ts in ms,
    text: the title and the body) from the pseudo-Adressa generator's
    articles, and its word2vec text file at ``G1_ACR_SPEC``'s 300 dims (the
    dims of G1's skip_s300); returns both paths."""
    from chameleon_recsys_tpu_torch.data.pseudo_adressa import (
        PseudoAdressaSpec,
        make_pseudo_g1_articles,
        write_articles_json,
        write_word_embeddings,
    )

    spec = PseudoAdressaSpec(**G1_ACR_SPEC)
    jsonl, articles, w2v = (workdir / n for n in ("articles.jsonl", "articles.csv", "w2v.txt"))
    write_articles_json(spec, make_pseudo_g1_articles(spec.g1_spec()), str(jsonl))
    with open(jsonl) as src, open(articles, "w", newline="") as dst:
        writer = csv.DictWriter(dst, ["article_id", "category_id", "created_at_ts", "text"])
        writer.writeheader()
        for line in src:
            rec = json.loads(line)
            writer.writerow({"article_id": rec["id"], "category_id": rec["category0"],
                             "created_at_ts": rec["createtime"] * 1000,
                             "text": f"{rec['title']}. {rec['body']}"})
    write_word_embeddings(spec, str(w2v))
    return articles, w2v


def g1_acr_phase(workdir):
    """(10) G1 ACR and the ACE baselines through their CLIs, counted: a
    G1-layout corpus (``g1_articles``: 13,000 articles, a 300-dim word2vec
    file), ``acr_preprocess_gcom`` and ``acr_trainer_gcom`` with their
    ``G1_ACR_SCRIPTS`` flags (the autoencoder: GRU 512, 30 tokens, batch 32,
    noise 0.05, ACE 250) cut to ``G1_ACR_EPOCHS`` epoch, then
    ``ace_baselines_cli`` for LSA, W2V-TF-IDF and doc2vec (250 dims,
    ``DOC2VEC_EPOCHS`` epochs), on the card.  Checks each run's pickle (the
    ACE matrix [13,001, 250], or the word width for W2V-TF-IDF, finite, row 0
    the mean), the autoencoder's step losses and that no kernel launched;
    prints each wall and the ACR ms a step (CUDA events over the epoch).
    Returns the launch counts and a function that profiles one autoencoder
    step (the busy share), run by ``main`` after its other profiles."""
    from chameleon_recsys_tpu_torch.cli import ace_baselines_cli, acr_preprocess_gcom, acr_trainer_gcom

    walls = {}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    articles, w2v = timed("g1_articles", g1_articles, workdir)
    pre, ace_path = workdir / "acr_pre", workdir / "ace_autoencoder.pickle"
    paths = {"--input_articles_csv_path", "--input_word_embeddings_path", "--output_dir",
             "--train_set_path_regex", "--input_word_vocab_embeddings_path",
             "--input_label_encoders_path", "--output_acr_metadata_embeddings_path"}
    flags = {name: script_flags(script, paths) for name, script in G1_ACR_SCRIPTS.items()}
    zero_launch_counts()
    timed("acr_preprocess_gcom", acr_preprocess_gcom.main, [
        "--input_articles_csv_path", str(articles), "--input_word_embeddings_path", str(w2v),
        "--output_dir", str(pre), *flags["acr_preprocess_gcom"]])
    inputs = ["--train_set_path_regex", str(pre / "articles_tokenized_*.tfrecord.gz"),
              "--input_word_vocab_embeddings_path", str(pre / "acr_word_vocab_embeddings.pickle"),
              "--input_label_encoders_path", str(pre / "acr_label_encoders.pickle")]
    trainer_class = acr_trainer_gcom.ACRTrainer
    timed_class, record = recording_acr_trainer(trainer_class)
    acr_argv = inputs + ["--output_acr_metadata_embeddings_path", str(ace_path),
                         *flags["acr_trainer_gcom"], "--training_epochs", G1_ACR_EPOCHS]
    print(f"g1 acr: acr_trainer_gcom {' '.join(acr_argv[6:])}")
    acr_trainer_gcom.ACRTrainer = timed_class
    try:
        timed("acr_trainer_gcom", acr_trainer_gcom.main, acr_argv)
    finally:
        acr_trainer_gcom.ACRTrainer = trainer_class
    n_articles = G1_ACR_SPEC["num_articles"]
    step_losses = torch.stack(record["step_losses"]).cpu().numpy()
    trainer = record["trainer"]
    print(f"g1 acr: autoencoder {record['steps']} steps at batch {trainer.cfg.batch_size}, "
          f"{record['fit_ms'] / record['steps']:.3f} ms a step (CUDA events over the epoch), "
          f"task loss first / last 20 steps {step_losses[:20].mean():.5f} / "
          f"{step_losses[-20:].mean():.5f}")
    check(len(step_losses) == record["steps"] and np.isfinite(step_losses).all(),
          "g1 acr: autoencoder step losses")
    shapes = {}
    for method, ace_file in [("autoencoder", ace_path)] + [
            (m, workdir / f"ace_{m}.pickle") for m in ("lsa", "w2v_tfidf", "doc2vec")]:
        if method != "autoencoder":
            timed(f"ace_baselines_cli {method}", ace_baselines_cli.main, inputs + [
                "--method", method, "--output_acr_metadata_embeddings_path", str(ace_file),
                "--acr_embeddings_size", "250", "--training_epochs", DOC2VEC_EPOCHS])
        encoders, metadata, ace = pickle_load(ace_file)
        width = 300 if method == "w2v_tfidf" else 250  # W2V-TF-IDF: the word width
        row0_err = float(np.max(np.abs(ace[0] - ace[1:].mean(axis=0))))
        shapes[method] = list(ace.shape)
        check(ace.shape == (n_articles + 1, width) and np.isfinite(ace).all(),
              f"g1 acr: {method} ACE matrix {ace.shape}")
        check(row0_err <= 1e-6, f"g1 acr: {method} ACE row 0 is not the mean embedding")
        check(set(encoders) == {"category_id", "article_id"} and len(metadata["article_id"])
              == n_articles + 1, f"g1 acr: {method} handoff pickle")
    counts = launch_counts()
    print("g1 acr: ACE matrices " + ", ".join(f"{k} {v}" for k, v in shapes.items())
          + "; walls (s) " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f"; kernel launches {counts}")
    check(not any(counts.values()), f"g1 acr: a kernel launched: {counts}")
    batch = {k: torch.as_tensor(v[:32], device="cuda") for k, v in record["articles"].items()}
    weights = torch.ones(32, device="cuda")

    def profile_autoencoder_step():
        host_ms = cuda_ms(lambda: trainer.train_step(batch, weights), ACR_PROFILE_STEPS)
        print_profile("g1 acr autoencoder train step (batch 32, GRU 512, 30 tokens)",
                      lambda: trainer.train_step(batch, weights), ACR_PROFILE_STEPS, host_ms)

    return counts, profile_autoencoder_step


@contextlib.contextmanager
def timed_neural_runner(label):
    """Within the block the neural CLIs' runner times every train and eval
    hour (synchronised host clock), prints each eval hour's wall and
    records itself; yields ``(walls, record)``."""
    from chameleon_recsys_tpu_torch.cli import run_gru4rec

    walls = {"train": [], "eval": []}
    record = {}
    base = run_gru4rec.NeuralBaselineRunner

    class TimedRunner(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            record["runner"] = self

        def train_hour(self, sessions, update_buffer=True):
            t0 = time.perf_counter()
            loss = super().train_hour(sessions, update_buffer)
            torch.cuda.synchronize()
            walls["train"].append(time.perf_counter() - t0)
            return loss

        def evaluate_hour(self, sessions):
            t0 = time.perf_counter()
            row = super().evaluate_hour(sessions)
            torch.cuda.synchronize()
            walls["eval"].append(time.perf_counter() - t0)
            print(f"{label} eval hour {len(walls['eval'])}: {len(sessions)} sessions, "
                  f"{walls['eval'][-1]:.3f} s wall")
            return row

    run_gru4rec.NeuralBaselineRunner = TimedRunner
    try:
        yield walls, record
    finally:
        run_gru4rec.NeuralBaselineRunner = base


def neural_cpu_vs_card(batches, buffer_ids, num_items):
    """``NEURAL_CPU_STEPS`` steps of GRU4Rec (the script's widths) and of
    SR-GNN (the CLI's defaults) at ``num_items`` on the CPU and on the card,
    from the same weights (both initialise from a CPU generator of one seed)
    and the same negatives (GRU4Rec's drawn by one numpy generator in place
    of its own, SR-GNN's numpy draws from one seed); holds each step's loss
    (relative) and each parameter (normwise) within ``NEURAL_CARD_TOL``."""
    from chameleon_recsys_tpu_torch.baselines import gru4rec
    from chameleon_recsys_tpu_torch.baselines.sr_gnn import SRGNN, SRGNNSessionAdapter

    draw = gru4rec._draw_negative_indices
    makers = {
        "gru4rec": lambda device: gru4rec.GRU4Rec(num_items, layers=(300,), loss="bpr-max",
                                                  bpreg=0.5, n_sample=200, device=device),
        "sr-gnn": lambda device: SRGNNSessionAdapter(SRGNN(num_items, device=device)),
    }
    try:
        for name, make in makers.items():
            runs = []
            for device in ("cpu", "cuda"):
                rng = np.random.RandomState(0)
                gru4rec._draw_negative_indices = lambda n, n_valid, g: torch.from_numpy(
                    rng.randint(0, n_valid, n)).to(g.device)
                model = make(device)
                losses = np.array([float(model.fit_batch(items, labels, buffer_ids))
                                   for items, labels in batches[:NEURAL_CPU_STEPS]])
                params = getattr(model, "model", model).params
                runs.append((losses, {n: p.detach().cpu() for n, p in params.named_parameters()}))
                del model, params
            (cpu_losses, cpu_params), (card_losses, card_params) = runs
            loss_err = float(np.max(np.abs(card_losses - cpu_losses) / np.abs(cpu_losses)))
            param_err = max(float((card_params[n] - p).norm() / p.norm())
                            for n, p in cpu_params.items())
            print(f"neural cpu vs card {name}: {len(cpu_losses)} steps at batch "
                  f"{batches[0][0].shape[0]}, {num_items} items, loss {cpu_losses[0]:.5f} -> "
                  f"{cpu_losses[-1]:.5f}; max relative loss difference {loss_err:.3e}, max "
                  f"parameter difference (normwise) {param_err:.3e} (tolerance "
                  f"{NEURAL_CARD_TOL})")
            check(np.isfinite(cpu_losses).all() and len(cpu_losses) == NEURAL_CPU_STEPS,
                  f"neural cpu vs card {name}: losses")
            check(loss_err <= NEURAL_CARD_TOL and param_err <= NEURAL_CARD_TOL,
                  f"neural cpu vs card {name}: the card differs from the CPU")
    finally:
        gru4rec._draw_negative_indices = draw


def neural_cli_phase(workdir):
    """(11) The neural baselines through the port's CLIs on phase 6's session
    files and the eval negatives its trainer wrote: ``run_gru4rec`` with
    ``GRU4REC_SCRIPT``'s flags and ``run_sr_gnn`` with its defaults at the
    script's ``--num_items``, each on the card with the launch counters zeroed
    just before and read just after.  Checks each run, its eval CSV and that
    no kernel launched; prints the walls, the peak device memory, GRU4Rec's
    memory and dense update, and each model's train step by CUDA events;
    then ``neural_cpu_vs_card``.  Returns the launches and a function that
    profiles each model's train step."""
    from chameleon_recsys_tpu_torch.cli import run_gru4rec, run_sr_gnn
    from chameleon_recsys_tpu_torch.data.collate import batches_from_sessions
    from chameleon_recsys_tpu_torch.data.sessions import read_sessions_tfrecord

    pattern = workdir / "bundle" / "sessions" / "sessions_hour_*.tfrecord.gz"
    negatives = workdir / "model" / "eval_sessions_negative_samples.json"
    check(negatives.is_file(), "neural cli: phase 6 wrote no eval negatives")
    flags = script_flags(GRU4REC_SCRIPT, {"--train_set_path_regex", "--output_csv",
                                          "--eval_sessions_negative_samples_json_path"})
    num_items = flags[flags.index("--num_items") + 1]
    common = ["--train_set_path_regex", str(pattern),
              "--eval_sessions_negative_samples_json_path", str(negatives)]
    runs = {"gru4rec": (run_gru4rec, flags), "sr-gnn": (run_sr_gnn, ["--num_items", num_items])}
    counts, models, expected_rows = collections.Counter(), {}, (G1_CLI_FILES - 1) // 5
    for name, (module, extra) in runs.items():
        label = f"neural cli {name}"
        csv_path = workdir / f"{name}_eval.csv"
        argv = common + extra + ["--output_csv", str(csv_path)]
        print(f"{label}: {module.__name__.rsplit('.', 1)[1]} {' '.join(extra)}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        memory_before = torch.cuda.max_memory_allocated()
        with timed_neural_runner(label) as (walls, record):
            zero_launch_counts()
            t0 = time.perf_counter()
            try:
                module.main(argv)
                rc = 0
            except SystemExit as exit_info:  # main exits only on an error
                rc = exit_info.code
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            run_counts = launch_counts()
        memory_peak = torch.cuda.max_memory_allocated()
        print(f"{label}: rc {rc}, {run_s:.3f} s wall; train hours (extra epochs included) "
              + ", ".join(f"{w:.3f}" for w in walls["train"]) + " s wall; eval hours "
              + ", ".join(f"{w:.3f}" for w in walls["eval"])
              + f" s wall, {statistics.mean(walls['eval'] or [0.0]):.3f} s an eval hour; "
              f"peak device memory {memory_peak / 2**30:.3f} GiB (before "
              f"{memory_before / 2**30:.3f}); kernel launches {run_counts}")
        check(rc in (0, None), f"{label}: {module.__name__} exited with {rc}")
        check(memory_peak > memory_before, f"{label}: the steps did not run on the card")
        check(not any(run_counts.values()), f"{label}: a kernel launched: {run_counts}")
        with open(csv_path) as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == expected_rows, f"{label}: {len(rows)} eval rows, expected "
              f"{expected_rows}")
        for i, row in enumerate(rows):
            check(f"hitrate_at_n_{name}" in row and f"mrr_at_n_{name}" in row,
                  f"{label}: eval row {i} lacks the model's columns")
            check(all(np.isfinite(float(v)) for v in row.values()),
                  f"{label}: eval row {i}: a column is not finite")
            print(f"{label} eval row {i}: eval_hour {row['eval_hour']}, hitrate_at_n "
                  f"{float(row[f'hitrate_at_n_{name}']):.4f}, mrr_at_n "
                  f"{float(row[f'mrr_at_n_{name}']):.4f}")
        counts.update(run_counts)
        models[name] = record["runner"]

    # a train batch of hour 0 at the CLI's batch and length, the GRU4Rec
    # runner's last buffer as the negatives' pool
    schema = run_gru4rec.minimal_session_schema(int(num_items))
    hour0 = read_sessions_tfrecord(sorted(pattern.parent.glob(pattern.name))[0], schema)
    batches = [(b["item_clicked"], b["label_next_item"])
               for b in batches_from_sessions(hour0, schema, 128, 20)]
    buffer_ids = models["gru4rec"]._buffer_ids()
    gru = models["gru4rec"].model
    n_params = sum(p.numel() for p in gru.params.parameters())
    state_bytes = sum(t.numel() * t.element_size() for s in gru.optimizer.state.values()
                      for t in s.values() if torch.is_tensor(t))
    items, labels = batches[0]
    gru.fit_batch(items, labels, buffer_ids)  # leaves the gradients for the update alone
    update_ms = cuda_ms(gru.optimizer.step, iters=10, warmup=2)
    update_bytes = 5 * 4 * n_params  # read p, g, acc; write p, acc
    print(f"neural cli gru4rec memory: {n_params} parameters, {n_params * 4 / 1e9:.3f} GB; "
          f"with their gradients and Adagrad's accumulator ({state_bytes / 1e9:.3f} GB) "
          f"{(2 * n_params * 4 + state_bytes) / 1e9:.3f} GB; the dense update (CUDA events "
          f"over 10) {update_ms:.3f} ms, {update_bytes / 1e9:.3f} GB at the least "
          f"(p, g, acc read, p, acc written), {update_bytes / update_ms / 1e9:.3f} TB/s of it")
    step_ms = {}
    for name, runner in models.items():
        step_ms[name] = cuda_ms(lambda: runner.model.fit_batch(items, labels, buffer_ids),
                                iters=10, warmup=2)
        print(f"neural cli {name} train step (batch {items.shape[0]}, CUDA events over 10 "
              f"steps): {step_ms[name]:.3f} ms")
    neural_cpu_vs_card(batches, buffer_ids, int(num_items))

    def profile_neural_steps():
        for name, runner in models.items():
            print_profile(f"neural cli {name} train step (batch {items.shape[0]})",
                          lambda: runner.model.fit_batch(items, labels, buffer_ids),
                          NEURAL_PROFILE_STEPS, step_ms[name])

    return dict(counts), profile_neural_steps


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


# ---------------------------------------------------------------------------
# 13-15: the native host code, grouped compaction and ACR in bf16
# ---------------------------------------------------------------------------


def native_build():
    """Builds both native libraries from the port's sources (``g++``, into
    the package's ``_build/``) and whether zlib's header is there; run in a
    thread beside the kernels' ``nvcc`` builds.  Returns (seconds by
    library, zlib header found, libraries loaded)."""
    from chameleon_recsys_tpu_torch.native import build as native_build_module
    from chameleon_recsys_tpu_torch.native import loader, sknn

    zlib_header = subprocess.run(["g++", "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
                                 capture_output=True, text=True, timeout=60).returncode == 0
    loaded = (sknn.native_available(), loader.native_available())
    errors = [e for e in (sknn.build_error(), loader.build_error()) if e]
    return dict(native_build_module.build_seconds), zlib_header, loaded, errors


def sknn_counts():
    from chameleon_recsys_tpu_torch.baselines import session_knn

    return session_knn.native_calls, session_knn.numpy_calls


def zero_sknn_counts():
    from chameleon_recsys_tpu_torch.baselines import session_knn

    session_knn.native_calls = session_knn.numpy_calls = 0


def native_phase(workdir, phase6_argv, phase6_rows):
    """(13) The native host code on the card's host, on phase 6's files:
    ``nar_trainer_gcom`` again over files 0-10 with ``--use_native_loader``,
    the launch and session-kNN counters zeroed just before and read just
    after.  Checks the run (``run_trainer_cli``: finite columns, the device
    HR equal to the host suite's), every baseline column bit-equal to phase
    6's (host-only and deterministic), the C++ predictor taken for every
    session-kNN predict (``native_calls`` > 0, ``numpy_calls`` 0), then each
    file's native batches array for array (dtypes too) against the Python
    reader and collation, and the session-kNN ``predict`` of eval hour 10's
    first batch, from its state then, natively and on the numpy row loop,
    bit-equal.  Prints the loader's and the Python reader's seconds per
    file, both predictors' walls, the benchmark tier's seconds and its share
    of eval hour 10.  Returns the kernel launches of the run (none)."""
    import copy
    import types

    import chameleon_recsys_tpu_torch.native as native
    from chameleon_recsys_tpu_torch.baselines.session_knn import SessionBasedKNNRecommender
    from chameleon_recsys_tpu_torch.cli import nar_trainer_gcom
    from chameleon_recsys_tpu_torch.data.collate import batches_from_sessions
    from chameleon_recsys_tpu_torch.data.sessions import read_sessions_tfrecord

    loaded = []  # (path, schema, epoch_ms, parse seconds, (batch size, max length))
    hours = {"index": 0, "pending": False, "snapshot": None,
             "predict_s": collections.defaultdict(float), "wall": {}, "phases": {}}
    loader_class, predict = native.NativeSessionLoader, SessionBasedKNNRecommender.predict
    harness_class = nar_trainer_gcom.TemporalHarness

    class RecordingLoader(loader_class):
        def __init__(self, path, schema, epoch_ms=0):
            t0 = time.perf_counter()
            super().__init__(path, schema, epoch_ms)
            loaded.append([path, schema, epoch_ms, time.perf_counter() - t0, None])

        def batches(self, batch_size, max_session_length):
            loaded[-1][4] = (batch_size, max_session_length)
            return super().batches(batch_size, max_session_length)

    def recording_predict(self, users_ids, sessions_items, topk=5, valid_items=None):
        if hours["pending"]:  # the first predict of an eval hour: its state
            hours["pending"] = False
            hours["snapshot"] = (self, copy.deepcopy(self._state()),
                                 np.array(sessions_items), np.array(valid_items), topk)
        t0 = time.perf_counter()
        try:
            return predict(self, users_ids, sessions_items, topk=topk, valid_items=valid_items)
        finally:
            hours["predict_s"][hours["index"]] += time.perf_counter() - t0

    class MarkingHarness(harness_class):
        def evaluate_hour(self, sessions):
            hours["index"] += 1
            hours["pending"] = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            row = super().evaluate_hour(sessions)
            torch.cuda.synchronize()
            hours["wall"][hours["index"]] = time.perf_counter() - t0
            hours["phases"][hours["index"]] = dict(self.last_eval_phase_seconds)
            return row

    model_dir = workdir / "model_native"
    argv = list(phase6_argv)
    argv[argv.index("--model_dir") + 1] = str(model_dir)
    argv[argv.index("--sync_artifacts_to") + 1] = "run_native"
    argv.append("--use_native_loader")
    native.NativeSessionLoader = RecordingLoader
    SessionBasedKNNRecommender.predict = recording_predict
    nar_trainer_gcom.TemporalHarness = MarkingHarness
    zero_sknn_counts()
    try:
        counts, rows = run_trainer_cli(nar_trainer_gcom, argv, "g1 cli native")
    finally:
        native.NativeSessionLoader = loader_class
        SessionBasedKNNRecommender.predict = predict
        nar_trainer_gcom.TemporalHarness = harness_class
    native_calls, numpy_calls = sknn_counts()
    print(f"g1 cli native: session-kNN predict calls native {native_calls}, numpy "
          f"{numpy_calls}; {len(loaded)} hour files through the C++ loader")
    check(native_calls > 0 and numpy_calls == 0,
          f"g1 cli native: the session-kNN ran {numpy_calls} predicts on numpy")
    check(len(rows) == len(phase6_rows), "g1 cli native: eval rows")
    baseline_columns = [c for c in phase6_rows[0] if c.endswith(G1_BASELINES)]
    check(len(baseline_columns) == 8 * len(G1_BASELINES), "g1 cli native: baseline columns")
    differ = [(i, c) for i, (a, b) in enumerate(zip(rows, phase6_rows))
              for c in baseline_columns if a[c] != b[c]]
    print(f"g1 cli native: {len(baseline_columns)} baseline columns x {len(rows)} rows "
          f"bit-equal to phase 6's: {not differ}")
    check(not differ, f"g1 cli native: baseline columns differ from phase 6's: {differ[:5]}")

    # each file's batches: the C++ loader against the Python reader
    native_s, python_s, checked = [], [], set()
    for path, schema, epoch_ms, _, shape in loaded:
        if path in checked:
            continue
        checked.add(path)
        check(shape is not None, f"native loader: {path} was never batched")
        t0 = time.perf_counter()
        source = loader_class(path, schema, epoch_ms)
        got = list(source.batches(*shape))
        source.close()
        native_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        sessions = read_sessions_tfrecord(path, schema, epoch_ms)
        want = list(batches_from_sessions(sessions, schema, *shape))
        python_s.append(time.perf_counter() - t0)
        check(len(got) == len(want), f"native loader: {path}: {len(got)} batches, "
              f"expected {len(want)}")
        for g, w in zip(got, want):
            check(sorted(g) == sorted(w), f"native loader: {path}: keys")
            for key in w:
                check(g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]),
                      f"native loader: {path}: {key} differs from the Python collation")
    print(f"native loader: {len(checked)} files at batch {shape[0]}, max length {shape[1]}: "
          "every batch array-equal to the Python reader's; seconds per file (read + "
          "collate) C++ " + ", ".join(f"{s:.4f}" for s in native_s) + "; Python "
          + ", ".join(f"{s:.4f}" for s in python_s) + f"; mean {np.mean(native_s):.4f} "
          f"against {np.mean(python_s):.4f} s ({np.mean(python_s) / np.mean(native_s):.1f}x)")

    # the session-kNN on eval hour 10's first batch, from its state then
    last = max(hours["wall"])
    clf, state, items, valid, topk = hours["snapshot"]
    clf.state_view = types.SimpleNamespace(benchmarks_states={clf.get_clf_suffix(): state})
    walls, preds = {}, {}
    for use_native in (True, False, True, False):
        clf.params["use_native"] = use_native
        t0 = time.perf_counter()
        preds[use_native] = clf.predict(None, items, topk=topk, valid_items=valid)
        walls.setdefault(use_native, []).append(time.perf_counter() - t0)
    clf.params["use_native"] = True
    same = np.array_equal(preds[True], preds[False])
    tier = hours["phases"][last]["benchmarks"]
    print(f"session-kNN predict on eval hour 10's first batch {list(items.shape)} (host "
          f"clock, two calls each): C++ {walls[True][0]:.4f}, {walls[True][1]:.4f} s; numpy "
          f"row loop {walls[False][0]:.4f}, {walls[False][1]:.4f} s "
          f"({min(walls[False]) / min(walls[True]):.1f}x); predictions bit-equal {same}")
    print(f"g1 cli native eval hour 10: {hours['wall'][last]:.3f} s wall, benchmark tier "
          f"{tier:.3f} s ({tier / hours['wall'][last]:.1%} of the hour), session-kNN "
          f"predict {hours['predict_s'][last]:.3f} s over the hour")
    check(same, "session-kNN: the C++ and numpy predictions differ")
    return counts


GROUPS = 4  # phase 14's train_compaction_groups: the data width of a 4-card mesh
GROUPED_TIMED_STEPS = 10


def grouped_phase(port, server, cfg, session_schema, article_schema, corpus, batches,
                  capacity):
    """(14) The G1 train step at phase 4's capacity with
    ``train_compaction_groups`` = ``GROUPS``, counted: two steps over phase
    4's batches (per step the stash forward and the backward of the fused
    scorer once, the UGRNN forward and backward twice each, as with one
    group), each step's ``dropped_clicks`` against the per-group overflow
    counted on the host, then ``LOSS_STEPS`` steps on one batch (the loss
    finite and falling); then the ms a step by CUDA events of the grouped
    step beside the one-group step from the same weights, in turns.
    Returns the launch counts of the counted run."""
    from chameleon_recsys_tpu_torch.state.stream_state import init_stream_state
    from chameleon_recsys_tpu_torch.train.steps import init_train_state, train_step

    b, t = cfg.batch_size, cfg.max_inputs_length
    warm = warm_stream(
        init_stream_state(cfg, corpus.num_items, device="cuda"),
        hour_batches(corpus, session_schema, cfg, 0, 2 * b)
        + hour_batches(corpus, session_schema, cfg, 1, 2 * b), cfg, "cuda")
    states = {}
    for groups in (1, GROUPS):
        gcfg = dataclasses.replace(cfg, train_valid_row_capacity=capacity,
                                   train_compaction_groups=groups)
        model = port.NARModel(gcfg, session_schema, article_schema,
                              corpus.ace_matrix.shape[1]).to("cuda")
        model.load_state_dict(server.model.state_dict())
        states[groups] = init_train_state(model, warm,
                                          torch.Generator(device="cuda").manual_seed(41))
    torch.cuda.synchronize()
    zero_launch_counts()
    state, per_step = states[GROUPS], []
    for i in range(TRAIN_STEPS):
        before = launch_counts()
        state, metrics = train_step(state, batches[i % len(batches)], server.ace_matrix,
                                    server.metadata)
        torch.cuda.synchronize()
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        values = {k: float(v) for k, v in metrics.items()}
        sizes = batches[i % len(batches)]["session_size"].cpu().numpy()
        valid = (np.arange(t)[None] < (sizes - 1)[:, None]).reshape(GROUPS, -1).sum(1)
        overflow = int(np.maximum(valid - capacity // GROUPS, 0).sum())
        print(f"grouped train step {i} ({GROUPS} groups of {capacity // GROUPS} rows; valid "
              f"clicks by group {valid.tolist()}): "
              + ", ".join(f"{k} {v:.6g}" for k, v in values.items()))
        check(all(np.isfinite(v) for v in values.values()),
              f"grouped train step {i}: a metric is not finite")
        check(values["dropped_clicks"] == overflow,
              f"grouped train step {i}: dropped {values['dropped_clicks']}, the groups' "
              f"overflow is {overflow}")
    counts = launch_counts()
    expected = {"cand_score_fwd": 0, "cand_score_fwd_stash": 1, "cand_score_bwd": 1,
                "cand_score_bwd_recompute": 0, **ugrnn_expected(cfg.rnn_num_layers,
                                                                cfg.rnn_num_layers)}
    print(f"grouped train path ({GROUPS} groups, capacity {capacity}): launches {counts}, "
          f"per step {per_step}")
    check(per_step == [expected] * TRAIN_STEPS,
          f"kernel launches per grouped train step {per_step}")
    losses = []
    for _ in range(LOSS_STEPS):
        state, metrics = train_step(state, batches[0], server.ace_matrix, server.metadata)
        losses.append(float(metrics["loss"]))
    print(f"grouped: loss over {LOSS_STEPS} steps on one batch: {losses[0]:.6f} -> "
          f"{losses[-1]:.6f} (min {min(losses):.6f})")
    check(all(np.isfinite(losses)), "grouped: a loss is not finite")
    check(losses[-1] < losses[0], "grouped: the loss does not fall on one batch")
    states[GROUPS] = state

    def step(groups):
        states[groups], _ = train_step(states[groups], batches[0], server.ace_matrix,
                                       server.metadata)

    times = {1: [], GROUPS: []}
    for groups in (1, GROUPS, GROUPS, 1):
        times[groups].append(cuda_ms(lambda: step(groups), iters=GROUPED_TIMED_STEPS,
                                     warmup=2))
    print(f"train_step b{b} capacity {capacity} (CUDA events over {GROUPED_TIMED_STEPS} "
          f"steps, in turns): {GROUPS} groups " + ", ".join(f"{ms:.3f}" for ms in
                                                           times[GROUPS])
          + " ms, one group " + ", ".join(f"{ms:.3f}" for ms in times[1]) + " ms")
    del states
    return counts


ACR_BF16_STEPS = 20  # on the same batches in each dtype: 2 batches x 10 epochs
# the bf16 ACE's distance from the f32 ACE, normwise: tests/test_torch_acr_bf16.py's
# bound for activations (ACT_TOL), about ten bf16 roundings
ACR_BF16_TOL = 2e-2
# the bf16 task losses on the card against the CPU's, relative, over the
# first ACR_BF16_LOSS_STEPS steps: that file's LOSS_TOL for its three steps
# (f32 sums over the batch, in which the roundings average out).  Past them
# the two runs' parameters have parted, and each loss is held at the
# activations' bound ACR_BF16_TOL, as the ACE after the steps is.
ACR_BF16_LOSS_TOL = 1e-3
ACR_BF16_LOSS_STEPS = 3


def acr_bf16_phase():
    """(15) ACR in bf16 at the published widths on the card: phase 7's CNN
    classifier (ACE 250, batch 8, 300 tokens, 100-dim words) and phase 10's
    GRU autoencoder (GRU 512, 30 tokens, batch 32, 300-dim words, noise
    0.05), ``ACR_BF16_STEPS`` steps each in bf16 and in f32 from the same
    weights, batches and draws (random words and labels from a seed), and
    the same steps in both dtypes on the CPU.  Checks that the losses are
    finite and fall, that the bf16 ACE lies within ``ACR_BF16_TOL`` of the
    f32 ACE at the initial weights (the CPU tests' bound, set for a forward
    and three steps), and that the card's bf16 run lies within the CPU
    tests' bounds of the CPU's bf16 run: the ACE at the initial weights and
    after the steps within ``ACR_BF16_TOL``, the first
    ``ACR_BF16_LOSS_STEPS`` task losses within ``ACR_BF16_LOSS_TOL`` and
    every later one within ``ACR_BF16_TOL``.  Prints the bf16 ACE's distance from the f32 ACE
    after the steps on the card and on the CPU, and the ms a step by CUDA
    events.  Returns the launch
    counts (none) and a function that profiles one step of each (the busy
    share), run by ``main`` after its other profiles."""
    from chameleon_recsys_tpu_torch.acr.trainer import ACRTrainer
    from chameleon_recsys_tpu_torch.config import ACRConfig
    from chameleon_recsys_tpu_torch.models.acr import ACRLabelSpec

    class RecordingTrainer(ACRTrainer):
        def train_step(self, batch, weights):
            loss, task_loss = super().train_step(batch, weights)
            self.task_losses.append(task_loss)
            return loss, task_loss

    def corpus(n, length, vocab, dim, seed):
        rng = np.random.RandomState(seed)
        words = (rng.randn(vocab, dim) * 0.3).astype(np.float32)
        lengths = rng.randint(length // 2, length + 1, n)
        text = np.where(np.arange(length)[None] < lengths[:, None],
                        rng.randint(2, vocab, (n, length)), 0).astype(np.int32)
        articles = {"article_id": np.arange(1, n + 1), "text": text,
                    "text_length": lengths.astype(np.int32),
                    "category0": rng.randint(1, 80, n),
                    "keywords": rng.randint(0, 500, (n, 4))}
        return words, articles, {"category0": (rng.rand(80) + 0.5).astype(np.float32)}

    cases = {
        "cnn classifier": (dict(text_feature_extractor="CNN", batch_size=8,
                                truncate_tokens_length=300, learning_rate=3e-4,
                                l2_reg_lambda=1e-5, word_embedding_size=100),
                           (ACRLabelSpec("category0", 80, "multiclass"),
                            ACRLabelSpec("keywords", 500, "multilabel")), 16, 300, 100),
        "gru autoencoder": (dict(training_task="autoencoder", text_feature_extractor="GRU",
                                 autoencoder_noise=0.05, batch_size=32,
                                 truncate_tokens_length=30, learning_rate=1e-4,
                                 l2_reg_lambda=7e-4, rnn_units=512, word_embedding_size=300),
                            (), 64, 30, 300),
    }
    zero_launch_counts()
    profiles = []
    for name, (fields, specs, n, length, dim) in cases.items():
        words, articles, class_weights = corpus(n, length, 20000, dim, seed=15)
        if not specs:
            articles = {k: articles[k] for k in ("article_id", "text", "text_length")}
            class_weights = None
        runs = {}
        for dtype, device in (("float32", "cuda"), ("bfloat16", "cuda"),
                              ("bfloat16", "cpu"), ("float32", "cpu")):
            cfg = ACRConfig(acr_embeddings_size=250, vocab_size=20000, compute_dtype=dtype,
                            training_epochs=ACR_BF16_STEPS * fields["batch_size"] // n,
                            **fields)
            trainer = RecordingTrainer(cfg, words, specs, class_weights, device=device)
            trainer.task_losses = []
            ace0 = trainer.predict_all_ace(articles)
            trainer.fit(articles)
            losses = torch.stack(trainer.task_losses).cpu().numpy()
            ace = trainer.predict_all_ace(articles)
            runs[dtype, device] = (ace0, losses, ace)
            check(len(losses) == ACR_BF16_STEPS and np.isfinite(losses).all(),
                  f"acr {dtype} {name} on {device}: step losses")
            check(ace.dtype == np.float32 and np.isfinite(ace).all(),
                  f"acr {dtype} {name} on {device}: ACE")
            if device == "cpu":
                continue
            batch = {k: torch.as_tensor(v[: cfg.batch_size], device="cuda")
                     for k, v in articles.items()}
            weights = torch.ones(cfg.batch_size, device="cuda")
            ms = cuda_ms(lambda: trainer.train_step(batch, weights), iters=20, warmup=3)
            runs[dtype, "ms"] = ms
            profiles.append((f"acr {dtype} {name} train step (batch {cfg.batch_size})",
                             lambda t=trainer, b=batch, w=weights: t.train_step(b, w), ms))
            print(f"acr {dtype} {name}: {len(losses)} steps, task loss first / last 5 "
                  f"{losses[:5].mean():.5f} / {losses[-5:].mean():.5f}; {ms:.3f} ms a step "
                  f"(CUDA events over 20 steps)")
            check(losses[-5:].mean() < losses[:5].mean(), f"acr {dtype} {name}: the loss "
                  "does not fall")

        def ace_gap(a, b, i):
            return float(np.linalg.norm(runs[a][i] - runs[b][i]) / np.linalg.norm(runs[b][i]))

        card16, card32 = ("bfloat16", "cuda"), ("float32", "cuda")
        cpu16, cpu32 = ("bfloat16", "cpu"), ("float32", "cpu")
        gaps = [ace_gap(card16, card32, i) for i in (0, 2)]
        cpu_gap = ace_gap(cpu16, cpu32, 2)
        card_cpu = [ace_gap(card16, cpu16, i) for i in (0, 2)]
        loss_err = np.abs(runs[card16][1] - runs[cpu16][1]) / np.abs(runs[cpu16][1])
        print(f"acr bf16 {name}: ACE distance from f32 (normwise) at the initial weights "
              f"{gaps[0]:.3e}, after {ACR_BF16_STEPS} steps {gaps[1]:.3e} on the card and "
              f"{cpu_gap:.3e} on the CPU (bound {ACR_BF16_TOL} at the initial weights); "
              f"ms a step bf16 {runs['bfloat16', 'ms']:.3f} against f32 "
              f"{runs['float32', 'ms']:.3f}")
        print(f"acr bf16 {name} card vs cpu: ACE distance at the initial weights "
              f"{card_cpu[0]:.3e}, after {ACR_BF16_STEPS} steps {card_cpu[1]:.3e} (bound "
              f"{ACR_BF16_TOL}); task losses' relative difference, max over the first "
              f"{ACR_BF16_LOSS_STEPS} steps {loss_err[:ACR_BF16_LOSS_STEPS].max():.3e} (bound "
              f"{ACR_BF16_LOSS_TOL}), over all {loss_err.max():.3e} (bound {ACR_BF16_TOL}), "
              "per step " + " ".join(f"{e:.1e}" for e in loss_err))
        check(gaps[0] <= ACR_BF16_TOL, f"acr bf16 {name}: the ACE lies {gaps[0]} from f32")
        check(max(card_cpu) <= ACR_BF16_TOL,
              f"acr bf16 {name}: the card's ACE lies {card_cpu} from the CPU's")
        check(loss_err[:ACR_BF16_LOSS_STEPS].max() <= ACR_BF16_LOSS_TOL
              and loss_err.max() <= ACR_BF16_TOL,
              f"acr bf16 {name}: the card's losses lie {loss_err} from the CPU's")
    counts = launch_counts()
    check(not any(counts.values()), f"acr bf16: a kernel launched: {counts}")

    def profile_acr_bf16():
        for label, fn, ms in profiles:
            print_profile(label, fn, ACR_PROFILE_STEPS, ms)

    return counts, profile_acr_bf16


# ---------------------------------------------------------------------------
# 16: multi-GPU on one card
# ---------------------------------------------------------------------------

# scripts/g1_mesh_parity.py's G1 width: an even catalog, so that at model
# parallelism 2 the item embedding and the ACE matrix shard into 23,017 rows a
# rank (bench.py's 46,033 is odd: the rule would replicate them), its grouped
# capacity, batch 256, bf16, both kernels on, phase 4's weights (seed 0)
MESH_ITEMS = 46_034
MESH_CAPACITY = 2688
MESH_TRAIN_STEPS = 2
MESH_TIMED_STEPS = 5
# (name, data parallelism, model parallelism, backend): NCCL refuses two ranks
# on one device, so the two-rank worlds run over gloo
MESH_WORLDS = (("1x1", 1, 1, "nccl"), ("2x1", 2, 1, "gloo"), ("1x2", 1, 2, "gloo"))
# each world against the one-device steps (train_compaction_groups = its data
# parallelism) on the same global batches, weights and draws.  At 1 x 1 they
# are the same computation: the eval exactly, the losses within phase 5's
# RESUME_TOL (the embeddings' backward adds with float atomics).  With two
# ranks the bf16 products at B / 2 rows round otherwise than at B rows
# (cuBLAS picks its algorithm by row count): the losses within 1e-3
# relative; the eval's probabilities within 2e-2 (tests/test_torch_cuda.py's
# bf16 bound; at random weights the candidates' scores lie within bf16's
# resolution of each other, so near ties reorder and HR moves by a few
# clicks: printed).  Adam's moments are held in float32 after the first step,
# as the CPU tests hold them (tests/test_torch_parallel_step.py): the
# two-rank world's first train step, and the one-device grouped step, run
# again from the same weights in float32, the loss within 1e-5 relative,
# every element of the moments within the CPU tests' 1e-4, and each
# parameter's moments within 1e-3 of its own normwise.  That relative bound
# is set from the first reading of this run (1.2e-4 to 3.2e-4 in every
# parameter below the output layer, the output kernel 7e-6, the loss
# bit-equal): at random weights a row's candidates look alike, so the
# gradients below the output layer are sums over candidates whose (p - y)
# factors sum to 0, and the ranks' partial sums over half the rows round
# them apart by ~1e-4; a gradient a few percent off would lie 10x past it.
# (After a second step every parameter differs by ~2e-3: Adam's first
# update is ~lr * sign(g), so an element whose gradient is 0 up to rounding
# moves by +-lr on one side and not the other.)  Left out of the relative
# bound, and printed: a parameter whose gradient is 0 but for rounding, its
# first moment under MESH_NOISE_LEAF of the median parameter's (the output
# bias: each row's candidate gradients sum to 0).  In bf16 each rank rounds
# its own partial sums, so the bf16 moments' distances are printed only.
# The integer stream state exactly, in every world.
MESH_TOL = {"loss": 1e-3, "probs": 2e-2, "moments_f32": 1e-4, "moments_f32_rel": 1e-3,
            "loss_f32": 1e-5}
MESH_NOISE_LEAF = 1e-3
MESH_TIMEOUT = 300  # seconds a world may take, its processes' start included


def mesh_rank(rank, dp, mp, backend, port_number, workdir, queue):
    """(16) One rank of a phase-16 world; puts (rank, its results) on
    ``queue``, or (rank, the traceback)."""
    try:
        queue.put((rank, _mesh_rank(rank, dp, mp, backend, port_number, workdir)))
    except BaseException:
        import traceback

        queue.put((rank, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _mesh_rank(rank, dp, mp, backend, port_number, workdir):
    """The sharded eval step from the initial weights, then
    ``MESH_TRAIN_STEPS`` sharded train steps, counted (kernels and
    collectives per step); the stream, the gathered Adam moments and a
    digest of each of the rank's parameters; with a model axis the state
    through the directory checkpoint in ``workdir`` and the pickle payload
    (``mesh_checkpoint``); the ms a train step by CUDA events; on rank 0 the
    one-device steps on the global batches and the comparison with them."""
    import copy
    import hashlib

    import chameleon_recsys_tpu_torch as port
    from chameleon_recsys_tpu_torch.data.synthetic import make_synthetic_corpus
    from chameleon_recsys_tpu_torch.parallel import distributed
    from chameleon_recsys_tpu_torch.parallel.mesh import make_mesh
    from chameleon_recsys_tpu_torch.parallel.sharded import put_batch, shard_nar_programs
    from chameleon_recsys_tpu_torch.state.stream_state import init_stream_state
    from chameleon_recsys_tpu_torch.train.steps import eval_step, init_train_state, train_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize_multihost(f"localhost:{port_number}", dp * mp, rank,
                                     backend=backend)
    plan = make_mesh(dp, mp, device="cuda:0")
    base, sess, art = g1_setup(port, MESH_ITEMS)
    cfg = dataclasses.replace(base, train_valid_row_capacity=MESH_CAPACITY,
                              train_compaction_groups=dp)
    corpus = make_synthetic_corpus(art, ace_dim=250)
    b = cfg.batch_size
    warm = warm_stream(init_stream_state(cfg, MESH_ITEMS, device="cuda"),
                       hour_batches(corpus, sess, cfg, 0, 2 * b)
                       + hour_batches(corpus, sess, cfg, 1, 2 * b), cfg, "cuda")
    batches = hour_batches(corpus, sess, cfg, 3, MESH_TRAIN_STEPS * b)
    eval_batch = hour_batches(corpus, sess, cfg, 4, b)[0]
    ace_full = torch.from_numpy(corpus.ace_matrix).cuda()
    metadata = {k: torch.as_tensor(np.asarray(v, np.float32 if np.asarray(v).dtype.kind == "f"
                                              else np.int64)).cuda()
                for k, v in corpus.metadata.items()}
    model = port.NARModel(cfg, sess, art, 250)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.cuda()

    def float32_copy():
        copy32 = port.NARModel(dataclasses.replace(cfg, compute_dtype="float32"), sess, art,
                               250)
        copy32.load_state_dict(model.state_dict())
        return copy32.cuda()

    # the same weights in float32 for the two-rank worlds' float32 steps;
    # on rank 0 the one-device steps' models
    model32 = float32_copy() if dp * mp > 1 else None
    references = (copy.deepcopy(model), float32_copy()) if rank == 0 else None
    programs = shard_nar_programs(plan, model, corpus.ace_matrix)
    ace = programs.local_ace(ace_full)
    state = init_train_state(model, warm, torch.Generator(device="cuda").manual_seed(41))
    torch.cuda.synchronize()
    zero_launch_counts()
    distributed.reset_counts()
    out = {"launches": [], "collectives": [], "losses": [],
           "sharded": sorted(n for n, s in programs.state_sharding.items() if s),
           "ace_rows": None if programs.ace_sharding is None else list(programs.ace_sharding)}

    def counted(fn):
        before, sent = launch_counts(), distributed.snapshot_counts()
        result = fn()
        torch.cuda.synchronize()
        after, now = launch_counts(), distributed.snapshot_counts()
        out["launches"].append({k: after[k] - before[k] for k in after})
        out["collectives"].append({k: {f: now[k][f] - sent[k][f] for f in ("calls", "bytes")}
                                   for k in now})
        return result

    _, eval_metrics, fetches = counted(lambda: programs.eval_step(
        model, warm, put_batch(programs, eval_batch), ace, metadata,
        generator=torch.Generator(device="cuda").manual_seed(42)))
    out["eval"] = {k: float(v) for k, v in eval_metrics.items()}
    for batch in batches:
        state, metrics = counted(lambda: programs.train_step(
            state, put_batch(programs, batch), ace, metadata))
        out["losses"].append({k: float(v) for k, v in metrics.items()})
    out["totals"] = launch_counts()
    out["stream"] = {k: v.cpu().numpy() for k, v in state.stream._asdict().items()}
    params = dict(state.model.named_parameters())
    # copies: the timed steps below go on updating Adam's state in place
    moments = {key: programs.full_tensors({n: state.optimizer.state[p][key].clone()
                                           for n, p in params.items()})
               for key in ("exp_avg", "exp_avg_sq")}
    out["digests"] = {n: hashlib.sha1(p.detach().cpu().numpy().tobytes()).hexdigest()
                      for n, p in params.items()}
    if mp > 1:
        def fresh():
            m = port.NARModel(cfg, sess, art, 250)
            m.reset_parameters(torch.Generator().manual_seed(99))
            shard = shard_nar_programs(plan, m.cuda(), corpus.ace_matrix)
            return init_train_state(m, warm, torch.Generator(device="cuda").manual_seed(0)), shard

        out["checkpoint"] = mesh_checkpoint(plan, state, programs, fresh, batches[0], ace,
                                            metadata, f"{workdir}/dcp_{dp}x{mp}")
    holder = [state]

    def step():
        holder[0], _ = programs.train_step(holder[0], put_batch(programs, batches[0]), ace,
                                           metadata)

    out["ms"] = cuda_ms(step, iters=MESH_TIMED_STEPS, warmup=1)
    sharded32 = None
    if model32 is not None:
        # the first sharded train step in float32 (uncounted: a comparison)
        programs32 = shard_nar_programs(plan, model32, corpus.ace_matrix)
        state32 = init_train_state(model32, warm, torch.Generator(device="cuda").manual_seed(41))
        state32, metrics = programs32.train_step(state32, put_batch(programs32, batches[0]),
                                                 ace, metadata)
        params32 = dict(state32.model.named_parameters())
        sharded32 = float(metrics["loss"]), {
            key: programs32.full_tensors({n: state32.optimizer.state[p][key]
                                          for n, p in params32.items()})
            for key in ("exp_avg", "exp_avg_sq")}
    if rank == 0:
        out["compared"] = _mesh_reference(*references, warm, batches, eval_batch, ace_full,
                                          metadata, out, fetches, moments, sharded32, dp,
                                          eval_step, init_train_state, train_step)
    return out


def _moment_distance(moments, state):
    """Normwise distance of ``moments`` ({"exp_avg", "exp_avg_sq"}: {name:
    tensor}) from ``state``'s Adam moments, over all the parameters at once
    (a parameter whose gradient is 0 but for rounding noise, as the
    matching output's bias, has no relative error of its own), the larger
    of the two moments; and the parameter that differs most."""
    worst, distance = ("", 0.0), 0.0
    for key in ("exp_avg", "exp_avg_sq"):
        diff = ref = 0.0
        for n, p in state.model.named_parameters():
            expected = state.optimizer.state[p][key].float()
            d = float((moments[key][n].float() - expected).square().sum())
            diff += d
            ref += float(expected.square().sum())
            if d > worst[1]:
                worst = (f"{key} {n}", d)
        distance = max(distance, (diff / ref) ** 0.5)
    return distance, worst[0]


def _adam_moments(state, clone=False):
    """{"exp_avg", "exp_avg_sq"}: {parameter name: ``state``'s moment}."""
    return {key: {n: state.optimizer.state[p][key].clone() if clone
                  else state.optimizer.state[p][key]
                  for n, p in state.model.named_parameters()}
            for key in ("exp_avg", "exp_avg_sq")}


def _leaf_distances(moments, reference):
    """{parameter: (the normwise distance of ``moments`` from ``reference``
    (both as ``_adam_moments`` gives them) relative to the latter's norm,
    the larger of the two moments; the largest difference of any
    element)}."""
    out = {}
    for n in reference["exp_avg"]:
        rel = largest = 0.0
        for key in ("exp_avg", "exp_avg_sq"):
            expected = reference[key][n].float()
            delta = moments[key][n].float() - expected
            norm, ref = float(delta.norm()), float(expected.norm())
            rel = max(rel, norm / ref if ref else (math.inf if norm else 0.0))
            largest = max(largest, float(delta.abs().max()))
        out[n] = (rel, largest)
    return out


def _mesh_reference(model, model32, warm, batches, eval_batch, ace, metadata, out, fetches,
                    moments, sharded32, dp, eval_step, init_train_state, train_step):
    """The one-device eval and train steps on the global batches from the
    same weights, stream and generator seeds (``model``; ``model32`` the
    same weights in float32, for the train steps), held against rank 0's
    sharded ones: the losses' relative differences, the eval's sorted
    probabilities on the rank's rows (largest difference), its HR and MRR
    and the share of the rank's top-10 lists the same, Adam's moments
    normwise from the one-device bf16 run's and the bf16 run's from the
    f32 run's, the stream's integer fields; with ``sharded32`` (the sharded
    float32 steps' losses and gathered moments) those against the
    one-device float32 steps'."""
    top = model.cfg.metrics_top_n
    _, ref_eval, ref_fetches = eval_step(
        model, warm, to_device(eval_batch, "cuda"), ace, metadata,
        generator=torch.Generator(device="cuda").manual_seed(42))
    ref_eval = {k: float(v) for k, v in ref_eval.items()}
    rows = eval_batch["item_clicked"].shape[0] // dp
    valid = fetches["labels"] != 0
    mine, theirs = fetches["predicted_ids"][..., :top], ref_fetches["predicted_ids"][:rows, ..., :top]
    lists = float((mine == theirs).all(-1)[valid].float().mean())
    probs = float((fetches["predicted_probs"] - ref_fetches["predicted_probs"][:rows])
                  .abs()[valid].max())
    runs = {}
    for name, m in (("bf16", model), ("f32", model32)):
        state = init_train_state(m, warm, torch.Generator(device="cuda").manual_seed(41))
        losses = []
        for batch in batches:
            state, metrics = train_step(state, to_device(batch, "cuda"), ace, metadata)
            losses.append({k: float(v) for k, v in metrics.items()})
            if name == "f32" and len(losses) == 1:
                first32 = _adam_moments(state, clone=True)
        runs[name] = state, losses
    state, losses = runs["bf16"]
    moment_err, worst = _moment_distance(moments, state)
    bf16_moments = _adam_moments(state)
    bf16_err, _ = _moment_distance(bf16_moments, runs["f32"][0])
    mesh_err, _ = _moment_distance(moments, runs["f32"][0])
    f32 = None
    if sharded32 is not None:
        loss32, moments32 = sharded32
        reference = runs["f32"][1][0]["loss"]
        f32 = {"leaves": _leaf_distances(moments32, first32),
               "norms": {n: float(m.norm()) for n, m in first32["exp_avg"].items()},
               "loss": abs(loss32 - reference) / abs(reference)}
    ints = ("buffer_ids", "buffer_ts", "recent_pop", "global_pop", "current_step")
    stream = {k: v.cpu().numpy() for k, v in state.stream._asdict().items()}
    return {
        "loss": max(abs(a[k] - r[k]) / abs(r[k]) for a, r in zip(out["losses"], losses)
                    for k in ("loss", "ce_loss")),
        "counts": all(a[k] == r[k] for a, r in zip(out["losses"], losses)
                      for k in ("sessions", "clicks", "dropped_clicks")),
        "hr": abs(out["eval"]["hit_sum"] - ref_eval["hit_sum"]) / ref_eval["label_count"],
        "mrr": abs(out["eval"]["rr_sum"] - ref_eval["rr_sum"]) / ref_eval["label_count"],
        "eval_counts": all(out["eval"][k] == ref_eval[k]
                           for k in ("label_count", "clicks", "sessions")),
        "eval_exact": out["eval"] == ref_eval,
        "probs": probs,
        "lists": lists,
        "moments": moment_err,
        "moments_worst": worst,
        "bf16_moments": bf16_err,
        "mesh_moments": mesh_err,
        "stream": all(np.array_equal(out["stream"][k], stream[k]) for k in ints),
        "ref_losses": [r["loss"] for r in losses],
        "f32": f32,
    }


def mesh_phase():
    """(16) Multi-GPU on the one card: three worlds of spawned ranks through
    the sharded programs (``parallel/sharded.py``) at the G1 width of
    ``scripts/g1_mesh_parity.py``: 1 x 1 over NCCL, 2 x 1 and 1 x 2 (the
    tables row-sharded) over gloo, two ranks on the card.  In each the
    sharded eval step and ``MESH_TRAIN_STEPS`` train steps, counted, held
    against the one-device steps (``MESH_TOL``); replicated parameters
    bit-equal across the ranks; the collectives and the ms a train step by
    CUDA events printed.  Returns the kernels' launches summed over every
    rank's counted steps."""
    import gc
    import socket

    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"mesh: the parent's device memory before spawning: allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    eval_expected = {"cand_score_fwd": 1, "cand_score_fwd_stash": 0, "cand_score_bwd": 0,
                     "cand_score_bwd_recompute": 0, **ugrnn_expected(2, 0)}
    train_expected = {"cand_score_fwd": 0, "cand_score_fwd_stash": 1, "cand_score_bwd": 1,
                      "cand_score_bwd_recompute": 0, **ugrnn_expected(2, 2)}
    totals = collections.Counter()
    ctx = mp.get_context("spawn")
    workdir = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_")
    for name, dp, mpar, backend in MESH_WORLDS:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port_number = sock.getsockname()[1]
        queue = ctx.Queue()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, dp, mpar, backend, port_number, workdir, queue))
                 for r in range(dp * mpar)]
        for p in procs:
            p.start()
        try:
            results = dict(queue.get(timeout=MESH_TIMEOUT) for _ in procs)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        wall = time.perf_counter() - t0
        failed = {r: res for r, res in results.items() if isinstance(res, str)}
        check(not failed, f"mesh {name}: a rank failed:\n" + "\n".join(failed.values()))
        first = results[0]
        for rank, res in sorted(results.items()):
            check(res["launches"] == [eval_expected] + [train_expected] * MESH_TRAIN_STEPS,
                  f"mesh {name} rank {rank}: kernel launches per step {res['launches']}")
            totals.update(res["totals"])
            check(res["losses"] == first["losses"] and res["eval"] == first["eval"],
                  f"mesh {name} rank {rank}: the global metrics differ from rank 0's")
            check(all(np.array_equal(res["stream"][k], v) for k, v in first["stream"].items()),
                  f"mesh {name} rank {rank}: the stream differs from rank 0's")
            same = [n for n, d in res["digests"].items() if n not in first["sharded"]
                    and d == first["digests"][n]]
            check(len(same) == len(first["digests"]) - len(first["sharded"]),
                  f"mesh {name} rank {rank}: replicated parameters differ from rank 0's")
        cmp = first["compared"]
        train_collectives = first["collectives"][1]
        print(f"mesh {name} over {backend} ({dp * mpar} ranks, {wall:.1f} s wall with the "
              f"ranks' start): row-sharded {first['sharded'] or 'nothing'}, ACE rows "
              f"{first['ace_rows'] or 'whole'}; per rank and step launches eval "
              f"{ {k: v for k, v in first['launches'][0].items() if v} }, train "
              f"{ {k: v for k, v in first['launches'][1].items() if v} }")
        print(f"mesh {name} collectives per train step (rank 0): "
              + ", ".join(f"{k} {v['calls']} calls {v['bytes']} bytes"
                          for k, v in train_collectives.items())
              + "; per eval step: " + ", ".join(f"{k} {v['calls']} calls {v['bytes']} bytes"
                                                 for k, v in first["collectives"][0].items()))
        print(f"mesh {name} against the one-device steps (groups {dp}): losses "
              f"{[round(x['loss'], 6) for x in first['losses']]} vs "
              f"{[round(x, 6) for x in cmp['ref_losses']]} (max relative difference "
              f"{cmp['loss']:.2e}); eval bit-equal {cmp['eval_exact']}, probabilities max "
              f"difference {cmp['probs']:.2e}, HR difference {cmp['hr']:.2e}, MRR "
              f"{cmp['mrr']:.2e}, rank 0's top-10 lists the same {cmp['lists']:.4f}; Adam's "
              f"moments normwise {cmp['moments']:.2e} from the one-device run's (most in "
              f"{cmp['moments_worst']}); from the f32 steps' {cmp['mesh_moments']:.2e} "
              f"against the one-device bf16 run's {cmp['bf16_moments']:.2e}; integer stream "
              f"equal {cmp['stream']}; replicated parameters bit-equal on all {dp * mpar} "
              "ranks True")
        ms = ", ".join(f"{res['ms']:.3f}" for _, res in sorted(results.items()))
        print(f"mesh {name}: train step {ms} ms by CUDA events over {MESH_TIMED_STEPS} "
              "steps, rank by rank (the ranks share one card: no measure of scaling)")
        check(cmp["stream"] and cmp["counts"] and cmp["eval_counts"],
              f"mesh {name}: the stream or the counts differ from the one-device steps")
        if dp * mpar == 1:
            check(cmp["eval_exact"] and cmp["loss"] <= RESUME_TOL["loss"],
                  f"mesh {name}: the sharded steps differ from the one-device steps {cmp}")
        else:
            f32 = cmp["f32"]
            median = statistics.median(f32["norms"].values())
            noise = sorted(n for n, norm in f32["norms"].items()
                           if norm < MESH_NOISE_LEAF * median)
            held = {n: v for n, v in f32["leaves"].items() if n not in noise}
            worst32 = max(held, key=lambda n: held[n][0])
            f32.update(moments=held[worst32][0], moments_worst=worst32,
                       moments_max_abs=max(absd for _, absd in f32["leaves"].values()),
                       held=len(held), noise={n: f32["leaves"][n] for n in noise})
            noise = ", ".join(f"{n} {rel:.3e} ({absd:.3e})"
                              for n, (rel, absd) in f32["noise"].items())
            print(f"mesh {name} in float32, the first train step against the one-device "
                  f"float32 step (groups {dp}): Adam's moments over {f32['held']} parameters "
                  f"at most {f32['moments']:.3e} normwise relative (in "
                  f"{f32['moments_worst']}), the largest element difference "
                  f"{f32['moments_max_abs']:.3e}; the loss's relative difference "
                  f"{f32['loss']:.3e}; left out as rounding noise (relative, largest "
                  f"element): {noise or 'none'}")
            check(cmp["loss"] <= MESH_TOL["loss"] and cmp["probs"] <= MESH_TOL["probs"],
                  f"mesh {name}: the sharded steps lie off the one-device steps {cmp}")
            check(f32["moments"] <= MESH_TOL["moments_f32_rel"]
                  and f32["moments_max_abs"] <= MESH_TOL["moments_f32"]
                  and f32["loss"] <= MESH_TOL["loss_f32"],
                  f"mesh {name}: the float32 sharded steps lie off the one-device ones {f32}")
        if mpar > 1:
            check("item_clicked_embedding.weight" in first["sharded"]
                  and first["ace_rows"] == [0, MESH_ITEMS // 2, MESH_ITEMS],
                  f"mesh {name}: the tables are not row-sharded")
            report_mesh_checkpoint(name, results)
    shutil.rmtree(workdir)
    totals.update(mesh_dryrun())
    return dict(totals)


def mesh_checkpoint(plan, state, programs, fresh, batch, ace, metadata, path):
    """(16) The rank's train state through the directory checkpoint (every
    rank writes its rows) and through the pickle's payload (gathered, each
    rank keeping its rows), each loaded into a fresh sharded state
    (``fresh()``), which then takes one more train step on ``batch``: the
    loaded parameters against the rank's, the two steps' losses and
    parameters against each other; on rank 0 the directory's metadata:
    each chunk of the item table with its rows and file, and each rank's
    file size."""
    from chameleon_recsys_tpu_torch.parallel.distributed import barrier
    from chameleon_recsys_tpu_torch.parallel.sharded import put_batch
    from chameleon_recsys_tpu_torch.train.checkpoint import (
        load_train_state_dcp,
        pack_train_state,
        save_train_state_dcp,
        unpack_train_state,
    )

    t0 = time.perf_counter()
    save_train_state_dcp(path, state, programs)
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    payload = pack_train_state(state, programs)
    by_dcp, dcp_programs = fresh()
    t0 = time.perf_counter()
    by_dcp = load_train_state_dcp(path, by_dcp, dcp_programs)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    by_pickle, pickle_programs = fresh()
    by_pickle = unpack_train_state(payload, by_pickle, pickle_programs)
    del payload
    same = all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                                  by_dcp.model.parameters()))
    same = same and all(torch.equal(state.optimizer.state[p][k], by_dcp.optimizer.state[q][k])
                        for p, q in zip(state.model.parameters(), by_dcp.model.parameters())
                        for k in ("exp_avg", "exp_avg_sq"))
    losses = []
    for resumed, shard in ((by_dcp, dcp_programs), (by_pickle, pickle_programs)):
        resumed, metrics = shard.train_step(resumed, put_batch(shard, batch), ace, metadata)
        losses.append(float(metrics["loss"]))
    param = max((p - q).abs().max().item() for p, q in zip(by_dcp.model.parameters(),
                                                           by_pickle.model.parameters()))
    out = {"bit_equal": same, "losses": losses, "param": param, "save_s": save_s,
           "load_s": load_s}
    barrier(plan)
    if plan.rank == 0:
        import torch.distributed.checkpoint as dcp

        written = dcp.FileSystemReader(path).read_metadata()
        key = "model.item_clicked_embedding.weight"
        table = written.state_dict_metadata[key]
        out["chunks"] = sorted(
            (list(index.offset), next(list(c.sizes) for c in table.chunks
                                      if c.offsets == index.offset), info.relative_path)
            for index, info in written.storage_data.items() if index.fqn == key)
        out["table"] = list(table.size)
        out["files"] = {f.name: f.stat().st_size for f in Path(path).iterdir()}
        # the bytes each file holds of the table and of its Adam moments
        out["table_bytes"] = {}
        keys = {key} | {f"adam.item_clicked_embedding.weight.{k}"
                         for k in ("exp_avg", "exp_avg_sq")}
        for index, info in written.storage_data.items():
            if index.fqn in keys:
                per_file = out["table_bytes"].setdefault(index.fqn, {})
                per_file[info.relative_path] = per_file.get(info.relative_path, 0) + info.length
    return out


def report_mesh_checkpoint(name, results):
    """(16) Prints and checks ``mesh_checkpoint``'s readings of every rank:
    the loaded state bit-equal, the next step within ``RESUME_TOL`` of the
    pickle-resumed one, each rank's rows of the item table in its own file
    and no file holding the whole table or one of its whole Adam moments
    (the replicated tensors, written once, may make one file the larger)."""
    ranks = [results[r]["checkpoint"] for r in sorted(results)]
    first = ranks[0]
    rows, dim = first["table"]
    table_bytes = rows * dim * 4
    loss = max(abs(a - b) / abs(b) for a, b in (r["losses"] for r in ranks))
    param = max(r["param"] for r in ranks)
    print(f"mesh {name} directory checkpoint: save "
          + ", ".join(f"{r['save_s']:.3f}" for r in ranks) + " s, load "
          + ", ".join(f"{r['load_s']:.3f}" for r in ranks) + " s a rank; files "
          f"{first['files']}; item table [{rows}, {dim}] ({table_bytes} bytes) in chunks "
          f"{first['chunks']}, its bytes (and its moments') by file {first['table_bytes']}; loaded state bit-equal {[r['bit_equal'] for r in ranks]}; "
          f"the next step against the pickle-resumed one: loss {loss:.3e}, parameters "
          f"{param:.3e}")
    owners = [(offset[0], sizes[0], file) for offset, sizes, file in first["chunks"]]
    check(owners == [(0, rows // 2, "__0_0.distcp"), (rows // 2, rows // 2, "__1_0.distcp")],
          f"mesh {name}: the item table's chunks are not each rank's rows in its file {owners}")
    check(len(first["table_bytes"]) == 3 and all(
              len(per_file) == 2 and all(n < table_bytes for n in per_file.values())
              for per_file in first["table_bytes"].values()),
          f"mesh {name}: a rank's file holds the whole item table or its moments "
          f"{first['table_bytes']}")
    check(all(r["bit_equal"] for r in ranks),
          f"mesh {name}: the directory checkpoint's state differs from the saved one")
    check(loss <= RESUME_TOL["loss"] and param <= RESUME_TOL["param"],
          f"mesh {name}: the directory-resumed step lies off the pickle-resumed one "
          f"(loss {loss:.3e}, parameters {param:.3e})")


def mesh_cli_phase(workdir, phase6_argv, phase6_rows):
    """(16) Phase 6's G1 trainer CLI again with ``--data_parallelism 1``:
    ``mesh_from_args`` makes a world of this one process over NCCL on
    ``cuda:LOCAL_RANK`` and the harness runs with a 1 x 1 ``MeshPlan`` (the
    sharded steps, the host tier through the rank blocks, the histograms
    and the checkpoint gathered).  The baselines' columns bit-equal to phase
    6's (they rank the same sampled candidates); CHAMELEON's printed
    against them (the embeddings' backward adds with float atomics)."""
    from chameleon_recsys_tpu_torch.cli import nar_trainer_gcom

    argv = list(phase6_argv)
    argv[argv.index("--model_dir") + 1] = str(workdir / "model_dp1")
    for flag in ("--artifact_store_root", "--sync_artifacts_to"):
        i = argv.index(flag)
        del argv[i: i + 2]
    argv += ["--data_parallelism", "1"]
    counts, rows = run_trainer_cli(nar_trainer_gcom, argv, "mesh cli dp1")
    check(not torch.distributed.is_initialized(), "mesh cli dp1: the world was not left")
    check(len(rows) == len(phase6_rows), f"mesh cli dp1: {len(rows)} eval rows")
    baseline = [k for k in phase6_rows[0]
                if any(k.endswith(f"_{b}") for b in G1_BASELINES)]
    differ = [(i, k) for i, (a, b) in enumerate(zip(rows, phase6_rows)) for k in baseline
              if a[k] != b[k]]
    chameleon = max(abs(float(a[k]) - float(b[k])) for a, b in zip(rows, phase6_rows)
                    for k in a if k.endswith("_chameleon"))
    print(f"mesh cli dp1: {len(baseline)} baseline columns a row, bit-equal to phase 6's "
          f"{not differ}; CHAMELEON's columns at most {chameleon:.3e} from phase 6's")
    check(not differ, f"mesh cli dp1: baseline columns differ from phase 6's {differ[:5]}")
    return counts


def mesh_dryrun():
    """(16) ``parallel/dryrun.py``'s harness over a 2 x 2 world on the
    card: every phase checked by the dry run itself; here each rank's
    kernel launches (every kernel of the train and eval steps at least
    once).  Returns them summed over the ranks."""
    from chameleon_recsys_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    try:
        result = dryrun_multichip(4, "cuda", backend="gloo", timeout=MESH_TIMEOUT)
    except Exception as err:  # a failed rank or check
        check(False, f"mesh dryrun: {err}")
    wall = time.perf_counter() - t0
    totals = collections.Counter()
    for rank, launches in enumerate(result["launches_by_rank"]):
        check(all(launches[k] > 0 for k in ("cand_score_fwd", "cand_score_fwd_stash",
                                             "cand_score_bwd", "ugrnn_fwd", "ugrnn_bwd")),
              f"mesh dryrun rank {rank}: a kernel of the path was not launched {launches}")
        totals.update(launches)
    print(f"mesh dryrun 2x2 over gloo on the card ({wall:.1f} s wall with the ranks' "
          f"start): kernel launches by rank {result['launches_by_rank']}; collectives on "
          f"rank 0 {result['collectives']}")
    return totals


# ---------------------------------------------------------------------------
# 17: the quality example on the card
# ---------------------------------------------------------------------------

# RESULTS.md's experiments through the port's example
# (cli/train_nar_synthetic.py), each at the size RESULTS.md publishes: A the
# Markov stream (CAR 128, UGRNN 64 x 2, 20 negatives, top 10), D the churning
# catalog (50 negatives, top 3), B the G1-scale model (CAR 1024, UGRNN 255 x
# 2, 50 negatives), which runs with both kernel flags on in the example's f32
SYNTHETIC_RUNS = {
    "A": ["--hours", "9", "--eval_every", "2", "--sessions_per_hour", "96",
          "--num_items", "800"],
    "D": ["--stream", "churn", "--hours", "16", "--eval_every", "2",
          "--sessions_per_hour", "320", "--num_items", "1500", "--batch_size", "24",
          "--negatives", "50", "--top_n", "3"],
    "B": ["--num_items", "10000", "--hours", "24", "--sessions_per_hour", "768",
          "--car_size", "1024", "--rnn_units", "255", "--negatives", "50",
          "--eval_every", "4"],
}
SYNTHETIC_KERNELS = {"use_pallas_rnn": True, "use_pallas_scorer": True}
# A's hours 0-4 on the card and on its host's CPU from the same weights and
# sampler uniforms: the baseline columns bit-equal, CHAMELEON's HR and MRR
# within these (absolute; set before the first run on the card from the
# 7.6e-3 probability drift between the card and the CPU that
# scripts/card_cpu_drift.py reads for a NAR CLI over three hours: at 21
# candidates a drift that size moves a positive across the 10th rank in a
# few percent of ~550 clicks an eval)
SYNTHETIC_CPU_HOURS = 5
SYNTHETIC_CPU_TOL = {"hr": 5e-2, "mrr": 2e-2}


@contextlib.contextmanager
def seeded_uniforms(seed, cfg):
    """Within the block the harness's train and eval steps draw their
    sampler uniforms from ``np.random.RandomState(seed)``, step by step, at
    the grid's shapes (``cfg``'s batch, no capacity): a run on the CPU and
    one on the card draw the same."""
    from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
    from chameleon_recsys_tpu_torch.train import steps, temporal

    rng = np.random.RandomState(seed)
    b, length = cfg.batch_size, cfg.max_session_length

    def draw(device, negatives, from_buffer):
        nc = min(negatives * cfg.neg_sampling_multiplying_factor, b * length + from_buffer)
        shapes = ((cfg.recent_clicks_buffer_max_size,), (b * length + from_buffer,),
                  (b, length, nc))
        return SamplerUniforms(*(torch.from_numpy(rng.uniform(size=s).astype(np.float32))
                                 .to(device) for s in shapes))

    saved = temporal.train_step, temporal.eval_step
    temporal.train_step = lambda state, batch, ace, meta: steps.train_step(
        state, batch, ace, meta,
        uniforms=draw(ace.device, cfg.negative_samples, cfg.negative_sample_from_buffer))
    temporal.eval_step = lambda model, stream, batch, ace, meta, **kw: steps.eval_step(
        model, stream, batch, ace, meta, uniforms=draw(
            ace.device, cfg.eval_negative_samples, cfg.eval_negative_sample_from_buffer),
        **kw)
    try:
        yield
    finally:
        temporal.train_step, temporal.eval_step = saved


def synthetic_run(label, argv, device="cuda", overrides=None, hours=None, seed=None):
    """The example's harness on ``argv`` (``cli.train_nar_synthetic.build``)
    over its hours (or ``hours``), with the example's own draws or, with
    ``seed``, ``seeded_uniforms``; prints the per-eval-hour table and
    returns (rows, wall seconds, the harness, its hour source)."""
    from chameleon_recsys_tpu_torch.cli import train_nar_synthetic

    args = train_nar_synthetic.create_args_parser().parse_args(argv + ["--platform", device])
    harness, source = train_nar_synthetic.build(args, device, overrides)
    hours = range(args.hours) if hours is None else hours
    draws = (contextlib.nullcontext() if seed is None
             else seeded_uniforms(seed, harness.cfg))
    t0 = time.perf_counter()
    with draws:
        rows = harness.run(source, hours)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    harness.export_artifacts()
    for i, row in enumerate(rows):
        print(f"synthetic {label}: {train_nar_synthetic.format_row(i, row)}; MRR "
              f"{row['mrr_at_n_chameleon']:.6f}, HR {row['hitrate_at_n_chameleon']:.6f}")
    print(f"synthetic {label}: {len(list(hours))} hours in {wall:.3f} s wall, "
          f"train_sessions_per_s {rows[-1]['train_sessions_per_s']:.1f}")
    return rows, wall, harness, source


def synthetic_kernel_times(harness, source, launches):
    """The five kernels at B's shapes in f32 (the example's dtype): the
    fused scorer on the operands of an eval and a train step of B's model
    on hour 0's first batch (K1f, K1fs, K1b and K1b', which B does not run
    but which must match K1b bit for bit), the UGRNN kernels on random
    operands at B's widths ([32, 11, 510]) under that batch's mask; each
    against its twin, timed by CUDA events beside its twin and its bounds
    (the split-TF32 tensor cores' rate, and ``bound_cuda_core_ms`` at the
    CUDA cores'), the scorer's forward beside the CAR product alone on
    ``torch.matmul`` (f32, TF32 off: ``library_ms``).  Returns the entries
    and a function that splits K1b by launch (torch profiler: run beside the
    bf16 scorer's splits), which ``report_synthetic_kernels`` prints with
    them as one JSON line."""
    from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer, ugrnn
    from chameleon_recsys_tpu_torch.train.steps import (
        eval_scorer_operands,
        train_scorer_operands,
        valid_click_mask,
    )

    cfg = harness.cfg
    np_batch = next(iter(harness._batches(source(0))))
    batch = {k: torch.from_numpy(v).cuda() for k, v in np_batch.items()}
    args = (harness.state.model, harness.state.stream, batch, harness.ace_matrix,
            harness.metadata)
    out = {}

    def bounds(fn, ops):
        ms, by = fn(ops)[:2]
        return dict(bound_ms=ms, bound_by=by, bound_cuda_core_ms=fn(ops, cuda_cores=True)[0])

    def car_product_ms(ops):
        return cuda_ms(lambda: torch.matmul(ops[0], ops[3]), iters=20, warmup=3)

    with torch.no_grad():
        ops = eval_scorer_operands(*args, generator=torch.Generator("cuda").manual_seed(5))
        err = (cand_scorer.cand_score_kernel(*ops)
               - cand_scorer.cand_score_reference(*ops)).abs().max().item()
        check(err <= 1e-5, f"synthetic B: cand_score_fwd disagrees at B's shape: {err}")
        out["cand_score_fwd"] = dict(
            shape=list(ops[0].shape), max_abs_err=err, **bounds(cand_score_bound_ms, ops),
            ms=cuda_ms(lambda: cand_scorer.cand_score_kernel(*ops), iters=20, warmup=3),
            plain_ms=cuda_ms(lambda: cand_scorer.cand_score_reference(*ops), iters=5,
                             warmup=1),
            library_ms=car_product_ms(ops))
        ops = train_scorer_operands(*args, generator=torch.Generator("cuda").manual_seed(6))
        bt, k = ops[1].shape[0], ops[0].shape[0] // ops[1].shape[0]
        g = (torch.randn(bt, k, generator=torch.Generator().manual_seed(7))
             / (bt * cfg.softmax_temperature)).cuda()
        nc_err, bwd_err = check_scorer_train_kernels("synthetic_b", ops, g, 2e-4)
        _, nc = cand_scorer.cand_score_kernel(*ops, return_nc=True)
        out["cand_score_fwd_stash"] = dict(
            shape=list(ops[0].shape), max_abs_err=nc_err,
            **bounds(cand_score_stash_bound_ms, ops),
            ms=cuda_ms(lambda: cand_scorer.cand_score_kernel(*ops, return_nc=True),
                       iters=20, warmup=3),
            plain_ms=cuda_ms(lambda: cand_scorer.cand_score_reference(*ops, return_nc=True),
                             iters=5, warmup=1),
            library_ms=car_product_ms(ops))
        out["cand_score_bwd"] = dict(
            shape=list(ops[0].shape), max_abs_err=bwd_err,
            **bounds(cand_score_bwd_bound_ms, ops),
            ms=cuda_ms(lambda: cand_scorer.cand_score_bwd_kernel(*ops, nc, g), iters=20,
                       warmup=3),
            plain_ms=cuda_ms(lambda: cand_scorer.cand_score_bwd_reference(*ops, nc, g),
                             iters=5, warmup=1),
            library_ms=None)
        rec_err = check_recompute_kernel("synthetic_b", ops, g, 2e-4)
        out["cand_score_bwd_recompute"] = dict(
            shape=list(ops[0].shape), max_abs_err=rec_err,
            **bounds(cand_score_bwd_recompute_bound_ms, ops),
            ms=cuda_ms(lambda: cand_scorer.cand_score_bwd_recompute_kernel(*ops, g),
                       iters=20, warmup=3),
            plain_ms=cuda_ms(lambda: cand_scorer.cand_score_bwd_reference(*ops, None, g),
                             iters=5, warmup=1),
            library_ms=None)

        # the f32 launches' scratch (the split halves, the partials) and what
        # one call adds to the device memory at its peak
        for name, fn in (("cand_score_fwd_stash",
                          lambda: cand_scorer.cand_score_kernel(*ops, return_nc=True)),
                         ("cand_score_bwd",
                          lambda: cand_scorer.cand_score_bwd_kernel(*ops, nc, g))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            out[name]["peak_added_bytes"] = torch.cuda.max_memory_allocated() - base
        out["cand_score_fwd_stash"]["scratch_bytes"] = scorer_scratch_bytes(ops, "fwd")
        out["cand_score_bwd"]["scratch_bytes"] = scorer_scratch_bytes(ops, "bwd")

    def split_bwd():
        with torch.no_grad():
            return launch_split(lambda: cand_scorer.cand_score_bwd_kernel(*ops, nc, g), 3)

    mask = valid_click_mask(batch["session_size"], cfg.max_inputs_length).cpu()
    x, w, m = ugrnn_inputs(mask, torch.float32, seed=8, units=cfg.rnn_units)
    err = (ugrnn.ugrnn_scan_kernel(x, w, m)
           - ugrnn.ugrnn_scan_reference(x, w, m)).abs().max().item()
    check(err <= 1e-5, f"synthetic B: ugrnn_fwd disagrees at B's shape: {err}")
    bms, by = ugrnn_bound_ms(x, w, m)
    out["ugrnn_fwd"] = dict(
        shape=list(x.shape), max_abs_err=err, bound_ms=bms, bound_by=by,
        ms=queued_ms(lambda: ugrnn.ugrnn_scan_kernel(x, w, m, return_acts=True), iters=200),
        plain_ms=cuda_ms(lambda: ugrnn.ugrnn_scan_reference(x, w, m), iters=20))
    _, hs, acts = ugrnn.ugrnn_scan_kernel(x, w, m, return_acts=True)
    g_out = torch.randn(*hs.shape, generator=torch.Generator().manual_seed(9)).cuda()
    got = ugrnn.ugrnn_scan_bwd_kernel(x, w, m, hs, g_out, acts=acts)
    ref = ugrnn.ugrnn_scan_bwd_reference(x, w, m, hs, g_out)
    errs = [(a - e).abs().max().item() / max(e.abs().max().item(), 1e-30)
            for a, e in zip(got, ref)]
    check(max(errs) <= 2e-4, f"synthetic B: ugrnn_bwd disagrees at B's shape: {errs}")
    bms, by = ugrnn_bwd_bound_ms(x, w, m)
    out["ugrnn_bwd"] = dict(
        shape=list(x.shape), max_abs_err=max((a - e).abs().max().item()
                                             for a, e in zip(got, ref)),
        bound_ms=bms, bound_by=by,
        ms=queued_ms(lambda: ugrnn.ugrnn_scan_bwd_kernel(x, w, m, hs, g_out, acts=acts),
                     iters=100),
        plain_ms=cuda_ms(lambda: ugrnn.ugrnn_scan_bwd_reference(x, w, m, hs, g_out,
                                                                acts=acts), iters=10))
    for name, entry in out.items():
        entry["launches"] = launches[name]
    return out, split_bwd


def report_synthetic_kernels(out, split_bwd):
    """Splits f32 K1b at B's shapes by launch (``split_bwd``), prints the
    split and adds it to K1b's entry, then prints the ``synthetic B kernels``
    JSON line."""
    split = split_bwd()
    print_split("cand_score_bwd [17600, 1024] float32 (synthetic B)", split)
    out["cand_score_bwd"]["split_ms"] = [
        [name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0],
         us / 1e3] for name, us in split]
    print("synthetic B kernels, float32 at B's shapes " + json.dumps(out))


def synthetic_phase():
    """(17) RESULTS.md's A, D and B through the port's example on the card
    (``SYNTHETIC_RUNS``), B with both kernel flags on, counted; checks the
    quality RESULTS.md reports (A: CHAMELEON's HR@10 above popularity's at
    every eval; D: the last eval's HR@3 above co-occurrence's and SR's; B:
    the last eval's HR@10 above the first's) and that B launched the five
    kernels of its path; then A's hours 0-4 on the card and on the CPU with
    the same draws (``SYNTHETIC_CPU_TOL``), and the five kernels timed at
    B's shapes.  Returns B's launch counts and ``synthetic_kernel_times``'s
    entries and K1b split."""
    rows, _, _, _ = synthetic_run("A", SYNTHETIC_RUNS["A"])
    below = [i for i, r in enumerate(rows)
             if r["hitrate_at_n_chameleon"] <= r["hitrate_at_n_pop_recent"]]
    check(len(rows) == 4 and not below,
          f"synthetic A: CHAMELEON's HR@10 not above popularity's at evals {below}")
    rows, _, _, _ = synthetic_run("D", SYNTHETIC_RUNS["D"])
    last = rows[-1]
    check(last["hitrate_at_n_chameleon"] > max(last["hitrate_at_n_coocurrent"],
                                               last["hitrate_at_n_sr"]),
          "synthetic D: the last eval's HR@3 is not above co-occurrence's and SR's")
    zero_launch_counts()
    rows, _, harness, source = synthetic_run("B", SYNTHETIC_RUNS["B"],
                                             overrides=SYNTHETIC_KERNELS)
    counts = launch_counts()
    train_steps, eval_steps = 24 * 24, 5 * 24  # 768 sessions in batches of 32
    expected = {"cand_score_fwd": eval_steps, "cand_score_fwd_stash": train_steps,
                "cand_score_bwd": train_steps, "cand_score_bwd_recompute": 0,
                **ugrnn_expected(2 * (train_steps + eval_steps), 2 * train_steps)}
    print(f"synthetic B launches {counts} (both kernel flags, float32)")
    check(all(counts[k] > 0 for k in ("ugrnn_fwd", "ugrnn_bwd", "cand_score_fwd",
                                      "cand_score_fwd_stash", "cand_score_bwd")),
          f"synthetic B: a kernel of the path was not launched {counts}")
    check(counts == expected, f"synthetic B launches {counts}, expected {expected}")
    check(len(rows) == 5 and rows[-1]["hitrate_at_n_chameleon"]
          > rows[0]["hitrate_at_n_chameleon"],
          "synthetic B: the last eval's HR@10 is not above the first's")
    f32_kernels = synthetic_kernel_times(harness, source, counts)
    del harness

    hours = range(SYNTHETIC_CPU_HOURS)
    card, _, _, _ = synthetic_run("A card, seeded draws", SYNTHETIC_RUNS["A"],
                                  hours=hours, seed=17)
    cpu, _, _, _ = synthetic_run("A cpu, seeded draws", SYNTHETIC_RUNS["A"], device="cpu",
                                 hours=hours, seed=17)
    baseline = [k for k in cpu[0] if k.endswith(("_pop_recent", "_coocurrent", "_sr"))]
    differ = [(i, k) for i, (a, b) in enumerate(zip(card, cpu)) for k in baseline
              if a[k] != b[k]]
    diffs = {m: max(abs(a[f"{key}_chameleon"] - b[f"{key}_chameleon"])
                    for a, b in zip(card, cpu))
             for m, key in (("hr", "hitrate_at_n"), ("mrr", "mrr_at_n"))}
    print(f"synthetic A card vs cpu (hours 0-{SYNTHETIC_CPU_HOURS - 1}, same weights and "
          f"draws): {len(baseline)} baseline columns a row bit-equal {not differ}; "
          f"CHAMELEON HR difference {diffs['hr']:.3e}, MRR {diffs['mrr']:.3e} "
          f"(tolerances {SYNTHETIC_CPU_TOL})")
    check(len(card) == len(cpu) == 2 and not differ,
          f"synthetic A: the card's baseline columns differ from the CPU's {differ[:5]}")
    check(all(diffs[k] <= SYNTHETIC_CPU_TOL[k] for k in diffs),
          f"synthetic A: CHAMELEON on the card lies off the CPU's {diffs}")
    return counts, f32_kernels


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

    # ---- 1. build every kernel of the paths, and the native host code ----
    native_result = []
    native_thread = threading.Thread(target=lambda: native_result.append(native_build()))
    native_thread.start()
    t0 = time.perf_counter()
    build.build(KERNELS)
    print(f"build: {time.perf_counter() - t0:.3f} s for {', '.join(KERNELS)}")
    native_thread.join(timeout=300)
    check(native_result, "native build: did not finish")
    seconds, zlib_header, loaded, native_errors = native_result[0]
    print(f"native build (g++ -O3 -march=native, beside nvcc): "
          + ", ".join(f"{k}.cc {v:.3f} s" for k, v in seconds.items())
          + f"; zlib.h {'found' if zlib_header else 'missing'}; sknn, chio loaded {loaded}")
    check(all(loaded), f"native build failed: {native_errors}")
    for name in KERNELS:
        log = build.build_log.get(name, "")
        registers = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
        if registers:
            print(f"  ptxas {name}: {len(registers)} instantiations, registers "
                  f"{min(registers)}-{max(registers)}, spill bytes {spills}")
    # the backward's row kernel, GEMM and split instantiations, one by one
    # (dynamic shared memory is set at launch: the row kernel's, the bf16
    # core's 97.1 KB, the split-TF32 core's 193.0 KB)
    for entry, registers, spill, smem in ptxas_entries(
            build.build_log.get("cand_score_bwd", "")):
        if any(k in entry for k in ("rows_kernel", "gemm_kernel", "gemm_tf32_kernel",
                                    "split_")):
            print(f"  ptxas cand_score_bwd {entry}: {registers} registers, "
                  f"{spill} bytes spill stores, {smem} bytes static smem")
    # the forward's kernels (bf16 on wgmma + TMA; f32: the weights' split,
    # split TF32 on wgmma + TMA, the matching tail) and the dynamic shared
    # memory each dtype's launches set at most at the G1 widths
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
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as g1_workdir:
        # ---- 6. the G1 pipeline through its CLIs, on the card ----
        cli_counts, g1_argv, g1_rows = g1_cli_phase(Path(g1_workdir))
        # ---- 7. the Adressa chain through its CLIs, on the card ----
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as workdir:
            adressa_counts, profile_acr_step = adressa_cli_phase(Path(workdir))
        # ---- 8. the dense train path with dropout at G1 width, counted ----
        dropout_counts, profile_dropout_step = dropout_phase(
            port, server, cfg, session_schema, article_schema, corpus)
        # ---- 9. the G1 sweep through its CLI, on phase 6's files ----
        sweep_counts = sweep_phase(Path(g1_workdir))
        # ---- 10. G1 ACR and the ACE baselines through their CLIs ----
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as workdir:
            g1_acr_counts, profile_autoencoder_step = g1_acr_phase(Path(workdir))
        # ---- 11. the neural baselines through their CLIs, on phase 6's files ----
        neural_counts, profile_neural_steps = neural_cli_phase(Path(g1_workdir))
        # ---- 13. the native host code: phase 6's CLI on the C++ loader ----
        native_counts = native_phase(Path(g1_workdir), g1_argv, g1_rows)
        # ---- 16 (its CLI part). phase 6's CLI as a world of one over NCCL ----
        mesh_cli_counts = mesh_cli_phase(Path(g1_workdir), g1_argv, g1_rows)
    # ---- 14. grouped compaction at phase 4's capacity, counted ----
    grouped_counts = grouped_phase(port, server, cfg, session_schema, article_schema,
                                   corpus, train_batches, capacity)
    # ---- 15. ACR in bf16 against f32 at the published widths ----
    acr_bf16_counts, profile_acr_bf16 = acr_bf16_phase()
    # ---- 16. multi-GPU on the one card: three worlds of spawned ranks ----
    mesh_counts = mesh_phase()
    # ---- 17. the quality example: RESULTS.md's A, D and B on the card ----
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as workdir:
        tempfile.tempdir = workdir  # the example's model directories
        try:
            t0 = time.perf_counter()
            synthetic_counts, (f32_kernels, split_f32_bwd) = synthetic_phase()
            print(f"synthetic phase: {time.perf_counter() - t0:.1f} s wall")
        finally:
            tempfile.tempdir = None
    paths = (serve_counts, eval_counts, train_counts, recompute_counts, harness_counts,
             cli_counts, adressa_counts, dropout_counts, sweep_counts, g1_acr_counts,
             neural_counts, native_counts, grouped_counts, acr_bf16_counts, mesh_cli_counts,
             mesh_counts, synthetic_counts)
    main_launches = {k: sum(path.get(k, 0) for path in paths)
                     for k in KERNEL_NAMES + UGRNN_INSTANTIATIONS}
    print(f"launches over the counted paths: {main_launches}")
    check(main_launches["ugrnn_fwd_stream"] == main_launches["ugrnn_bwd_stream"] == 0,
          "a G1 path ran a streaming UGRNN kernel")

    # ---- 12a. each kernel against its plain twin ----
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
    # split-TF32 branch) and the odd shape in both dtypes
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

    # ---- 12b. served scores, an eval and a train step against the CPU ----
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

    # ---- 12c. times ----
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
    print_profile(
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
    print_profile("eval_step", one_eval_step, 5, step_ms)

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
        report_synthetic_kernels(f32_kernels, split_f32_bwd)
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
    print_profile("train_step", one_train_step, 3, train_ms)
    cand_scorer._STASH_NC = False
    nostash_ms = cuda_ms(one_train_step, iters=10, warmup=2)
    print_profile("train_step without the stash", one_train_step, 3, nostash_ms)
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

    # the CLI phases' ACR steps, the dropout step and the neural baselines' steps,
    # after every other profile
    profile_acr_step()
    profile_autoencoder_step()
    profile_dropout_step()
    profile_neural_steps()
    profile_acr_bf16()

    kernels = [
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
    ]
    # the scorer's f32 kernels at B's shapes (phase 17; launches: B's run,
    # the f32 path's), beside the bf16 rows above
    where = {k["name"]: (k["source"], k["replaces"]) for k in kernels}
    for name in ("cand_score_fwd", "cand_score_fwd_stash", "cand_score_bwd",
                 "cand_score_bwd_recompute"):
        entry = f32_kernels[name]
        kernels.append({
            "name": f"{name}_f32", "route": "cuda", "source": where[name][0],
            "replaces": where[name][1], **{key: entry[key] for key in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "bound_cuda_core_ms", "shape")},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

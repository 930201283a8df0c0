"""What the per-layer readers share: the kernels of each layer by name in
the device trace, and their rooflines and the whole step's share of the
peak, from ``flops``' counts and ``peaks``' table."""
from __future__ import annotations

import re
import statistics
from typing import Optional

from . import flops, peaks
from .drivers.common import reference_module

# the fused candidate scorer's launches: its forward and backward
# libraries' kernels and the GEMM core the backward runs on
CAND_SCORER = re.compile(
    r"cand_score|sm90::|(?<![A-Za-z0-9_])(segment_sum_kernel|prod_kernel|tn_product_kernel|"
    r"split_rows_kernel|split_transpose_kernel|column_sum_kernel|reduce_partials_kernel|"
    r"split_weight_kernel)(?![A-Za-z0-9_])")
UGRNN = re.compile(r"ugrnn_")


def kernel_seconds(run, pattern) -> float:
    tr = run.trace_summary
    if tr is None:
        return 0.0
    return sum(s for name, s in tr.kernels.items() if pattern.search(name))


def _dtype(run) -> str:
    return run.config["nar"].get("compute_dtype", "float32")


def _itemsize(run) -> int:
    return 2 if _dtype(run) in ("bfloat16", "float16") else 4


def _least_seconds(run, work: flops.Work) -> float:
    return work.seconds(peaks.flops_peak(run.device, _dtype(run)), peaks.bytes_peak(run.device))


def scorer_roofline(run, train: bool) -> Optional[float]:
    """The least time of the scorer's work in the traced stretch (its
    forward, and in training its backward, over the valid rows' pairs) over
    the time of its kernels, in %."""
    secs = kernel_seconds(run, CAND_SCORER)
    work = run.work.get("trace") if run.work else None
    if secs <= 0 or not work:
        return None
    model = reference_module(run.config).Model(run.config)
    rows, k = int(work["scored_rows"]), int(work["candidates"])
    size = _itemsize(run)
    need = flops.scorer_forward(rows * k, rows, model.c, model.matching, size)
    if train:
        need = need + flops.scorer_backward(rows * k, rows, model.c, model.matching, size)
    return 100.0 * _least_seconds(run, need) / secs


def ugrnn_roofline(run, train: bool) -> Optional[float]:
    """The least time of the UGRNN recurrences (every layer; in training
    their backward too) over the time of their kernels, in %."""
    secs = kernel_seconds(run, UGRNN)
    work = run.work.get("trace") if run.work else None
    if secs <= 0 or not work:
        return None
    model = reference_module(run.config).Model(run.config)
    valid, grid = int(work["valid_rows"]), int(work["grid_rows"])
    size = _itemsize(run)
    need = flops.Work(0.0, 0.0)
    for _ in range(model.layers):
        need = need + flops.ugrnn_forward(valid, grid, model.units, size)
        if train:
            need = need + flops.ugrnn_backward(valid, grid, model.units, size)
    return 100.0 * _least_seconds(run, need) / secs


def mfu(run) -> Optional[float]:
    """The model's operations over the window, over the window's time at
    the card's peak rate for the configuration's type, in %."""
    if not run.work or not run.window_s or "model_flops" not in run.work:
        return None
    return 100.0 * run.work["model_flops"] / run.window_s / peaks.flops_peak(run.device, _dtype(run))


def idle_share(run) -> Optional[float]:
    tr = run.trace_summary
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s


def median_ms(values) -> Optional[float]:
    return 1e3 * statistics.median(values) if values else None

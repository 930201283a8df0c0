"""GRU4Rec's operations and its update's bytes, from its shapes, and the
readers of its per-layer metrics.

Counts are of the work the step's semantics need, whatever implements it
(``flops``' rule): each matrix product once (2 operations a multiply-add),
elementwise work left out.  The forward runs every (session, step) of the
padded [B, T] batch: the first layer's input projection is a row gather (no
product), a later layer's a [B T, U_prev] x [U_prev, 3U] product; each step
``h W_rz`` and ``(r h) W_h``; the scores ``[T, B, U] x [T, U, B + n]``.  A
training step is 3x its forward.  The update needs, for every parameter
element it may change, its value, gradient and Adagrad accumulator read and
its value and accumulator written: the touched rows of the item tables
(``wx.0``, ``wy`` with ``by``; the system's counter
``gru4rec.rows_touched``) and every other parameter whole, in float32."""
from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

from . import peaks
from .spans import REGISTRY

F32 = 4
UPDATE_PASSES = 5  # read p, g, acc; write p, acc


def forward_flops(layers: Sequence[int], batch: int, t: int, n_sample: int) -> float:
    rows = batch * t
    fl, width = 0.0, None
    for u in layers:
        if width is not None:
            fl += 2.0 * rows * width * 3 * u
        fl += 2.0 * rows * (u * 2 * u + u * u)
        width = u
    return fl + 2.0 * rows * (batch + n_sample) * layers[-1]


def step_flops(layers: Sequence[int], batch: int, t: int, n_sample: int) -> float:
    return 3.0 * forward_flops(layers, batch, t, n_sample)


def dense_elements(layers: Sequence[int]) -> int:
    """The parameters the update changes whole: every layer's ``wh``,
    ``wrz``, ``bh`` and, past the first, its ``wx``."""
    n, width = 0, None
    for u in layers:
        n += u * u + u * 2 * u + 3 * u + (width * 3 * u if width is not None else 0)
        width = u
    return n


def update_bytes(layers: Sequence[int], steps: int, rows_wx: float, rows_wy: float) -> float:
    """The least bytes ``steps`` updates move that touch ``rows_wx`` rows of
    ``wx.0`` and ``rows_wy`` rows of ``wy`` / ``by`` in all."""
    table = rows_wx * 3 * layers[0] + rows_wy * (layers[-1] + 1)
    return float(UPDATE_PASSES * F32 * (table + steps * dense_elements(layers)))


def counters() -> Dict[str, Dict[str, float]]:
    """The system's counters; empty where it has none."""
    read = getattr(sys.modules.get(REGISTRY), "counter_snapshot", None)
    return read() if read is not None else {}


def update_roofline(run) -> Optional[float]:
    """The least time of the traced updates' bytes at the card's HBM rate
    over the device time of the kernels launched under ``gru4rec.update``,
    in %."""
    work = run.work.get("trace") if run.work else None
    touched = counters().get("gru4rec.rows_touched")
    if not work or not touched or not touched.get("steps") or not work.get("update_s"):
        return None
    g = run.config["gru4rec"]
    need = update_bytes([int(u) for u in g["layers"]], int(touched["steps"]),
                        touched["wx"], touched["wy"])
    return 100.0 * need / peaks.bytes_peak(run.device) / work["update_s"]


def mfu(run) -> Optional[float]:
    """The model's operations over the window over its time at the card's
    float32 peak, in %."""
    if not run.work or not run.window_s or "model_flops" not in run.work:
        return None
    return (100.0 * run.work["model_flops"] / run.window_s
            / peaks.flops_peak(run.device, "float32"))

"""Per-step observability channel: JSON-lines scalars and histograms.

The port's copy of ``chameleon_recsys_tpu/utils/summary.py``, with the same
files and rows.  Twin of the reference's TensorBoard summaries: scalar
families written throughout the graph (reference
nar_module/nar/nar_model.py:203-205, 656-704) and the optional parameter
histograms behind ``--save_histograms`` ("makes the job slower",
nar_trainer_gcom.py:54).

Nothing is summarized inside a step: the train loop keeps the step's device
scalars unconverted (no per-step host sync) and fetches them once an hour;
histograms are computed on the host from the model's parameters at hour
boundaries, under this package's parameter names (``convert`` maps them to
the JAX package's).  The sink is JSON-lines:

  <model_dir>/train_scalars.jsonl     {"step": N, "wall_time": t, "<k>": v}
  <model_dir>/train_histograms.jsonl  {"step": N, "name": p, "counts": [...],
                                       "bin_edges": [...], "mean": m, ...}
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable

import numpy as np
import torch


class ScalarWriter:
    """Buffered JSON-lines scalar sink (one row per train step)."""

    def __init__(self, model_dir: str, filename: str = "train_scalars.jsonl",
                 buffer_rows: int = 256):
        self.path = Path(model_dir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._buf: list = []
        self._buffer_rows = buffer_rows

    def write(self, step: int, scalars: Dict[str, float]):
        row = {"step": int(step), "wall_time": time.time()}
        for k, v in scalars.items():
            row[k] = float(v)
        self._buf.append(json.dumps(row))
        if len(self._buf) >= self._buffer_rows:
            self.flush()

    def flush(self):
        if not self._buf:
            return
        with open(self.path, "a") as f:
            f.write("\n".join(self._buf) + "\n")
        self._buf.clear()


class HistogramWriter:
    """JSON-lines histogram sink for parameter / gradient pytrees."""

    def __init__(self, model_dir: str,
                 filename: str = "train_histograms.jsonl", bins: int = 30):
        self.path = Path(model_dir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.bins = bins

    def write(self, step: int, name: str, values: np.ndarray):
        values = np.asarray(values, np.float64).reshape(-1)
        if values.size == 0:
            return
        counts, edges = np.histogram(values, bins=self.bins)
        row = {
            "step": int(step),
            "name": name,
            "counts": counts.tolist(),
            "bin_edges": np.round(edges, 8).tolist(),
            "mean": float(values.mean()),
            "std": float(values.std()),
            "min": float(values.min()),
            "max": float(values.max()),
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def write_tree(self, step: int, model: torch.nn.Module, prefix: str = ""):
        """Histogram every parameter of ``model``, named ``prefix`` + its
        name in ``named_parameters``."""
        for name, value in model.named_parameters():
            self.write(step, prefix + name,
                       value.detach().to("cpu", torch.float32).numpy())


def read_jsonl(path) -> Iterable[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)

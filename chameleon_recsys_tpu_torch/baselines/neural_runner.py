"""The temporal loop of the external neural baselines (GRU4Rec, SR-GNN): the
port of ``chameleon_recsys_tpu/baselines/neural_runner.py``.

Twin of the reference's standalone runners (run_gru4rec.py:141-268,
run_sr_gnn.py:1-189): replicate the NAR temporal protocol — train on hour
chunks, run 2 extra epochs on the chunk's last hour, evaluate the next hour
against the SAME per-session negative samples the NAR eval exported
(eval_sessions_negative_samples.json) — and stream the shared metric suite.
The recent-clicks buffer, the popularity it gives the metrics and the draws
of fresh eval negatives are the JAX runner's, on the host, with the same
numpy ``RandomState``.

The train hour's spans (``utils/profiling.py``, off unless tracing is on),
as ``TemporalHarness`` places its own: ``neural.collate`` (each pull of a
batch), ``neural.step`` (``fit_batch``, with the pool it is handed),
``neural.buffer`` (the buffer's update) and ``neural.wait`` (the hour's
closing fetch of its losses, with the model's counters).
"""
from __future__ import annotations

import json
import logging
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import NARConfig, SessionFeaturesSchema
from ..data.collate import Session, batches_from_sessions
from ..metrics.evaluation import compute_metrics_results, update_metrics
from ..utils.profiling import span, spanned

log = logging.getLogger("chameleon_torch.neural_runner")


def load_eval_negative_samples(path) -> Dict[str, List[List[int]]]:
    """session_id -> per-click negative lists (run_gru4rec.py:121 contract)."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out[rec["session_id"]] = rec["negative_items"]
    return out


def mean_of_scalars(values) -> float:
    """The mean of device scalars and floats, fetched once."""
    device = next((v.device for v in values if torch.is_tensor(v)), torch.device("cpu"))
    return float(torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device)
                              for v in values]).mean())


class NeuralBaselineRunner:
    """Drives a model exposing fit_batch/rank_candidates over the temporal
    protocol, maintaining its own popularity state mirror for metrics."""

    def __init__(
        self,
        model,
        cfg: NARConfig,
        schema: SessionFeaturesSchema,
        num_items: int,
        create_metrics: Callable[[], list],
        eval_negative_samples: Optional[Dict[str, List[List[int]]]] = None,
        extra_epochs_last_hour: int = 2,
        seed: int = 42,
    ):
        self.model = model
        self.cfg = cfg
        self.schema = schema
        self.num_items = num_items
        self.create_metrics = create_metrics
        self.eval_negative_samples = eval_negative_samples or {}
        self.extra_epochs_last_hour = extra_epochs_last_hour
        self.rng = np.random.RandomState(seed)
        # host mirror of recent-clicks buffer for negatives + popularity:
        # ids and their timestamps, newest first
        self._buffer = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        self.metrics_log: List[Dict] = []

    # -- state mirror -------------------------------------------------------
    def _update_buffer(self, batch):
        ids = np.concatenate(
            [batch["item_clicked"], batch["label_last_item"]], axis=1
        ).reshape(-1)
        ts = np.concatenate(
            [
                batch["event_timestamp"],
                batch["event_timestamp"].max(axis=1, keepdims=True),
            ],
            axis=1,
        ).reshape(-1)
        valid = ids != 0
        new_ids = ids[valid][::-1].astype(np.int64)
        new_ts = ts[valid][::-1].astype(np.int64)
        window = int(self.cfg.recent_clicks_buffer_hours * 3600)
        min_ts = int(new_ts.min()) if len(new_ts) else 0
        old_ids, old_ts = self._buffer
        kept = old_ts >= min_ts - window
        size = self.cfg.recent_clicks_buffer_max_size
        self._buffer = (np.concatenate([new_ids, old_ids[kept]])[:size],
                        np.concatenate([new_ts, old_ts[kept]])[:size])

    def _buffer_ids(self) -> np.ndarray:
        ids = self._buffer[0]
        return ids if len(ids) else np.zeros(1, np.int64)

    def _pop_norm(self) -> np.ndarray:
        counts = np.zeros(self.num_items, np.float64)
        ids = self._buffer_ids()
        ids = ids[ids != 0]
        np.add.at(counts, ids, 1.0)
        counts[0] = 0.0
        return np.maximum(
            counts / (counts.sum() + 1.0),
            1.0 / self.cfg.recent_clicks_for_normalization,
        )

    # -- protocol -----------------------------------------------------------
    def _batches(self, sessions: Sequence[Session]):
        return batches_from_sessions(
            sessions, self.schema, self.cfg.batch_size, self.cfg.max_session_length
        )

    def train_hour(self, sessions: Sequence[Session], update_buffer=True):
        """Trains on the hour's batches; their mean loss, fetched once at the
        end (``fit_batch`` returns device scalars)."""
        losses = []
        for batch in spanned("neural.collate", self._batches(sessions)):
            with span("neural.step"):
                loss = self.model.fit_batch(
                    batch["item_clicked"], batch["label_next_item"], self._buffer_ids()
                )
            losses.append(loss)
            if update_buffer:
                with span("neural.buffer"):
                    self._update_buffer(batch)
        with span("neural.wait"):
            mean = mean_of_scalars(losses) if losses else 0.0
            flush = getattr(self.model, "flush_counts", None)
            if flush is not None:
                flush()
        return mean

    def evaluate_hour(self, sessions: Sequence[Session]) -> Dict[str, float]:
        streaming = self.create_metrics()
        buffer_snapshot = self._buffer  # replaced, never changed in place
        k = self.cfg.eval_negative_samples
        for batch in self._batches(sessions):
            labels = batch["label_next_item"]
            b, t = labels.shape
            neg = np.zeros((b, t, k), np.int64)
            for i, sid in enumerate(batch["session_id"]):
                stored = self.eval_negative_samples.get(str(sid))
                if stored is None:  # sample fresh when no NAR log provided
                    pool = self._buffer_ids()
                    pool = pool[pool != 0]
                    # exclude the session's own items (incl. every label) so
                    # a "negative" can never be the positive itself
                    session_items = set(
                        batch["item_clicked"][i].tolist() + labels[i].tolist()
                    ) - {0}
                    valid_pool = pool[~np.isin(pool, list(session_items))]
                    for j in range(t):
                        if labels[i, j] != 0 and len(valid_pool):
                            take = min(k, len(np.unique(valid_pool)))
                            neg[i, j, :take] = self.rng.choice(
                                np.unique(valid_pool), size=take, replace=False
                            )
                else:
                    valid_cols = [j for j in range(t) if labels[i, j] != 0]
                    for idx, j in enumerate(valid_cols):
                        if idx < len(stored):
                            vals = stored[idx][:k]
                            neg[i, j, : len(vals)] = vals
            ranked = self.model.rank_candidates(
                batch["item_clicked"], labels, neg
            )
            pop_norm = self._pop_norm()
            update_metrics(
                ranked,
                labels,
                pop_norm[labels],
                pop_norm[ranked],
                batch["item_clicked"],
                streaming,
                recommender=self.recommender_name(),
            )
            # NO weight update here: the eval hour is trained as part of the
            # NEXT chunk (the reference's chunking includes the former eval
            # file in the following training chunk, run_gru4rec.py:141-199);
            # only the popularity buffer advances, and it is restored below.
            self._update_buffer(batch)
        row = compute_metrics_results(streaming, recommender=self.recommender_name())
        self.metrics_log.append(row)
        self._buffer = buffer_snapshot  # restore pre-eval popularity state
        return row

    def recommender_name(self) -> str:
        explicit = getattr(self.model, "recommender_name", None)
        if isinstance(explicit, str):
            return explicit
        return type(self.model).__name__.lower()

    def run(
        self,
        hour_source: Callable[[int], Sequence[Session]],
        hours: Sequence[int],
        training_hours_for_each_eval: int = 5,
    ) -> List[Dict]:
        hours = list(hours)
        chunk = training_hours_for_each_eval
        for start in range(0, len(hours), chunk):
            train_hours = hours[start : start + chunk]
            for h in train_hours:
                loss = self.train_hour(hour_source(h))
                log.info("%s hour %d loss %.4f", self.recommender_name(), h, loss)
            # 2 extra epochs on the chunk's last hour (run_gru4rec.py:171-188)
            last = hour_source(train_hours[-1])
            for _ in range(self.extra_epochs_last_hour):
                self.train_hour(last, update_buffer=False)
            eval_idx = start + chunk
            if eval_idx < len(hours):
                self.evaluate_hour(hour_source(hours[eval_idx]))
        return self.metrics_log

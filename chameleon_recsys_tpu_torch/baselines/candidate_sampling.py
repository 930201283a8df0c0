"""Numpy candidate-sampling manager for external/offline consumers.

The port's copy of ``chameleon_recsys_tpu/baselines/candidate_sampling.py``,
twin of the reference's host-side mirror of the in-graph sampler
(nar_module/nar/benchmarks/candidate_sampling.py:7-91): it attaches negative
samples to sessions outside the device step (external baselines, offline
analysis).  Semantics match ops/sampling.py: popularity-biased
candidates (buffer repetitions), per-click shuffle→unique→first-K with
in-session exclusion and zero-padding.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np


class CandidateSamplingManager:
    def __init__(
        self,
        get_recent_clicks_buffer_fn: Callable[[], np.ndarray],
        rng: np.random.RandomState = None,
    ):
        self.get_recent_clicks_buffer_fn = get_recent_clicks_buffer_fn
        self.rng = rng or np.random.RandomState(42)

    def get_sample_from_recently_clicked_items_buffer(self, sample_size: int):
        buffer_ids = np.asarray(self.get_recent_clicks_buffer_fn())
        nonzero = buffer_ids[buffer_ids != 0]
        shuffled = self.rng.permutation(nonzero)
        return shuffled[:sample_size]

    def get_candidate_samples(
        self, num_negatives: int, session_item_ids, candidate_samples
    ) -> np.ndarray:
        """First ``num_negatives`` unique valid candidates of one shuffle,
        zero-padded (reference candidate_sampling.py:25-47)."""
        session_set = set(np.asarray(session_item_ids).tolist())
        valid = np.asarray(
            [c for c in candidate_samples if c != 0 and c not in session_set]
        )
        shuffled = self.rng.permutation(valid) if len(valid) else valid
        _, first_idx = np.unique(shuffled, return_index=True)
        unique_in_order = shuffled[np.sort(first_idx)][:num_negatives]
        out = np.zeros(num_negatives, np.int64)
        out[: len(unique_in_order)] = unique_in_order
        return out

    def get_samples_per_click(
        self, session_item_ids, candidate_samples, num_negatives: int
    ) -> np.ndarray:
        """[T, num_negatives]; padded clicks (id 0) get zero rows."""
        session_item_ids = np.asarray(session_item_ids)
        rows = []
        for click_id in session_item_ids:
            if click_id == 0:
                rows.append(np.zeros(num_negatives, np.int64))
            else:
                rows.append(
                    self.get_candidate_samples(
                        num_negatives, session_item_ids, candidate_samples
                    )
                )
        return np.stack(rows)

    def get_batch_negative_samples(
        self,
        batch_clicked_items: np.ndarray,  # [B, T] incl. padding zeros
        num_negatives: int,
        negative_sample_from_buffer: int,
        first_sampling_multiplying_factor: int = 20,
    ) -> np.ndarray:
        """[B, T, num_negatives] (reference candidate_sampling.py:49-91)."""
        batch_clicked_items = np.asarray(batch_clicked_items)
        flat = batch_clicked_items.reshape(-1)
        batch_nonzero = flat[flat != 0]
        buffer_sample = self.get_sample_from_recently_clicked_items_buffer(
            negative_sample_from_buffer
        )
        candidates = np.concatenate([batch_nonzero, buffer_sample])
        shuffled = self.rng.permutation(candidates)[
            : num_negatives * first_sampling_multiplying_factor
        ]
        return np.stack(
            [
                self.get_samples_per_click(session, shuffled, num_negatives)
                for session in batch_clicked_items
            ]
        )

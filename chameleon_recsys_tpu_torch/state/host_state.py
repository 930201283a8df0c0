"""Host-side streaming state: co-occurrence matrix and cold-start tracking.

The dense/ragged pieces of the reference's ``ClickedItemsState`` that only
feed the classical baselines and cold-start analysis stay on the host (they
are sparse, data-dependent structures with no place on the MXU):

  * item co-occurrence csr matrix (clicked_items_state.py:252-256);
  * first-click step tracking (clicked_items_state.py:196-203);
  * per-benchmark opaque state dicts (clicked_items_state.py:36).

The hot state (buffer, popularity) lives on device in ``StreamState``; a
``HostState`` snapshot mirror of those arrays is refreshed lazily only when a
benchmark or metric needs it.

The port's copy of ``chameleon_recsys_tpu/state/host_state.py``,
unchanged but for this note: the port imports nothing of the JAX package.
"""
from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional

import numpy as np
from scipy.sparse import csr_matrix


class HostState:
    def __init__(self, num_items: int):
        self.num_items = num_items
        # guards the pending-pair flush: the benchmark tier reads the
        # matrix from a thread pool, and a read now materializes
        self._cooc_lock = threading.Lock()
        self.reset()

    def reset(self):
        self._cooc = csr_matrix(
            (self.num_items, self.num_items), dtype=np.int64
        )
        self._pending_pairs: List[np.ndarray] = []  # [2, n] row/col stacks
        self.benchmarks_states: Dict[str, object] = {}
        self.items_first_click_step: Dict[int, int] = {}
        self.current_step = 0
        self._checkpoint = None

    # -- co-occurrence ------------------------------------------------------
    @property
    def items_coocurrences(self) -> csr_matrix:
        """Materialized co-occurrence matrix.

        Updates accumulate in a pending COO buffer and fold in here on
        read: a csr ``A + delta`` costs O(nnz(A)) — re-paying it on every
        TRAIN batch made the host tier quadratic over a long stream, while
        no baseline reads the matrix between evals.  Readers (baseline
        ``predict``, checkpointing) always see every prior ``update``.
        """
        with self._cooc_lock:
            if self._pending_pairs:
                pairs = np.concatenate(self._pending_pairs, axis=1)
                self._pending_pairs = []
                delta = csr_matrix(
                    (np.ones(pairs.shape[1], dtype=np.int64),
                     (pairs[0], pairs[1])),
                    shape=(self.num_items, self.num_items),
                )
                self._cooc = self._cooc + delta
            return self._cooc

    @items_coocurrences.setter
    def items_coocurrences(self, value: csr_matrix):
        self._cooc = value
        self._pending_pairs = []

    def update_items_coocurrences(self, batch_clicked_items: np.ndarray):
        """Counts within-session ordered pairs (clicked_items_state.py:252-256).

        Vectorized: position pairs (t1 != t2) of valid clicks over the whole
        [B, T] batch at once — output-identical to the reference's per-session
        ``itertools.permutations`` loop (csr summation is order-independent
        and repeated item values pair by position in both)."""
        items = np.ascontiguousarray(batch_clicked_items)
        valid = items != 0
        if not valid.any():
            return
        b, t = items.shape
        pair_valid = valid[:, :, None] & valid[:, None, :]
        pair_valid &= ~np.eye(t, dtype=bool)
        rows = np.broadcast_to(items[:, :, None], (b, t, t))[pair_valid]
        cols = np.broadcast_to(items[:, None, :], (b, t, t))[pair_valid]
        if rows.size:
            with self._cooc_lock:
                self._pending_pairs.append(np.stack([rows, cols]))

    # -- cold-start tracking ------------------------------------------------
    def increment_current_step(self):
        self.current_step += 1

    def update_items_first_click_step(self, batch_clicked_items):
        item_set = set(np.asarray(batch_clicked_items).reshape(-1).tolist())
        item_set.discard(0)
        for item_id in item_set:
            if item_id not in self.items_first_click_step:
                self.items_first_click_step[item_id] = self.current_step

    # -- checkpoint around eval (clicked_items_state.py:49-79) --------------
    def save_state_checkpoint(self):
        self._checkpoint = dict(
            items_coocurrences=self.items_coocurrences.copy(),
            benchmarks_states=copy.deepcopy(self.benchmarks_states),
            items_first_click_step=dict(self.items_first_click_step),
            current_step=self.current_step,
        )

    def restore_state_checkpoint(self):
        if self._checkpoint is None:
            raise RuntimeError("no host-state checkpoint saved")
        self.items_coocurrences = self._checkpoint["items_coocurrences"]
        self.benchmarks_states = self._checkpoint["benchmarks_states"]
        self.items_first_click_step = self._checkpoint["items_first_click_step"]
        self.current_step = self._checkpoint["current_step"]
        self._checkpoint = None

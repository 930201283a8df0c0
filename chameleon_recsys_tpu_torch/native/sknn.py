"""ctypes bindings for the native SkNN batch predictor (``sknn.cc``).

The port's copy of ``chameleon_recsys_tpu/native/sknn.py``: the same C ABI
(``sknn_predict_batch``) and the same Python surface (``native_available``,
``build_error``, ``predict_batch``), built from the port's own ``sknn.cc``
by ``native/build.py`` into the package's ``_build/``.  Where no library can
be built (no compiler), ``baselines/session_knn.py`` falls through to its
numpy row loop, which is bit-equal and stays the test oracle.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .build import NativeLibrary

SIMILARITY_CODES = {"cosine": 0, "jaccard": 1}
DECAY_CODES = {"same": 0, "div": 1, "linear": 2, "log": 3, "quadratic": 4}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sknn_predict_batch.restype = ctypes.c_int
    lib.sknn_predict_batch.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64, i64p,            # vote table
        i64p, i64p, ctypes.c_int64,                        # batch-item CSR
        i64p, ctypes.c_int64, ctypes.c_int64,              # item_idx, B, T
        i64p, ctypes.c_int64,                              # valid, V
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,    # K, nn, topk
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,    # sim, decay, nt
        i64p,                                              # out
    ]
    return lib


LIBRARY = NativeLibrary("sknn", ("pthread",), _bind)


def native_available() -> bool:
    """Whether the predictor is built and loaded (building it at the first
    call)."""
    return LIBRARY.get() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    return LIBRARY.error


def _i64(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr), np.int64)


def predict_batch(
    vote_table,
    item_arrs,
    sessions_items,
    valid_items,
    *,
    sample_size: int,
    nearest_neighbors: int,
    topk: int,
    similarity: str,
    decay: str,
    n_threads: int = 0,
) -> np.ndarray:
    """Run the native predictor -> int64 [B, T, topk].

    ``vote_table`` is session_knn's global (sids, starts, lens, items);
    ``item_arrs`` maps every distinct nonzero batch item to its sorted
    session-id array (the inverted-index slice).
    """
    lib = LIBRARY.get()
    if lib is None:
        raise RuntimeError(f"native sknn unavailable: {LIBRARY.error}")
    g_sids, g_starts, g_lens, g_items = (_i64(a) for a in vote_table)
    sessions_items = np.asarray(sessions_items)
    b, t = sessions_items.shape

    items_u = np.unique(sessions_items[sessions_items != 0]).astype(np.int64)
    arrs = [_i64(item_arrs(int(it))) for it in items_u]
    bi_off = np.zeros(len(arrs) + 1, np.int64)
    if arrs:
        np.cumsum([len(a) for a in arrs], out=bi_off[1:])
        bi_sids = np.concatenate(arrs) if bi_off[-1] else np.empty(0, np.int64)
    else:
        bi_sids = np.empty(0, np.int64)

    si = _i64(sessions_items)
    idx = np.searchsorted(items_u, si)
    np.clip(idx, 0, max(len(items_u) - 1, 0), out=idx)
    item_idx = np.where(si == 0, -1, idx).astype(np.int64)

    valid = _i64(valid_items)
    if valid.shape[:2] != (b, t):
        raise ValueError(f"valid_items must be [{b}, {t}, V], got {valid.shape}")
    out = np.zeros((b, t, topk), np.int64)

    def p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    rc = lib.sknn_predict_batch(
        p(g_sids), p(g_starts), p(g_lens), ctypes.c_int64(len(g_sids)),
        p(g_items),
        p(bi_off), p(bi_sids), ctypes.c_int64(len(items_u)),
        p(item_idx), ctypes.c_int64(b), ctypes.c_int64(t),
        p(valid), ctypes.c_int64(valid.shape[2]),
        ctypes.c_int64(sample_size), ctypes.c_int64(nearest_neighbors),
        ctypes.c_int64(topk),
        ctypes.c_int32(SIMILARITY_CODES[similarity]),
        ctypes.c_int32(DECAY_CODES[decay]),
        ctypes.c_int32(n_threads),
        p(out),
    )
    if rc != 0:
        raise RuntimeError(f"sknn_predict_batch failed: rc={rc}")
    return out

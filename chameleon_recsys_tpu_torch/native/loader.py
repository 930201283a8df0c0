"""ctypes bindings for the native session loader (``chio.cc``).

The port's copy of ``chameleon_recsys_tpu/native/loader.py``: the C ABI
``chio_load_sessions`` / ``chio_session_count`` / ``chio_collate`` /
``chio_free`` over the port's own ``chio.cc`` (gzip through zlib, linked
with ``-lz``), built by ``native/build.py`` into the package's ``_build/``.
``NativeSessionLoader`` gives the batch dict of ``data/collate.py``'s
``batches_from_sessions`` over one per-hour TFRecord file, so the harness
takes it as an hour source (it has ``batches``).  A caller that asked for
it and finds no library stops (the trainer CLI exits); nothing here falls
back to the Python reader.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from ..config import TIME_UNIT_MS, SessionFeaturesSchema
from .build import NativeLibrary


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_i64, c_ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    names = ctypes.POINTER(ctypes.c_char_p)
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.chio_load_sessions.restype = c_ptr
    lib.chio_load_sessions.argtypes = [ctypes.c_char_p]
    lib.chio_session_count.restype = c_int
    lib.chio_session_count.argtypes = [c_ptr]
    lib.chio_collate.restype = c_int
    lib.chio_collate.argtypes = [
        c_ptr, c_int, c_int, c_int, c_i64, c_i64,          # handle .. time unit
        names, c_int, names, c_int,                        # feature names
        i64p, i32p, i32p, i32p, i32p, i32p,                # ctx .. int_seq
        ctypes.POINTER(ctypes.c_float),                    # float_seq
    ]
    lib.chio_free.restype = None
    lib.chio_free.argtypes = [c_ptr]
    return lib


LIBRARY = NativeLibrary("chio", ("z",), _bind)


def native_available() -> bool:
    """Whether the loader is built and loaded (building it at the first
    call)."""
    return LIBRARY.get() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    return LIBRARY.error


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeSessionLoader:
    """Loads one per-hour TFRecord file and yields padded batch dicts."""

    def __init__(self, path, schema: SessionFeaturesSchema, epoch_ms: int = 0):
        self.handle = None
        lib = LIBRARY.get()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {LIBRARY.error}")
        self.lib = lib
        self.schema = schema
        self.epoch_ms = epoch_ms
        handle = lib.chio_load_sessions(str(path).encode())
        if not handle:
            raise IOError(f"failed to load {path}")
        self.handle = ctypes.c_void_p(handle)

        ctx = schema.context_sequence_features()
        self.int_feats = [s.name for s in ctx if s.dtype != "float"]
        self.float_feats = [s.name for s in ctx if s.dtype == "float"]
        # kept referenced for the library's use during each collate
        self._int_names = (ctypes.c_char_p * len(self.int_feats))(
            *[n.encode() for n in self.int_feats])
        self._float_names = (ctypes.c_char_p * len(self.float_feats))(
            *[n.encode() for n in self.float_feats])

    def __len__(self) -> int:
        return self.lib.chio_session_count(self.handle)

    def batch(self, start: int, batch_size: int, max_session_length: int
              ) -> Dict[str, np.ndarray]:
        """Sessions [start, start + batch_size) collated as
        ``data.collate.collate_sessions`` does, the rows past the file's end
        empty (session_size 0)."""
        if self.handle is None:
            raise ValueError("the loader is closed")
        t = max_session_length - 1
        ctx = np.zeros((batch_size, 4), np.int64)
        clicks = np.zeros((batch_size, t), np.int32)
        labels = np.zeros((batch_size, t), np.int32)
        last = np.zeros((batch_size,), np.int32)
        ts = np.zeros((batch_size, t), np.int32)
        int_seq = np.zeros((len(self.int_feats), batch_size, t), np.int32)
        float_seq = np.zeros((len(self.float_feats), batch_size, t), np.float32)
        self.lib.chio_collate(
            self.handle, start, batch_size, max_session_length, self.epoch_ms,
            TIME_UNIT_MS, self._int_names, len(self.int_feats), self._float_names,
            len(self.float_feats), _ptr(ctx, ctypes.c_int64),
            _ptr(clicks, ctypes.c_int32), _ptr(labels, ctypes.c_int32),
            _ptr(last, ctypes.c_int32), _ptr(ts, ctypes.c_int32),
            _ptr(int_seq, ctypes.c_int32), _ptr(float_seq, ctypes.c_float),
        )
        batch = {
            "user_id": ctx[:, 0],
            "session_id": ctx[:, 1],
            "session_start": ctx[:, 2],
            "session_size": ctx[:, 3].astype(np.int32),
            "item_clicked": clicks,
            "label_next_item": labels,
            "label_last_item": last[:, None],
            "event_timestamp": ts,
        }
        for i, name in enumerate(self.int_feats):
            batch[name] = int_seq[i]
        for i, name in enumerate(self.float_feats):
            batch[name] = float_seq[i]
        return batch

    def batches(self, batch_size: int, max_session_length: int):
        for start in range(0, len(self), batch_size):
            yield self.batch(start, batch_size, max_session_length)

    def close(self) -> None:
        if self.handle is not None:
            self.lib.chio_free(self.handle)
            self.handle = None

    def __del__(self):
        self.close()

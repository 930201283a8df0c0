"""Pieces the drivers share."""
from __future__ import annotations

import contextlib
import gc
import importlib
from typing import Dict, List

import numpy as np
import torch

from .. import system, traffic


def reference_module(config: dict):
    """The plain reference the configuration names (``reference/<name>.py``)."""
    return importlib.import_module(f"reference.{config['reference']}")


def seeds(seed: int):
    """(weights, sampler) seeds derived from the run's seed."""
    a, b = np.random.SeedSequence([int(seed), 7]).generate_state(2, np.uint64)
    return int(a) >> 1, int(b) >> 1


@contextlib.contextmanager
def no_gc():
    """Python's cycle collector off while set-up makes the sessions: many
    small objects and no cycles, which it would scan again and again."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def hour_objects(s: traffic.Sessions) -> list:
    """An hour of sessions as the system's ``Session`` objects, which the
    harness collates into batches inside its hour."""
    return system.to_sessions(traffic.serving_sessions(s))


def shift(sessions: list, seconds: int) -> None:
    """Move ``sessions`` ``seconds`` later in time, in place: each gets new
    click-time lists, so the dicts they were made from keep their times."""
    for s in sessions:
        s.timestamps = [t + seconds for t in s.timestamps]
        s.session_start += seconds


def batch_lengths(lengths: np.ndarray, batch_size: int) -> List[np.ndarray]:
    """The session lengths of each batch the harness cuts an hour into."""
    return [lengths[i:i + batch_size] for i in range(0, len(lengths), batch_size)]


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def ref_inputs(ref, model, corpus, hist, device):
    """The reference's static inputs and its own click stream after the
    history hour."""
    stream = ref.fold_clicks(model, ref.empty_stream(model, device),
                             *(torch.as_tensor(x, device=device)
                               for x in traffic.history_clicks(hist)))
    inp = ref.Inputs(torch.as_tensor(corpus.ace, device=device),
                     {k: torch.as_tensor(v, device=device) for k, v in corpus.metadata.items()},
                     stream.buffer_ids, stream.pop_norm)
    return inp, stream


def with_stream(ref, inp, stream):
    return ref.Inputs(inp.ace, inp.metadata, stream.buffer_ids, stream.pop_norm)

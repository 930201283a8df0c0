"""The recommend call's scoring as one CUDA graph per request shape.

``NARServer._score`` (the model's forward, the ``-inf`` mask of padded
candidates, the top-k and the gather) launches ~500 small operations a
call, one at a time from Python.  On a CUDA device ``ScoreGraphs`` keys a
call by what the request shows, (sessions B, candidates C, top_k):

  * a key's first call runs eagerly on the side stream the capture uses,
    which is the warm-up that ``torch.cuda.graph`` asks for (the libraries'
    lazy set-up, the UGRNN kernel's layout for B);
  * its second call captures ``_score`` as a graph and replays it once for
    its answer (the span ``nar.serve.capture``);
  * every later call copies the request into the graph's buffers and
    replays it (``nar.serve.replay``).

A graph reads fixed device buffers: the collated request and candidates of
the call that captured it, into which later requests are copied from the
host, and its own copies of the two streaming-state tensors the model
reads (``recent_pop_norm``, ``buffer_ids``), into which the live stream is
copied before every replay, since ``observe`` replaces the stream's
tensors.  The parameters, the ACE matrix and the metadata are the server's
and do not move (``load_state_dict`` copies in place).  The outputs are the
graph's own ``ids`` and ``scores``; the caller copies them to the host
before the next replay of any graph, because all graphs share one memory
pool.  The rule of warm-up, capture and replay, the pool, the capacity
and the launch counts are ``graphs.py``'s, which the eval step's graphs
share.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .graphs import GraphCache
from .utils.profiling import span

Key = Tuple[int, int, int]  # (sessions, candidates, top_k)


class ScoreGraph:
    """One captured scoring call: its input buffers, its copies of the
    stream, and the graph with its outputs."""

    def __init__(self, score: Callable, batch: Dict[str, torch.Tensor],
                 candidates: torch.Tensor, top_k: int, stream, cache: GraphCache):
        self.batch, self.candidates = batch, candidates
        self.recent_pop_norm = stream.recent_pop_norm.clone()
        self.buffer_ids = stream.buffer_ids.clone()
        self.captured = cache.capture(lambda: score(batch, candidates, top_k,
                                                    self.recent_pop_norm, self.buffer_ids))

    def load(self, batch: Dict[str, np.ndarray], candidates: np.ndarray) -> None:
        """Copy a collated request from the host into the graph's buffers."""
        for name, values in batch.items():
            self.batch[name].copy_(torch.from_numpy(values))
        self.candidates.copy_(torch.from_numpy(candidates))

    def replay(self, stream, count: bool = True):
        """The top-k (ids, scores) of the request last loaded, on ``stream``."""
        self.recent_pop_norm.copy_(stream.recent_pop_norm)
        self.buffer_ids.copy_(stream.buffer_ids)
        return self.captured.replay(count)


class ScoreGraphs(GraphCache):
    """The graphs of one server, by request shape."""

    def __init__(self, score: Callable):
        super().__init__()
        self.score = score

    def score_unheld(self, key: Key, batch, candidates, top_k: int, stream):
        """A call whose key holds no graph: eager on the side stream the
        first time, captured (and replayed once) the second."""
        if self.first_sighting(key):
            return self.warm_up(lambda: self.score(batch, candidates, top_k,
                                                   stream.recent_pop_norm,
                                                   stream.buffer_ids))
        with span("nar.serve.capture"):
            graph = self.hold(key, lambda: ScoreGraph(self.score, batch, candidates,
                                                      top_k, stream, self))
            return graph.replay(stream, count=False)  # the capture counted

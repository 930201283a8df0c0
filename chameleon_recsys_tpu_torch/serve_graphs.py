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
pool.  At most ``capacity`` keys hold a graph; a new capture evicts the
least recently replayed, and a shape seen once never costs a capture.

The hand-written kernels count their launches where Python launches them
(``ops/kernels``), which a replay does not pass; a replay adds the counts
its capture made, so ``launch_counts()`` keeps counting device launches.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .ops.kernels import cand_scorer, ugrnn
from .utils.profiling import span

Key = Tuple[int, int, int]  # (sessions, candidates, top_k)
_COUNTING = (cand_scorer, ugrnn)  # the modules whose globals count launches


def _launch_counters() -> Dict[Tuple[object, str], int]:
    return {(module, name): value for module in _COUNTING
            for name, value in vars(module).items()
            if name.endswith("launches") and isinstance(value, int)}


class ScoreGraph:
    """One captured scoring call: its input buffers, its copies of the
    stream, its outputs and the kernel launches its capture counted."""

    def __init__(self, score: Callable, batch: Dict[str, torch.Tensor],
                 candidates: torch.Tensor, top_k: int, stream, pool,
                 capture_stream: torch.cuda.Stream):
        self.batch, self.candidates = batch, candidates
        self.recent_pop_norm = stream.recent_pop_norm.clone()
        self.buffer_ids = stream.buffer_ids.clone()
        before = _launch_counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=capture_stream):
            self.ids, self.scores = score(batch, candidates, top_k,
                                          self.recent_pop_norm, self.buffer_ids)
        self.launches = {k: n - before.get(k, 0)
                         for k, n in _launch_counters().items() if n != before.get(k, 0)}

    def load(self, batch: Dict[str, np.ndarray], candidates: np.ndarray) -> None:
        """Copy a collated request from the host into the graph's buffers."""
        for name, values in batch.items():
            self.batch[name].copy_(torch.from_numpy(values))
        self.candidates.copy_(torch.from_numpy(candidates))

    def replay(self, stream, count: bool = True):
        """The top-k (ids, scores) of the request last loaded, on ``stream``."""
        self.recent_pop_norm.copy_(stream.recent_pop_norm)
        self.buffer_ids.copy_(stream.buffer_ids)
        self.graph.replay()
        if count:
            for (module, name), n in self.launches.items():
                setattr(module, name, getattr(module, name) + n)
        return self.ids, self.scores


class ScoreGraphs:
    """The graphs of one server, by request shape (least recently replayed
    first), and the keys seen once since they last held a graph."""

    capacity = 8  # keys that hold a graph
    remembered = 64  # keys seen once that are remembered

    def __init__(self, score: Callable):
        self.score = score
        self.graphs: "collections.OrderedDict[Key, ScoreGraph]" = collections.OrderedDict()
        self.seen: "collections.OrderedDict[Key, None]" = collections.OrderedDict()
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream()

    def get(self, key: Key):
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
        return graph

    def score_unheld(self, key: Key, batch, candidates, top_k: int, stream):
        """A call whose key holds no graph: eager on the side stream the
        first time, captured (and replayed once) the second."""
        if key not in self.seen:
            self.seen[key] = None
            if len(self.seen) > self.remembered:
                self.seen.popitem(last=False)
            main = torch.cuda.current_stream()
            self.side.wait_stream(main)
            with torch.cuda.stream(self.side):
                out = self.score(batch, candidates, top_k, stream.recent_pop_norm,
                                 stream.buffer_ids)
            main.wait_stream(self.side)
            return out
        with span("nar.serve.capture"):
            del self.seen[key]
            if len(self.graphs) >= self.capacity:
                self.graphs.popitem(last=False)
            graph = ScoreGraph(self.score, batch, candidates, top_k, stream, self.pool,
                               self.side)
            self.graphs[key] = graph
            return graph.replay(stream, count=False)  # the capture counted

"""CUDA graphs keyed by what a call shows, for serving and the eval step.

``serve_graphs.py`` (the recommend call's scoring) and
``train/eval_graphs.py`` (the eval step) replay a call's device work as one
CUDA graph, and follow one rule, which ``GraphCache`` holds:

  * a key's first call runs eagerly on the side stream the captures use,
    which is the warm-up that ``torch.cuda.graph`` asks for (the libraries'
    lazy set-up, a kernel's first launch);
  * its second call captures the call as a graph (``capture``) and the
    cache holds it under the key (``hold``);
  * every later call replays it.

All graphs of one cache share one memory pool, so a graph's outputs are
valid until the next replay of any graph of the cache.  At most
``capacity`` keys hold a graph; a new capture evicts the least recently
replayed, and a key seen once never costs a capture.

The hand-written kernels count their launches where Python launches them
(``ops/kernels``), which a replay does not pass; a replay adds the counts
its capture made, so ``launch_counts()`` keeps counting device launches.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Hashable, Tuple

import torch

from .ops.kernels import cand_scorer, ugrnn

_COUNTING = (cand_scorer, ugrnn)  # the modules whose globals count launches


def _launch_counters() -> Dict[Tuple[object, str], int]:
    return {(module, name): value for module in _COUNTING
            for name, value in vars(module).items()
            if name.endswith("launches") and isinstance(value, int)}


class Captured:
    """``fn()``'s device work captured as one graph: its outputs (the
    graph's own tensors) and the kernel launches the capture counted."""

    def __init__(self, fn: Callable, pool, stream: torch.cuda.Stream):
        before = _launch_counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.outputs = fn()
        self.launches = {k: n - before.get(k, 0)
                         for k, n in _launch_counters().items() if n != before.get(k, 0)}

    def replay(self, count: bool = True):
        """Replay on the current stream; ``count`` adds the capture's
        launches (the first replay after a capture leaves it off: the
        capture counted them)."""
        self.graph.replay()
        if count:
            for (module, name), n in self.launches.items():
                setattr(module, name, getattr(module, name) + n)
        return self.outputs


class GraphCache:
    """The graphs of one caller by key (least recently replayed first), and
    the keys seen once since they last held a graph.  The pool and the side
    stream are made at the first warm-up or capture."""

    capacity = 8  # keys that hold a graph
    remembered = 64  # keys seen once that are remembered

    def __init__(self):
        self.graphs: "collections.OrderedDict[Hashable, object]" = collections.OrderedDict()
        self.seen: "collections.OrderedDict[Hashable, None]" = collections.OrderedDict()
        self._pool = self._side = None

    @property
    def side(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream()
        return self._side

    def get(self, key: Hashable):
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
        return graph

    def first_sighting(self, key: Hashable) -> bool:
        """Whether this call of ``key``, which holds no graph, is its first
        since it last held one (then the key is remembered)."""
        if key in self.seen:
            return False
        self.seen[key] = None
        if len(self.seen) > self.remembered:
            self.seen.popitem(last=False)
        return True

    def warm_up(self, fn: Callable):
        """``fn()`` run eagerly on the side stream, ordered after and before
        the current stream's work."""
        main = torch.cuda.current_stream()
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            out = fn()
        main.wait_stream(self.side)
        return out

    def capture(self, fn: Callable) -> Captured:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return Captured(fn, self._pool, self.side)

    def hold(self, key: Hashable, make: Callable):
        """Hold ``make()`` (which captures) under ``key``, first evicting
        the least recently replayed key when the cache is full."""
        self.seen.pop(key, None)
        if len(self.graphs) >= self.capacity:
            self.graphs.popitem(last=False)
        graph = self.graphs[key] = make()
        return graph

    def clear(self) -> None:
        self.graphs.clear()
        self.seen.clear()

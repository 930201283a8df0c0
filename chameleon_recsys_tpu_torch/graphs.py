"""CUDA graphs keyed by what a call shows, for serving and the train and
eval steps.

The recommend call's scoring (``serve.py``), the train step
(``train/train_graphs.py``) and the eval step (``train/eval_graphs.py``)
replay a call's device work as one CUDA graph.  ``GraphCache.run`` runs a
call under the rule they share:

  * a key's first call runs eagerly on the side stream the captures use,
    which is the warm-up that ``torch.cuda.graph`` asks for (the libraries'
    lazy set-up, a kernel's first launch);
  * its second call makes the graph's buffers, holding its inputs,
    captures the device work on them and replays it once for its answer
    (the span ``<spans>.capture``);
  * every later call loads its inputs into the buffers and replays the
    graph (``<spans>.replay``).

A caller describes the graph of a key by a ``Graph``, made at the key's
first call: which buffers the graph reads, how a call's inputs are loaded
into them, and what a replay returns.

All graphs of one cache share one memory pool, so a graph's outputs are
valid until the next replay of any graph of the cache; a capture into a
cache that holds no graph starts a new pool.  At most
``capacity`` keys hold a graph; a new capture evicts the least recently
replayed, and at most ``remembered`` keys seen once are remembered, so a
key seen once never costs a capture.

The hand-written kernels count their launches where Python launches them
(``ops/kernels``), which a replay does not pass; a replay adds the counts
its capture made, so ``launch_counts()`` keeps counting device launches.
"""
from __future__ import annotations

import collections
from typing import Callable, Hashable

import torch

from .ops.kernels import add_launch_counts, launch_counts
from .utils.profiling import span


class Graph:
    """A key's graph as its caller describes it.  ``call`` is what the
    caller passes to ``GraphCache.run`` besides the key and the graph.
    The capture sets ``replay`` (replays the graph on the current stream
    and returns its outputs) and ``launches`` (the counts it made)."""

    def eager(self, *call):
        """The call's answer, run eagerly on its own inputs."""
        raise NotImplementedError

    def buffers(self, *call) -> None:
        """Make the device buffers the graph reads, holding the call's inputs."""
        raise NotImplementedError

    def work(self):
        """The device work on the buffers, which the graph captures: its outputs."""
        raise NotImplementedError

    def load(self, *call) -> None:
        """Load a later call's inputs into the buffers."""
        raise NotImplementedError

    def returns(self, outputs, *call):
        """What a replay returns from the graph's outputs."""
        return outputs


class GraphCache:
    """The graphs of one caller by key (least recently replayed first), and
    the keys seen once since they last held a graph; ``spans`` prefixes the
    capture's and the replay's spans.  The pool and the side stream are
    made at the first warm-up or capture."""

    capacity = 8  # keys that hold a graph
    remembered = 64  # keys seen once that are remembered

    def __init__(self, spans: str):
        self.spans = spans
        self.graphs: "collections.OrderedDict[Hashable, Graph]" = collections.OrderedDict()
        self.seen: "collections.OrderedDict[Hashable, Graph]" = collections.OrderedDict()
        self._pool = self._side = None

    def graph(self, key: Hashable, make: Callable[[], Graph]) -> Graph:
        """``key``'s graph: the one it holds, the one made at its first
        call, or else ``make()``'s."""
        graph = self.graphs.get(key) or self.seen.get(key)
        return make() if graph is None else graph

    def run(self, key: Hashable, graph: Graph, *call):
        """A call of ``key`` under the rule, with ``key``'s ``graph``."""
        if key in self.graphs:
            self.graphs.move_to_end(key)
            with span(f"{self.spans}.replay"):
                graph.load(*call)
                outputs = graph.replay()
                add_launch_counts(graph.launches)
                return graph.returns(outputs, *call)
        if key not in self.seen:
            self.seen[key] = graph
            if len(self.seen) > self.remembered:
                self.seen.popitem(last=False)
            return self._warm_up(lambda: graph.eager(*call))
        with span(f"{self.spans}.capture"):
            del self.seen[key]
            if len(self.graphs) >= self.capacity:
                self.graphs.popitem(last=False)
            if not self.graphs:
                # a pool that no live graph shares takes no new capture while
                # tensors made in it live on (a dropped train graph's
                # gradients): the capture starts a pool of its own
                self._pool = None
            graph.buffers(*call)
            before = launch_counts()
            graph.replay = self._capture(graph.work)
            graph.launches = {name: n - before[name]
                              for name, n in launch_counts().items() if n != before[name]}
            self.graphs[key] = graph
            return graph.returns(graph.replay(), *call)  # the capture counted

    def clear(self) -> None:
        self.graphs.clear()
        self.seen.clear()

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream()
        return self._side

    def _warm_up(self, fn: Callable):
        """``fn()`` run eagerly on the side stream, ordered after and before
        the current stream's work."""
        main = torch.cuda.current_stream()
        side = self._side_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()
        main.wait_stream(side)
        return out

    def _capture(self, fn: Callable) -> Callable:
        """``fn()``'s device work captured as one graph on the side stream:
        a callable that replays it on the current stream and returns its
        outputs (the graph's own tensors)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph, pool=self._pool, stream=self._side_stream()):
            outputs = fn()

        def replay():
            cuda_graph.replay()
            return outputs

        return replay

"""The eval step as one CUDA graph per batch shape.

``eval_step`` launches ~720 small operations a G1 batch, one at a time from
Python: the grid sampler, the ranking forward (K2f, K1f), the in-graph
ranking metrics and the stream update.  On a CUDA device
``TemporalHarness.evaluate_hour`` hands its ``EvalGraphs`` to ``eval_step``
(from the main thread only: a capture needs the card to itself), which
keys a call by what it shows, the shapes of the collated batch and of the
stream, and runs it under ``graphs.py``'s rule: a key's first call runs
eagerly on the side stream, its second captures the step and replays it
once (the span ``nar.eval.capture``), and every later call replays it
(``nar.eval.replay``).  Collated batches are padded to ``batch_size`` x
``max_session_length``, so an hour holds one key.

A graph reads fixed device buffers:

  * its own copy of the batch, into which each call's batch is copied;
  * its own copy of the stream, into which the live stream is copied
    before every replay (the step returns a new stream each batch, and the
    hour's snapshot of the stream must stay as it is);
  * the sampler's uniforms, drawn from the caller's generator into the
    graph's buffers before every replay (``draw_eval_uniforms``): the
    draws the eager step makes, in its order, so the negatives and the
    generator's state after the hour are eager's;
  * the parameters, the ACE matrix and the metadata where they are, and
    the metric fold's normalised copy of the ACE matrix and its
    ItemCoverage bitmaps, which the step sets in place
    (``metrics/device.py``).  A graph holds their addresses, so the cache
    drops its graphs when the model or one of those tensors is another;
    the fold keeps its bitmaps from hour to hour, so one graph serves
    every hour.

The graph always computes the full ranking, as the eager step does;
``fetch_full_ranking`` picks which outputs a call returns.  Every tensor a
call returns is a copy made on the device of the graph's output, so a
caller may hold it across later replays.
"""
from __future__ import annotations

import itertools

from ..graphs import Graph, GraphCache
from ..metrics.device import SUMS
from ..state.stream_state import StreamState
from .steps import _eval_step, draw_eval_uniforms


class EvalGraph(Graph):
    """The eval step of one batch shape: from its capture, its copies of
    the batch and the stream and its uniforms.  A call is (stream, batch,
    generator, fetch_full_ranking)."""

    def __init__(self, model, ace_matrix, metadata, fold):
        self.model, self.ace_matrix, self.metadata, self.fold = model, ace_matrix, metadata, fold
        self.cfg = model.cfg

    def _step(self, stream, batch, generator, fetch_full_ranking, uniforms):
        return _eval_step(self.model, stream, batch, self.ace_matrix, self.metadata,
                          generator=generator, fetch_full_ranking=fetch_full_ranking,
                          uniforms=uniforms, fold=self.fold)

    def eager(self, stream, batch, generator, fetch_full_ranking):
        return self._step(stream, batch, generator, fetch_full_ranking, None)

    def buffers(self, stream, batch, generator, fetch_full_ranking) -> None:
        self.batch = {name: values.clone() for name, values in batch.items()}
        self.stream = StreamState(*(t.clone() for t in stream))
        self.uniforms = draw_eval_uniforms(self.cfg, batch, stream.buffer_ids.shape[0],
                                           generator)

    def work(self):
        return self._step(self.stream, self.batch, None, True, self.uniforms)

    def load(self, stream, batch, generator, fetch_full_ranking) -> None:
        for name, values in batch.items():
            self.batch[name].copy_(values)
        for mine, live in zip(self.stream, stream):
            mine.copy_(live)
        draw_eval_uniforms(self.cfg, batch, stream.buffer_ids.shape[0], generator,
                           out=self.uniforms)

    def returns(self, outputs, stream, batch, generator, fetch_full_ranking):
        """(stream', metrics, fetches) of the replay, copied."""
        new_stream, metrics, fetches = outputs
        own = {name: fetches[name].clone()
               for name in ("labels", "neg_items", "clicked_items")}
        if fetch_full_ranking:
            own["predicted_ids"] = fetches["predicted_ids"].clone()
            own["predicted_probs"] = fetches["predicted_probs"].clone()
        else:
            own["predicted_ids"] = (
                fetches["predicted_ids"][..., : self.cfg.metrics_top_n].clone())
        if SUMS in fetches:
            own[SUMS] = fetches[SUMS].clone()
        return (StreamState(*(t.clone() for t in new_stream)),
                {name: value.clone() for name, value in metrics.items()}, own)


def _addresses(model, ace_matrix, metadata, fold):
    """What a graph reads outside its own buffers, by address."""
    return (id(model), ace_matrix.data_ptr(),
            tuple((name, t.data_ptr()) for name, t in metadata.items()),
            tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                          model.buffers())),
            None if fold is None else (id(fold), fold.normalized(ace_matrix).data_ptr(),
                                       *(t.data_ptr() for t in fold.coverage)))


class EvalGraphs(GraphCache):
    """The eval step's graphs of one harness, by batch and stream shapes."""

    def __init__(self):
        super().__init__("nar.eval")
        self.reads = None

    def step(self, model, stream, batch, ace_matrix, metadata, *, generator,
             fetch_full_ranking: bool, fold=None):
        """``eval_step`` on the card: (stream', metrics, fetches)."""
        reads = _addresses(model, ace_matrix, metadata, fold)
        if reads != self.reads:
            self.clear()
            self.reads = reads
        key = (tuple((name, tuple(t.shape), t.dtype) for name, t in batch.items())
               + tuple(tuple(t.shape) for t in stream))
        graph = self.graph(key, lambda: EvalGraph(model, ace_matrix, metadata, fold))
        return self.run(key, graph, stream, batch, generator, fetch_full_ranking)

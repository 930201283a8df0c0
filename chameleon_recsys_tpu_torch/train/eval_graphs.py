"""The eval step as one CUDA graph per batch shape.

``eval_step`` launches ~720 small operations a G1 batch, one at a time from
Python: the grid sampler, the ranking forward (K2f, K1f), the in-graph
ranking metrics and the stream update.  On a CUDA device
``TemporalHarness.evaluate_hour`` hands its ``EvalGraphs`` to ``eval_step``
(from the main thread only: a capture needs the card to itself), which
keys a call by what it shows, the shapes of the collated batch and of the
stream, under ``graphs.py``'s rule: a key's first call runs eagerly on the
side stream, its second captures the step and replays it once (the span
``nar.eval.capture``), and every later call replays it
(``nar.eval.replay``).  Collated batches are padded to ``batch_size`` x
``max_session_length``, so an hour holds one key.

A graph reads fixed device buffers:

  * its own copy of the batch, into which each call's batch is copied;
  * its own copy of the stream, into which the live stream is copied
    before every replay (the step returns a new stream each batch, and the
    hour's snapshot of the stream must stay as it is), and so of the
    ItemCoverage bitmaps where the step folds the metric set
    (``metrics/device.py``);
  * the sampler's uniforms, drawn from the caller's generator into the
    graph's buffers before every replay (``draw_eval_uniforms``): the
    draws the eager step makes, in its order, so the negatives and the
    generator's state after the hour are eager's;
  * the parameters, the ACE matrix and the metadata where they are, and
    the metric fold's normalised copy of the ACE matrix.  A graph holds
    their addresses, so the cache drops its graphs when the model or one
    of those tensors is another.

The graph always computes the full ranking, as the eager step does;
``fetch_full_ranking`` picks which outputs a call returns.  Every tensor a
call returns is a copy made on the device of the graph's output, so a
caller may hold it across later replays.
"""
from __future__ import annotations

import itertools

from ..graphs import GraphCache
from ..metrics.device import COVERAGE, SUMS
from ..state.stream_state import StreamState
from ..utils.profiling import span
from .steps import _eval_step, draw_eval_uniforms


class EvalGraph:
    """One captured eval step: its copies of the batch, the stream and the
    coverage bitmaps, its uniforms, and the graph with its outputs."""

    def __init__(self, model, stream, batch, ace_matrix, metadata, generator,
                 cache: GraphCache, fold=None, coverage=None):
        self.cfg = model.cfg
        self.batch = {name: values.clone() for name, values in batch.items()}
        self.stream = StreamState(*(t.clone() for t in stream))
        self.coverage = None if coverage is None else tuple(t.clone() for t in coverage)
        self.uniforms = draw_eval_uniforms(self.cfg, batch, stream.buffer_ids.shape[0],
                                           generator)
        self.captured = cache.capture(lambda: _eval_step(
            model, self.stream, self.batch, ace_matrix, metadata, generator=None,
            fetch_full_ranking=True, uniforms=self.uniforms, fold=fold,
            coverage=self.coverage))
        self.captured.replay(count=False)  # the capture counted

    def replay(self, batch, stream, generator, coverage=None) -> None:
        for name, values in batch.items():
            self.batch[name].copy_(values)
        for mine, live in zip(self.stream, stream):
            mine.copy_(live)
        for mine, live in zip(self.coverage or (), coverage or ()):
            mine.copy_(live)
        draw_eval_uniforms(self.cfg, batch, stream.buffer_ids.shape[0], generator,
                           out=self.uniforms)
        self.captured.replay()

    def outputs(self, fetch_full_ranking: bool):
        """(stream', metrics, fetches) of the last replay, copied."""
        new_stream, metrics, fetches = self.captured.outputs
        own = {name: fetches[name].clone()
               for name in ("labels", "neg_items", "clicked_items")}
        if fetch_full_ranking:
            own["predicted_ids"] = fetches["predicted_ids"].clone()
            own["predicted_probs"] = fetches["predicted_probs"].clone()
        else:
            own["predicted_ids"] = (
                fetches["predicted_ids"][..., : self.cfg.metrics_top_n].clone())
        for name in (SUMS, *COVERAGE):
            if name in fetches:
                own[name] = fetches[name].clone()
        return (StreamState(*(t.clone() for t in new_stream)),
                {name: value.clone() for name, value in metrics.items()}, own)


def _addresses(model, ace_matrix, metadata, fold):
    """What a graph reads outside its own buffers, by address."""
    return (id(model), ace_matrix.data_ptr(),
            tuple((name, t.data_ptr()) for name, t in metadata.items()),
            tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                          model.buffers())),
            None if fold is None else (id(fold), fold.normalized(ace_matrix).data_ptr()))


class EvalGraphs(GraphCache):
    """The eval step's graphs of one harness, by batch and stream shapes."""

    def __init__(self):
        super().__init__()
        self.reads = None

    def step(self, model, stream, batch, ace_matrix, metadata, *, generator,
             fetch_full_ranking: bool, fold=None, coverage=None):
        """``eval_step`` on the card: (stream', metrics, fetches)."""
        reads = _addresses(model, ace_matrix, metadata, fold)
        if reads != self.reads:
            self.clear()
            self.reads = reads
        key = (tuple((name, tuple(t.shape), t.dtype) for name, t in batch.items())
               + tuple(tuple(t.shape) for t in stream)
               + (None if coverage is None else tuple(tuple(t.shape) for t in coverage),))
        graph = self.get(key)
        if graph is not None:
            with span("nar.eval.replay"):
                graph.replay(batch, stream, generator, coverage)
                return graph.outputs(fetch_full_ranking)
        if self.first_sighting(key):
            return self.warm_up(lambda: _eval_step(
                model, stream, batch, ace_matrix, metadata, generator=generator,
                fetch_full_ranking=fetch_full_ranking, uniforms=None, fold=fold,
                coverage=coverage))
        with span("nar.eval.capture"):
            graph = self.hold(key, lambda: EvalGraph(model, stream, batch, ace_matrix,
                                                     metadata, generator, self, fold,
                                                     coverage))
            return graph.outputs(fetch_full_ranking)

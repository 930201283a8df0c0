"""The train step as one CUDA graph per batch shape.

``train_step`` launches ~1,200 device operations a G1 batch, one at a time
from Python: the compaction and the sampler, the forward (K2f, K1fs), the
loss, the backward (K1b, K2b, the embedding backward), the zero-gradient
fill, Adam and the stream update.  On a CUDA device
``TemporalHarness.train_hour`` hands its ``TrainGraphs`` to ``train_step``
(from the main thread only: a capture needs the card to itself), which
keys a call by what it shows, the shapes of the collated batch and of the
stream, and runs it under ``graphs.py``'s rule: a key's first call runs
eagerly on the side stream, its second captures the step and replays it
once (the span ``nar.train_step.capture``), and every later call replays it
(``nar.train_step.replay``).  Collated batches are padded to
``batch_size`` x ``max_session_length``, so an hour holds one key.

The cache takes a step only where a replay does what the eager step does:
on a CUDA device, with no draws inside the step (at ``keep_prob`` < 1 the
model draws its dropout masks from the generator) and no Python hooks on
the model (a replay runs none).  Every other step runs eagerly.

A graph reads fixed device buffers:

  * its own copy of the batch, into which each call's batch is copied;
  * its own copy of the stream, into which the live stream is copied
    before every replay;
  * the sampler's uniforms, drawn from the caller's generator into the
    graph's buffers before every replay (``draw_train_uniforms``): the
    draws the eager step makes, in its order, so the negatives and the
    generator's state after the hour are eager's;
  * the parameters, which Adam updates in place, Adam's moments and step
    counts (Adam is capturable on the card, ``init_train_state``), the ACE
    matrix and the metadata where they are.  A graph holds their
    addresses, so the cache drops its graphs when the model, the optimizer
    or one of those tensors is another (``load_checkpoint`` replaces Adam's
    state).

The gradients are the graph's own: the captured step sets them to None
and the backward makes them in the graph's pool, so they keep their
addresses across replays; a replay points the parameters' ``.grad`` at
them again where an eager step in between made others.  The new stream
and the metrics a call returns are copies made on the device of the
graph's outputs, so a caller may hold them across later replays.
"""
from __future__ import annotations

import itertools

import torch

from ..graphs import Graph, GraphCache
from ..state.stream_state import StreamState
from .steps import _train_step, draw_train_uniforms


def hooked(model: torch.nn.Module) -> bool:
    """Whether Python hooks run inside ``model``'s forward or backward:
    its modules' own, the global module hooks, or its parameters'."""
    module = torch.nn.modules.module
    if (module._global_forward_hooks or module._global_forward_pre_hooks
            or module._global_backward_hooks or module._global_backward_pre_hooks):
        return True
    return (any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
                or m._backward_pre_hooks for m in model.modules())
            or any(p._backward_hooks or getattr(p, "_post_accumulate_grad_hooks", None)
                   for p in model.parameters()))


def replayable(model) -> bool:
    """Whether a replay of ``model``'s train step does what the eager step
    does: no dropout masks drawn inside it, no Python hooks run."""
    return model.cfg.keep_prob >= 1.0 and not hooked(model)


class TrainGraph(Graph):
    """The train step of one batch shape: from its capture, its copies of
    the batch and the stream, its uniforms and its gradients.  A call is
    (stream, batch, generator)."""

    def __init__(self, model, optimizer, ace_matrix, metadata):
        self.model, self.optimizer = model, optimizer
        self.ace_matrix, self.metadata = ace_matrix, metadata
        self.cfg = model.cfg

    def _step(self, stream, batch, generator, uniforms):
        return _train_step(self.model, self.optimizer, stream, batch, self.ace_matrix,
                           self.metadata, generator=generator, uniforms=uniforms)

    def eager(self, stream, batch, generator):
        return self._step(stream, batch, generator, None)

    def buffers(self, stream, batch, generator) -> None:
        self.batch = {name: values.clone() for name, values in batch.items()}
        self.stream = StreamState(*(t.clone() for t in stream))
        self.uniforms = draw_train_uniforms(self.cfg, batch, stream.buffer_ids.shape[0],
                                            generator)

    def work(self):
        outputs = self._step(self.stream, self.batch, None, self.uniforms)
        self.grads = [p.grad for p in self.model.parameters()]
        return outputs

    def load(self, stream, batch, generator) -> None:
        for name, values in batch.items():
            self.batch[name].copy_(values)
        for mine, live in zip(self.stream, stream):
            mine.copy_(live)
        draw_train_uniforms(self.cfg, batch, stream.buffer_ids.shape[0], generator,
                            out=self.uniforms)

    def returns(self, outputs, stream, batch, generator):
        """(stream', metrics) of the replay, copied; the parameters'
        ``.grad`` the graph's gradients."""
        for p, grad in zip(self.model.parameters(), self.grads):
            if p.grad is not grad:
                p.grad = grad
        new_stream, metrics = outputs
        return (StreamState(*(t.clone() for t in new_stream)),
                {name: value.clone() for name, value in metrics.items()})


def _addresses(model, optimizer, ace_matrix, metadata):
    """What a graph reads outside its own buffers, by address."""
    params = list(model.parameters())
    return (id(model), id(optimizer), ace_matrix.data_ptr(),
            tuple((name, t.data_ptr()) for name, t in metadata.items()),
            tuple(t.data_ptr() for t in itertools.chain(params, model.buffers())),
            tuple(tuple(t.data_ptr() for t in optimizer.state[p].values()
                        if isinstance(t, torch.Tensor))
                  for p in params if p in optimizer.state))


class TrainGraphs(GraphCache):
    """The train step's graphs of one harness, by batch and stream shapes."""

    def __init__(self):
        super().__init__("nar.train_step")
        self.reads = None

    def takes(self, model, batch) -> bool:
        """Whether the step of ``model`` on ``batch`` runs under the cache."""
        return batch["item_clicked"].is_cuda and replayable(model)

    def step(self, state, batch, ace_matrix, metadata):
        """``train_step`` on the card: (stream', metrics)."""
        model, optimizer = state.model, state.optimizer
        reads = _addresses(model, optimizer, ace_matrix, metadata)
        if reads != self.reads:
            self.clear()
            self.reads = reads
        key = (tuple((name, tuple(t.shape), t.dtype) for name, t in batch.items())
               + tuple(tuple(t.shape) for t in state.stream))
        graph = self.graph(key, lambda: TrainGraph(model, optimizer, ace_matrix, metadata))
        warming_up = key not in self.graphs and key not in self.seen
        out = self.run(key, graph, state.stream, batch, state.generator)
        if warming_up:  # a first step makes Adam's moments where it has none
            self.reads = _addresses(model, optimizer, ace_matrix, metadata)
        return out

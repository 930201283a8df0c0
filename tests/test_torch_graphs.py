"""The rule the CUDA graphs of serving and of the eval step share
(``graphs.py::GraphCache.run``), and the eval graphs' in-place draws, on the
CPU: which call of a key warms up, which captures and which replays, that
a capture and its first replay count the launches once, which key a full
cache evicts, and that draws into given buffers are ``torch.rand``'s.  A
fake warm-up and a fake capture stand in for the card's."""
import pytest
import torch

from chameleon_recsys_tpu_torch.graphs import Graph, GraphCache
from chameleon_recsys_tpu_torch.ops import kernels
from chameleon_recsys_tpu_torch.ops.kernels import ugrnn
from chameleon_recsys_tpu_torch.ops.sampling import draw_uniforms
from chameleon_recsys_tpu_torch.utils import profiling


class _Cache(GraphCache):
    """The rule without a card: a warm-up runs the call as it is; a capture
    runs the work once, and its replay gives that run's outputs."""

    def __init__(self, log):
        super().__init__("test")
        self.log = log

    def _warm_up(self, fn):
        self.log.append("warm_up")
        return fn()

    def _capture(self, fn):
        self.log.append("capture")
        outputs = fn()

        def replay():
            self.log.append("replay")
            return outputs

        return replay


class _Graph(Graph):
    """A call is one number; the work launches one UGRNN forward."""

    def __init__(self, key, log):
        self.key, self.log = key, log

    def eager(self, x):
        ugrnn.launches += 1
        return ("eager", self.key, x)

    def buffers(self, x):
        self.log.append(("buffers", x))
        self.x = [x]

    def work(self):
        ugrnn.launches += 1
        return self.x

    def load(self, x):
        self.log.append(("load", x))
        self.x[0] = x

    def returns(self, outputs, x):
        return ("graph", self.key, outputs[0])


def _call(cache, key, x=0):
    return cache.run(key, cache.graph(key, lambda: _Graph(key, cache.log)), x)


def test_a_key_warms_up_once_then_holds_its_graph(monkeypatch):
    monkeypatch.setattr(ugrnn, "launches", 0)
    cache = _Cache([])
    answers, launched = [], []
    was = profiling.set_tracing(True)
    saved = profiling.span_snapshot()
    profiling.reset_spans()
    try:
        for x in (1, 2, 3):
            before = kernels.launch_counts()["ugrnn_fwd"]
            answers.append(_call(cache, "a", x))
            launched.append(kernels.launch_counts()["ugrnn_fwd"] - before)
        spans = profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()
        profiling._spans.update({k: list(v) for k, v in saved.items()})
    assert spans["test.capture"][1] == spans["test.replay"][1] == 1
    assert answers == [("eager", "a", 1), ("graph", "a", 2), ("graph", "a", 3)]
    assert cache.log == ["warm_up", ("buffers", 2), "capture", "replay", ("load", 3),
                         "replay"]
    assert launched == [1, 1, 1]  # the capture counted; its first replay adds none
    assert list(cache.graphs) == ["a"] and not cache.seen
    assert cache.graph("a", None) is cache.graphs["a"]


def test_a_full_cache_evicts_the_least_recently_replayed_key(monkeypatch):
    monkeypatch.setattr(ugrnn, "launches", 0)
    cache = _Cache([])
    cache.capacity = 2
    for key in ("a", "a", "b", "b"):
        _call(cache, key)
    _call(cache, "a")  # replayed: now the most recent
    _call(cache, "c")
    _call(cache, "c")
    assert list(cache.graphs) == ["a", "c"]
    cache.log.clear()
    assert _call(cache, "b") == ("eager", "b", 0)  # evicted: warms up again
    assert cache.log == ["warm_up"]
    cache.clear()
    assert not cache.graphs and not cache.seen


def test_keys_seen_once_are_remembered_up_to_a_bound(monkeypatch):
    monkeypatch.setattr(ugrnn, "launches", 0)
    cache = _Cache([])
    cache.remembered = 3
    for key in range(4):
        _call(cache, key)
    assert list(cache.seen) == [1, 2, 3]
    cache.log.clear()
    _call(cache, 0)  # forgotten: a first sighting again
    _call(cache, 3)  # remembered: captured
    assert cache.log == ["warm_up", ("buffers", 0), "capture", "replay"]
    assert list(cache.seen) == [2, 0] and list(cache.graphs) == [3]


@pytest.mark.parametrize("rows", [None, 6])
def test_draws_into_given_buffers_are_torch_rands(rows):
    shape = dict(num_negatives=3, buffer_sample_size=5, mult=4, rows=rows)
    fresh_gen = torch.Generator().manual_seed(7)
    fresh = [draw_uniforms(fresh_gen, 4, 3, 16, **shape) for _ in range(2)]
    into_gen = torch.Generator().manual_seed(7)
    buffers = draw_uniforms(torch.Generator(), 4, 3, 16, **shape)
    for want in fresh:
        got = draw_uniforms(into_gen, 4, 3, 16, out=buffers, **shape)
        assert got is buffers
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert torch.equal(into_gen.get_state(), fresh_gen.get_state())
    with pytest.raises(ValueError, match="uniforms of shape"):
        draw_uniforms(into_gen, 5, 3, 16, out=buffers, **shape)

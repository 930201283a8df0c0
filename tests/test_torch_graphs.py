"""The rule the CUDA graphs of serving and of the eval step share
(``graphs.py::GraphCache``), and the eval graphs' in-place draws, on the
CPU: which call of a key warms up, which captures, which key a full cache
evicts, and that draws into given buffers are ``torch.rand``'s."""
import pytest
import torch

from chameleon_recsys_tpu_torch.graphs import GraphCache
from chameleon_recsys_tpu_torch.ops.sampling import draw_uniforms


def _made(log, key):
    def make():
        log.append(key)
        return f"graph {key}"
    return make


def test_a_key_warms_up_once_then_holds_its_graph():
    cache = GraphCache()
    assert cache.first_sighting("a")
    assert not cache.first_sighting("a")  # the second call captures
    log = []
    assert cache.hold("a", _made(log, "a")) == "graph a"
    assert log == ["a"] and not cache.seen
    assert cache.get("a") == "graph a" and cache.get("b") is None


def test_a_full_cache_evicts_the_least_recently_replayed_key():
    cache = GraphCache()
    cache.capacity = 2
    log = []
    for key in ("a", "b"):
        cache.first_sighting(key)
        cache.hold(key, _made(log, key))
    cache.get("a")  # replayed: now the most recent
    cache.first_sighting("c")
    cache.hold("c", _made(log, "c"))
    assert list(cache.graphs) == ["a", "c"]
    assert cache.first_sighting("b")  # evicted: warms up again
    cache.clear()
    assert not cache.graphs and not cache.seen


def test_keys_seen_once_are_remembered_up_to_a_bound():
    cache = GraphCache()
    cache.remembered = 3
    for key in range(4):
        assert cache.first_sighting(key)
    assert list(cache.seen) == [1, 2, 3]
    assert cache.first_sighting(0)  # forgotten: a first sighting again


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

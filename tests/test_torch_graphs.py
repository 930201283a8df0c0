"""The rule the CUDA graphs of serving and of the train and eval steps
share (``graphs.py::GraphCache.run``), the eval graphs' in-place draws and
the train graphs, on the CPU: which call of a key warms up, which captures
and which replays, that a capture and its first replay count the launches
once, which key a full cache evicts, that draws into given buffers are
``torch.rand``'s, that a train hour under the train graphs is the eager
hour, and which train steps the graphs take; likewise GRU4Rec's step
graphs.  A fake warm-up and a fake
capture stand in for the card's."""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import chameleon_recsys_tpu_torch as port
from chameleon_recsys_tpu_torch.baselines import gru4rec
from chameleon_recsys_tpu_torch.config import RunConfig
from chameleon_recsys_tpu_torch.data.synthetic import (
    make_synthetic_corpus,
    synthetic_hour_sessions,
)
from chameleon_recsys_tpu_torch.graphs import Graph, GraphCache
from chameleon_recsys_tpu_torch.ops import kernels
from chameleon_recsys_tpu_torch.ops.kernels import ugrnn
from chameleon_recsys_tpu_torch.ops.sampling import draw_uniforms
from chameleon_recsys_tpu_torch.train import steps, temporal
from chameleon_recsys_tpu_torch.train.train_graphs import TrainGraphs, replayable
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


# ---------------------------------------------------------------------------
# the train step's graphs (train/train_graphs.py), with a fake card
# ---------------------------------------------------------------------------

TRAIN_BATCHES = 5  # an hour: warm-up, capture, three replays


class _TrainGraphs(TrainGraphs):
    """The train graphs without a card: the cache takes what the card's
    would, but for the batch's device; a warm-up runs the step as it is; a
    capture runs nothing, and each replay runs the captured work on the
    graph's buffers, as the card's graph does."""

    def __init__(self):
        super().__init__()
        self.log = []

    def takes(self, model, batch):
        return replayable(model)

    def _warm_up(self, fn):
        self.log.append("warm_up")
        return fn()

    def _capture(self, fn):
        self.log.append("capture")

        def replay():
            self.log.append("replay")
            return fn()

        return replay


def _train_world(tmp_path, **overrides):
    """A maker of small harnesses on the CPU (the fused scorer's and the
    UGRNN's flags on: their plain twins here; a row capacity), each after
    one eager train hour unless asked otherwise, and a source of hours of
    ``TRAIN_BATCHES`` batches."""
    FeatureSpec = port.FeatureSpec
    article_schema = port.ArticleFeaturesSchema(features=(
        FeatureSpec("article_id", "categorical", 200),
        FeatureSpec("created_at_ts", "numerical", dtype="int"),
        FeatureSpec("category_id", "categorical", 12),
    ))
    session_schema = port.SessionFeaturesSchema(sequence=(
        FeatureSpec("event_timestamp", "numerical", dtype="int"),
        FeatureSpec("item_clicked", "categorical", 200),
        FeatureSpec("device", "categorical", 5),
        FeatureSpec("hour_sin", "numerical", dtype="float"),
    ))
    cfg = port.NARConfig(
        car_embedding_size=16, rnn_units=12, rnn_num_layers=2,
        matching_layer_sizes=(8, 8), negative_samples=4, negative_sample_from_buffer=20,
        recent_clicks_buffer_max_size=64, recent_clicks_for_normalization=32,
        batch_size=8, max_session_length=6, train_valid_row_capacity=24,
        use_pallas_scorer=True, use_pallas_rnn=True,
    )
    cfg = dataclasses.replace(cfg, **overrides)
    corpus = make_synthetic_corpus(article_schema, ace_dim=8)

    def harness(name, trained=True):
        h = temporal.TemporalHarness(
            cfg, RunConfig(model_dir=str(tmp_path / name), random_seed=5), session_schema,
            article_schema, corpus.ace_matrix, corpus.metadata, device="cpu")
        if trained:  # an eager hour: Adam has its moments
            h.train_hour(source(0))
        return h

    def source(hour):
        return synthetic_hour_sessions(corpus, session_schema, hour,
                                       TRAIN_BATCHES * cfg.batch_size, cfg.max_session_length)

    return harness, source


def _recorded_train_hour(harness, sessions, monkeypatch):
    """A train hour, with each step's returns: [(stream', metrics)]."""
    calls = []
    original = temporal.train_step

    def recording(*a, **k):
        state, metrics = original(*a, **k)
        calls.append((state.stream, metrics))
        return state, metrics

    monkeypatch.setattr(temporal, "train_step", recording)
    try:
        harness.train_hour(sessions)
    finally:
        monkeypatch.setattr(temporal, "train_step", original)
    return calls


@pytest.mark.parametrize("capacity", [24, None])
def test_a_graphed_train_hour_is_the_eager_hour(tmp_path, monkeypatch, capacity):
    """One train hour under the train graphs (a fake card) and one eager,
    from the same state and generator state: the same metrics and stream
    after every batch, the same parameters, Adam moments and gradients, the
    same generator state after the hour; the graph's draws are the eager
    step's (the uniforms drawn into its buffers); one capture for the hour's
    one key, and the phase spans only on its warm-up and capture."""
    harness, source = _train_world(tmp_path, train_valid_row_capacity=capacity)
    graphed, eager = harness("graphed"), harness("eager")
    assert graphed._train_graphs is None  # the card's: none on the CPU
    graphed._train_graphs = cache = _TrainGraphs()
    sessions = source(1)
    was = profiling.set_tracing(True)
    saved = profiling.span_snapshot()
    profiling.reset_spans()
    try:
        got = _recorded_train_hour(graphed, sessions, monkeypatch)
        spans = profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()
        profiling._spans.update({k: list(v) for k, v in saved.items()})
    want = _recorded_train_hour(eager, sessions, monkeypatch)
    assert cache.log == ["warm_up", "capture"] + ["replay"] * (TRAIN_BATCHES - 1)
    assert len(cache.graphs) == 1 and not cache.seen
    assert spans["nar.train_step"][1] == TRAIN_BATCHES
    assert spans["nar.train_step.capture"][1] == 1
    assert spans["nar.train_step.replay"][1] == TRAIN_BATCHES - 2
    assert len(got) == len(want) == TRAIN_BATCHES
    for i, ((stream_got, m_got), (stream_want, m_want)) in enumerate(zip(got, want)):
        assert list(m_got) == list(m_want)
        for name, value in m_want.items():
            assert torch.equal(m_got[name], value), (i, name)
        for name, value in stream_want._asdict().items():
            assert torch.equal(getattr(stream_got, name), value), (i, name)
    assert torch.equal(graphed.state.generator.get_state(), eager.state.generator.get_state())
    for (name, p), q in zip(graphed.state.model.named_parameters(),
                            eager.state.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(p.grad, q.grad), name
        for k, v in eager.state.optimizer.state[q].items():
            assert torch.equal(graphed.state.optimizer.state[p][k], v), (name, k)


def test_the_graphed_step_samples_the_eager_negatives(tmp_path, monkeypatch):
    """The uniforms a replay draws into its buffers are the eager step's:
    every step scores the same negatives."""
    harness, source = _train_world(tmp_path)
    graphed, eager = harness("graphed"), harness("eager")
    graphed._train_graphs = _TrainGraphs()
    negatives = []
    original = steps._train_inputs

    def recording(*a, **k):
        inputs = original(*a, **k)
        negatives.append(inputs.neg_ids.clone())
        return inputs

    monkeypatch.setattr(steps, "_train_inputs", recording)
    sessions = source(1)
    graphed.train_hour(sessions)
    got, negatives[:] = list(negatives), []
    eager.train_hour(sessions)
    assert len(got) == len(negatives) == TRAIN_BATCHES
    for i, (a, b) in enumerate(zip(got, negatives)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("case", ["main_thread", "worker_thread", "mesh", "hooked",
                                  "hooked_submodule", "dropout"])
def test_the_train_graphs_engage_only_where_a_replay_is_the_step(tmp_path, monkeypatch,
                                                                 case):
    """The cache takes a harness's train steps from the main thread, with
    no mesh, no Python hooks on the model and no dropout masks to draw;
    from a worker thread, under a mesh, with a hook (which then sees every
    step) or at keep_prob < 1 every step runs eagerly and the cache is left
    untouched."""
    harness, source = _train_world(tmp_path, keep_prob=0.5 if case == "dropout" else 1.0)
    h = harness(case)
    h._train_graphs = cache = _TrainGraphs()
    batches = [h._put_batch(b) for b in h._batches(source(1))]
    seen = []
    if case.startswith("hooked"):
        module = (h.state.model if case == "hooked"
                  else next(m for m in h.state.model.modules() if m is not h.state.model))
        module.register_forward_hook(lambda *a: seen.append(1))
    sharded = []
    if case == "mesh":
        class Sharded:
            def train_step(self, *a, **k):
                sharded.append(k)
                return temporal.train_step(*a, **k)

        h._sharded = Sharded()
    for batch in batches:
        if case == "worker_thread":
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                h.state, _ = pool.submit(h._train_step, batch).result()
        else:
            h.state, _ = h._train_step(batch)
    if case == "main_thread":
        assert cache.log == ["warm_up", "capture"] + ["replay"] * (TRAIN_BATCHES - 1)
        return
    assert not cache.log and not cache.graphs and not cache.seen
    if case.startswith("hooked"):
        assert len(seen) == TRAIN_BATCHES
    if case == "mesh":
        assert len(sharded) == TRAIN_BATCHES and all("graphs" not in k for k in sharded)


def test_train_graphs_recapture_for_another_optimizer_state(tmp_path):
    """A graph holds the addresses of Adam's moments: a checkpoint's load
    (which replaces them) drops the graphs, and the next steps warm up and
    capture anew.  A fresh harness's first step makes Adam's moments, at no
    second warm-up."""
    harness, source = _train_world(tmp_path)
    replayed = ["warm_up", "capture"] + ["replay"] * (TRAIN_BATCHES - 1)
    fresh = harness("fresh", trained=False)
    fresh._train_graphs = cache = _TrainGraphs()
    fresh.train_hour(source(1))
    assert cache.log == replayed

    h = harness("ckpt")
    path = h.save_checkpoint()
    h._train_graphs = cache = _TrainGraphs()
    h.train_hour(source(1))
    held = next(iter(cache.graphs.values()))
    cache.log.clear()
    h.load_checkpoint(path)
    h.train_hour(source(1))
    assert cache.log == replayed
    assert len(cache.graphs) == 1 and next(iter(cache.graphs.values())) is not held


def test_a_checkpoint_from_the_card_loads_with_the_live_adam(tmp_path):
    """A checkpoint written on the card carries Adam's ``capturable`` (its
    step counts on the card); a load keeps the live optimizer's, so the
    CPU's Adam, which cannot take a capturable step, trains on."""
    from chameleon_recsys_tpu_torch.utils.io import deserialize, serialize

    harness, source = _train_world(tmp_path)
    h = harness("card_file")
    assert h.state.optimizer.param_groups[0]["capturable"] is False
    path = h.save_checkpoint()
    payload = deserialize(path)
    for group in payload["optimizer"]["param_groups"]:
        group["capturable"] = True  # as the card writes it
    serialize(path, payload)
    h.load_checkpoint(path)
    assert h.state.optimizer.param_groups[0]["capturable"] is False
    assert h.train_hour(source(1))["steps"] == TRAIN_BATCHES


# ---------------------------------------------------------------------------
# GRU4Rec's step graphs (``baselines/gru4rec.py::StepGraphs``) on a fake card
# ---------------------------------------------------------------------------

GRU4REC_STEPS = 5  # warm-up, capture, three replays


class _StepGraphs(gru4rec.StepGraphs):
    """GRU4Rec's step graphs without a card: a warm-up runs the call as it
    is; a capture runs nothing, and each replay runs the captured work on
    the graph's buffers, as the card's graph does."""

    def __init__(self):
        super().__init__()
        self.log = []

    def _warm_up(self, fn):
        self.log.append("warm_up")
        return fn()

    def _capture(self, fn):
        self.log.append("capture")

        def replay():
            self.log.append("replay")
            return fn()

        return replay


def _gru4rec_batches(steps, b=6, t=5, n_items=120, seed=0):
    """[(items, labels, click buffer)]: padded [b, t] batches."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        items = rng.randint(1, n_items, size=(b, t))
        labels = rng.randint(1, n_items, size=(b, t))
        lengths = rng.randint(1, t + 1, size=b)
        pad = np.arange(t)[None, :] >= lengths[:, None]
        items[pad], labels[pad] = 0, 0
        out.append((items, labels, rng.randint(0, n_items, size=80)))
    return out


def _gru4rec(**kw):
    return gru4rec.GRU4Rec(120, layers=(10, 8), n_sample=7, seed=3, device="cpu", **kw)


def test_graphed_gru4rec_steps_are_the_eager_steps(monkeypatch):
    """GRU4Rec's steps under its step graphs (a fake card) and eagerly, from
    the same weights and generator: the same losses, each its own copy;
    the same negatives; the same parameters, gradients and accumulators
    after every step; one capture for the batches' one shape, the phase
    spans only on its warm-up, and a replay span for each later step."""
    graphed, eager = _gru4rec(), _gru4rec()
    assert graphed.graphs is None  # the card's: none on the CPU
    graphed.graphs = cache = _StepGraphs()
    draws = {True: [], False: []}  # by whether the graphed model drew them
    original = gru4rec._draw_negative_indices

    def drawing(n, k, generator):
        out = original(n, k, generator)
        draws[generator is graphed.generator].append(out)
        return out

    monkeypatch.setattr(gru4rec, "_draw_negative_indices", drawing)
    was = profiling.set_tracing(True)
    saved = profiling.span_snapshot()
    try:
        got, want = [], []
        for i, batch in enumerate(_gru4rec_batches(GRU4REC_STEPS)):
            if i < 2:  # the warm-up's spans, then the later steps'
                profiling.reset_spans()
            got.append(graphed.fit_batch(*batch))
            if i == 0:
                warm = profiling.span_snapshot()
            want.append(eager.fit_batch(*batch))
            for p, q in zip(graphed.params.parameters(), eager.params.parameters()):
                assert torch.equal(p, q), i
                assert torch.equal(p.grad, q.grad), i
                for k, v in eager.optimizer.state[q].items():
                    assert torch.equal(graphed.optimizer.state[p][k], v), (i, k)
        spans = profiling.span_snapshot()
    finally:
        profiling.set_tracing(was)
        profiling.reset_spans()
        profiling._spans.update({k: list(v) for k, v in saved.items()})
    assert cache.log == ["warm_up", "capture"] + ["replay"] * (GRU4REC_STEPS - 1)
    assert len(cache.graphs) == 1 and not cache.seen
    assert warm["gru4rec.forward"][1] == warm["gru4rec.backward"][1] == 1
    assert "gru4rec.step.replay" not in warm
    assert spans["gru4rec.step.capture"][1] == 1
    assert spans["gru4rec.step.replay"][1] == GRU4REC_STEPS - 2
    assert spans["gru4rec.update"][1] == 2 * (GRU4REC_STEPS - 1)
    assert len(draws[True]) == len(draws[False]) == GRU4REC_STEPS
    for a, b in zip(draws[True], draws[False]):
        assert torch.equal(a, b)
    assert len({x.data_ptr() for x in got}) == GRU4REC_STEPS
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["plain", "dropout", "loss_for_batch", "loss", "hook"])
def test_gru4rec_step_graphs_engage_only_where_a_replay_is_the_step(monkeypatch, case):
    """The step graphs take GRU4Rec's steps where a replay does what the
    eager step does; with dropout masks to draw, a replaced
    ``loss_for_batch`` or loss, or a hook on the parameters, which then
    sees every step, each step runs eagerly and the cache is left
    untouched."""
    model = _gru4rec(dropout_p_hidden=0.3 if case == "dropout" else 0.0)
    model.graphs = cache = _StepGraphs()
    seen = []
    if case == "loss_for_batch":
        def recording(*a):
            seen.append(1)
            return type(model).loss_for_batch(model, *a)

        model.loss_for_batch = recording
    if case == "loss":
        loss = gru4rec.LOSSES[model.loss_name]
        monkeypatch.setitem(gru4rec.LOSSES, model.loss_name,
                            lambda *a: seen.append(1) or loss(*a))
    if case == "hook":
        model.params.register_forward_hook(lambda *a: seen.append(1))
        model.params.wh[0].register_hook(lambda g: seen.append(1))
    for batch in _gru4rec_batches(GRU4REC_STEPS):
        model.fit_batch(*batch)
    if case == "plain":
        assert cache.log == ["warm_up", "capture"] + ["replay"] * (GRU4REC_STEPS - 1)
        return
    assert not cache.log and not cache.graphs and not cache.seen
    if case != "dropout":
        assert len(seen) == GRU4REC_STEPS


def test_gru4rec_step_graphs_recapture_for_other_parameters():
    """A graph holds the parameters' addresses: a model whose parameters
    are other tensors drops the graphs and warms up and captures anew."""
    model = _gru4rec()
    model.graphs = cache = _StepGraphs()
    batches = _gru4rec_batches(GRU4REC_STEPS)
    for batch in batches:
        model.fit_batch(*batch)
    held = next(iter(cache.graphs.values()))
    cache.log.clear()
    model.params.wh[0] = torch.nn.Parameter(model.params.wh[0].detach().clone())
    for batch in batches:
        model.fit_batch(*batch)
    assert cache.log == ["warm_up", "capture"] + ["replay"] * (GRU4REC_STEPS - 1)
    assert len(cache.graphs) == 1 and next(iter(cache.graphs.values())) is not held

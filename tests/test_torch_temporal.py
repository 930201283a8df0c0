"""The port's temporal harness against the JAX package's ``TemporalHarness``.

Both harnesses run the tiny configuration of ``tests/test_temporal.py``
(batch 8, sessions of up to 6 clicks, 12 sessions an hour, 150 items) with
the G1 trainer's six classical baselines (``default_benchmarks`` of each
package's ``cli/nar_trainer_gcom.py``) beside CHAMELEON, one training hour
per eval, over hours 1-3: train 1, eval 2, train 2, eval 3, train 3, and
write the per-step scalars and per-hour histograms.  Both
start from the stream with hour 0's clicks folded in: on an empty click
buffer the jitted JAX train step's novelty feature is ill-conditioned
(ROADMAP section 3; eager JAX and the port agree there, the jitted step
does not), and the eager JAX harness takes twice as long.  The JAX harness
is built once for the module; its initial params go to the port through
``params_from_flax``, and the port's step functions
(``train.temporal.train_step`` / ``eval_step``) are wrapped to inject the
sampler uniforms that the JAX steps draw from their ``state.rng``, the chain
of keys followed step by step (``tests/test_torch_train_step.py``,
``tests/test_torch_eval_step.py``).  The port runs on the CPU.

Tolerances: per-hour ``avg_ce_loss`` at rel 1e-5 (the train step's loss
tolerance; an hour is two steps); the eval rows' ``hitrate_at_n``,
``mrr_at_n`` and CHAMELEON columns at 1e-6 (f32 sums of the same values in
another order).  Two candidates whose JAX probabilities lie within 1e-5 of
each other are a near tie that the two frameworks may rank either way; the
test finds every ranked position where the two harnesses' recommendation
logs differ, requires each to be such a near tie, names them, and widens
the tolerance of the rank metrics by one label's share per swap.  The
baseline columns are bit-equal: they see the same negatives and the same
stream.  The scalar rows carry the same keys and steps, ``ce_loss`` at the
loss's tolerance; the histogram rows the same names under ``convert``'s
mapping.

The port's own checkpoint round trip and resume are bit-exact on the CPU.
"""
import contextlib
import csv
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.baselines import (
    RecentlyPopularRecommender as JaxRecentlyPopular,
    SequentialRulesRecommender as JaxSequentialRules,
)
from chameleon_recsys_tpu.cli.nar_trainer_gcom import (
    default_benchmarks as jax_default_benchmarks,
)
from chameleon_recsys_tpu.config import RunConfig as JaxRunConfig
from chameleon_recsys_tpu.data.collate import collate_sessions as jax_collate
from chameleon_recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from chameleon_recsys_tpu.data.synthetic import (
    make_synthetic_corpus,
    synthetic_hour_sessions,
)
from chameleon_recsys_tpu.state.stream_state import (
    update_stream_state as jax_update_stream_state,
)
from chameleon_recsys_tpu.train.steps import _batch_all_clicks as jax_batch_all_clicks
from chameleon_recsys_tpu.train.temporal import (
    BenchmarkSpec as JaxBenchmarkSpec,
    TemporalHarness as JaxTemporalHarness,
)
from chameleon_recsys_tpu.utils.io import deserialize as jax_deserialize

import chameleon_recsys_tpu_torch as port
from chameleon_recsys_tpu_torch.baselines import (
    RecentlyPopularRecommender,
    SequentialRulesRecommender,
)
from chameleon_recsys_tpu_torch.cli.nar_trainer_gcom import default_benchmarks
from chameleon_recsys_tpu_torch.config import RunConfig
from chameleon_recsys_tpu_torch.convert import (
    _flax_path,
    checkpoint_from_jax,
    params_from_flax,
    stream_from_numpy,
)
from chameleon_recsys_tpu_torch.data import synthetic as port_synthetic
from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
from chameleon_recsys_tpu_torch.parallel.mesh import MeshPlan
from chameleon_recsys_tpu_torch.train import steps, temporal
from chameleon_recsys_tpu_torch.train.temporal import BenchmarkSpec, TemporalHarness
from chameleon_recsys_tpu_torch.utils.io import deserialize, serialize

from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema
from test_torch_serve import port_article_schema, port_config, port_session_schema
from test_torch_train_step import jax_train_uniforms

NUM_ITEMS = 150
SESSIONS_PER_HOUR = 12
HOURS = range(1, 4)
SR_PARAMS = {"max_clicks_dist": 10, "dist_between_clicks_decay": "div"}
WALL_CLOCK = ("elapsed_s", "per_s")  # suffixes of the wall-clock counters
# the column suffixes of the G1 trainer's six baselines
BASELINES = ("_pop_recent", "_coocurrent", "_item_knn", "_v-sknn", "_cb", "_sr")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = tiny_nar_config(batch_size=8, max_session_length=6)
    art, sess = tiny_article_schema(NUM_ITEMS), tiny_session_schema(NUM_ITEMS)
    corpus = make_synthetic_corpus(art, ace_dim=8)
    pcfg, psess, part = port_config(cfg), port_session_schema(sess), port_article_schema(art)
    pcorpus = port_synthetic.make_synthetic_corpus(part, ace_dim=8)
    model_dir = tmp_path_factory.mktemp("model")
    return types.SimpleNamespace(
        cfg=cfg, art=art, sess=sess, corpus=corpus, pcfg=pcfg, psess=psess,
        part=part, pcorpus=pcorpus, model_dir=model_dir,
        jax_source=lambda h: synthetic_hour_sessions(
            corpus, sess, h, num_sessions=SESSIONS_PER_HOUR,
            max_session_length=cfg.max_session_length),
        port_source=lambda h: port_synthetic.synthetic_hour_sessions(
            pcorpus, psess, h, num_sessions=SESSIONS_PER_HOUR,
            max_session_length=cfg.max_session_length),
    )


def jax_harness(world, benchmarks=None, **kw):
    if benchmarks is None:
        benchmarks = [JaxBenchmarkSpec(JaxRecentlyPopular, {}),
                      JaxBenchmarkSpec(JaxSequentialRules, dict(SR_PARAMS))]
    return JaxTemporalHarness(
        world.cfg, JaxRunConfig(model_dir=str(world.model_dir / "jax"),
                                training_hours_for_each_eval=1),
        world.sess, world.art, world.corpus.ace_matrix, world.corpus.metadata,
        benchmarks=benchmarks, **kw,
    )


def port_harness(world, model_dir="port", benchmarks=None, **kw):
    if benchmarks is None:
        benchmarks = [BenchmarkSpec(RecentlyPopularRecommender, {}),
                      BenchmarkSpec(SequentialRulesRecommender, dict(SR_PARAMS))]
    return TemporalHarness(
        world.pcfg, RunConfig(model_dir=str(world.model_dir / model_dir),
                              training_hours_for_each_eval=1),
        world.psess, world.part, world.pcorpus.ace_matrix, world.pcorpus.metadata,
        benchmarks=benchmarks, device="cpu", **kw,
    )


def jax_eval_uniforms(cfg, raw_rng, b, buffer_size):
    """The uniforms ``eval_step_fn`` draws from ``state.rng``, and the
    state's next rng."""
    key = jax.random.wrap_key_data(raw_rng, impl=cfg.rng_impl)
    rng, step_rng = jax.random.split(key)
    rng_neg, _ = jax.random.split(step_rng)
    rng_buf, rng_pool, rng_u = jax.random.split(rng_neg, 3)
    l, m = cfg.max_session_length, cfg.eval_negative_sample_from_buffer
    nc = min(cfg.eval_negative_samples * cfg.neg_sampling_multiplying_factor,
             b * l + m)

    def uniform(r, shape):
        return torch.tensor(np.asarray(jax.random.uniform(r, shape)))

    uniforms = SamplerUniforms(
        buffer=uniform(rng_buf, (buffer_size,)),
        pool=uniform(rng_pool, (b * l + m,)),
        click=uniform(rng_u, (b, l, nc)),
    )
    return uniforms, jax.random.key_data(rng)


@contextlib.contextmanager
def jax_draws(world, raw_rng):
    """Within the block the port harness's steps draw the uniforms of the
    JAX steps that start from the raw key ``raw_rng``, step after step."""
    cfg, chain = world.cfg, {"rng": np.asarray(raw_rng).copy()}
    b, length = cfg.batch_size, cfg.max_session_length
    buffer_size = cfg.recent_clicks_buffer_max_size

    def train_step(state, batch, ace_matrix, metadata):
        uniforms, chain["rng"] = jax_train_uniforms(cfg, chain["rng"], None, b, length,
                                                    buffer_size)
        return steps.train_step(state, batch, ace_matrix, metadata, uniforms=uniforms)

    def eval_step(model, stream, batch, ace_matrix, metadata, **kw):
        uniforms, chain["rng"] = jax_eval_uniforms(cfg, chain["rng"], b, buffer_size)
        return steps.eval_step(model, stream, batch, ace_matrix, metadata,
                               uniforms=uniforms, **kw)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(temporal, "train_step", train_step)
        patch.setattr(temporal, "eval_step", eval_step)
        yield


def spy_train_hours(harness):
    stats = []
    original = harness.train_hour

    def train_hour(sessions):
        stats.append(original(sessions))
        return stats[-1]

    harness.train_hour = train_hour
    return stats


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def parity(world):
    """Both harnesses over hours 1-3 from the same weights, warm stream and
    draws; the JAX harness's checkpoint after it (the harness is reused by
    later tests, which restore it from that file)."""
    cfg = world.cfg
    np.testing.assert_array_equal(world.pcorpus.ace_matrix, world.corpus.ace_matrix)
    jax_h = jax_harness(world, jax_default_benchmarks(world.corpus.ace_matrix),
                        log_recommendations=True, save_scalars=True,
                        save_histograms=True)
    warm_hour = [jax_collate(world.jax_source(0)[i: i + cfg.batch_size], world.sess,
                             cfg.batch_size, cfg.max_session_length)
                 for i in range(0, SESSIONS_PER_HOUR, cfg.batch_size)]
    jax_h.init_from_batch(warm_hour[0])
    stream = jax_h.state.stream
    for batch in warm_hour:
        stream = jax_update_stream_state(stream, *jax_batch_all_clicks(batch), cfg)
    jax_h.state = jax_h.state._replace(stream=stream)
    warm = {k: np.asarray(v).copy() for k, v in stream._asdict().items()}
    rng0 = np.asarray(jax_h.state.rng).copy()
    params0 = numpy_tree(jax_h.state.params)
    jax_stats = spy_train_hours(jax_h)
    jax_rows = jax_h.run(world.jax_source, HOURS)
    jax_h.export_artifacts()
    jax_ckpt = jax_h.save_checkpoint(world.model_dir / "jax.pkl")

    port_h = port_harness(world, benchmarks=default_benchmarks(world.pcorpus.ace_matrix),
                          log_recommendations=True, save_scalars=True,
                          save_histograms=True)
    port_h.init_state()
    port_h.state.model.load_state_dict(params_from_flax(params0, port_h.state.model))
    port_h.state = port_h.state._replace(stream=stream_from_numpy(warm, device="cpu"))
    port_stats = spy_train_hours(port_h)
    with jax_draws(world, rng0):
        port_rows = port_h.run(world.port_source, HOURS)
    port_h.export_artifacts()
    return types.SimpleNamespace(
        jax_h=jax_h, port_h=port_h, jax_stats=jax_stats, port_stats=port_stats,
        jax_rows=jax_rows, port_rows=port_rows, jax_ckpt=jax_ckpt,
    )


def test_train_hours_match_jax(parity):
    assert len(parity.port_stats) == len(parity.jax_stats) == 3
    for port_s, jax_s in zip(parity.port_stats, parity.jax_stats):
        assert port_s["steps"] == jax_s["steps"]
        assert port_s["avg_ce_loss"] == pytest.approx(jax_s["avg_ce_loss"], rel=1e-5)
    assert parity.port_h.hours_trained == 3 and parity.port_h.evals_done == 2


def _near_tie_swaps(port_log, jax_log, gap=1e-5):
    """Ranked positions where the two recommendation logs differ; each must
    sit in a near tie of the JAX probabilities.  Returns their names."""
    swaps = []
    for port_rec, jax_rec in zip(port_log, jax_log):
        assert port_rec["session_id"] == jax_rec["session_id"]
        assert port_rec["next_click_labels"] == jax_rec["next_click_labels"]
        for step, (p_ids, j_ids, j_probs) in enumerate(zip(
                port_rec["predicted_item_ids"], jax_rec["predicted_item_ids"],
                jax_rec["predicted_item_probs"])):
            for pos in np.flatnonzero(np.asarray(p_ids) != np.asarray(j_ids)):
                near = [abs(j_probs[pos] - j_probs[q]) <= gap
                        for q in (pos - 1, pos + 1) if 0 <= q < len(j_probs)]
                assert any(near), (
                    f"session {jax_rec['session_id']} step {step} rank {pos}: "
                    f"{p_ids[pos]} vs {j_ids[pos]}, not a near tie")
                swaps.append(f"session {jax_rec['session_id']} step {step} rank {pos}")
    return swaps


def test_eval_rows_match_jax(parity):
    assert len(parity.port_rows) == len(parity.jax_rows) == 2
    for port_row, jax_row in zip(parity.port_rows, parity.jax_rows):
        assert set(port_row) == set(jax_row)
        assert port_row["clicks_count"] == jax_row["clicks_count"]
        assert port_row["sessions_count"] == jax_row["sessions_count"]
    port_log = _read_json_lines(parity.port_h, "eval_chameleon_recommendations_log.json")
    jax_log = _read_json_lines(parity.jax_h, "eval_chameleon_recommendations_log.json")
    assert len(port_log) == len(jax_log) > 0
    swaps = _near_tie_swaps(port_log, jax_log)
    if swaps:
        print("near ties ranked the other way:", swaps)
    for port_row, jax_row in zip(parity.port_rows, parity.jax_rows):
        labels = port_row["clicks_count"]
        rank_tol = 1e-6 + len(swaps) / labels
        for key, value in jax_row.items():
            if key in ("hitrate_at_n", "mrr_at_n") or key.endswith("_chameleon"):
                tol = rank_tol if ("hitrate" in key or "mrr" in key
                                   or "ndcg" in key) else 1e-6
                assert port_row[key] == pytest.approx(value, abs=tol), key


def _read_json_lines(harness, name):
    import json

    path = Path(harness.run_cfg.model_dir) / name
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_baseline_columns_bit_equal_jax(parity):
    compared = 0
    for port_row, jax_row in zip(parity.port_rows, parity.jax_rows):
        for key, value in jax_row.items():
            if key.endswith(BASELINES):
                assert port_row[key] == value, key
                compared += 1
    assert compared == 2 * 8 * len(BASELINES)


def test_scalars_and_histograms_match_jax(parity):
    port_dir = Path(parity.port_h.run_cfg.model_dir)
    jax_dir = Path(parity.jax_h.run_cfg.model_dir)
    port_rows = _read_json_lines(parity.port_h, "train_scalars.jsonl")
    jax_rows = _read_json_lines(parity.jax_h, "train_scalars.jsonl")
    assert len(port_rows) == len(jax_rows) == 3 * 2  # three hours of two steps
    for port_row, jax_row in zip(port_rows, jax_rows):
        assert list(port_row) == list(jax_row)
        for key in ("step", "sessions", "clicks"):
            assert port_row[key] == jax_row[key], key
        assert port_row["ce_loss"] == pytest.approx(jax_row["ce_loss"], rel=1e-5)
    port_hists = _read_json_lines(parity.port_h, "train_histograms.jsonl")
    jax_hists = _read_json_lines(parity.jax_h, "train_histograms.jsonl")
    assert (port_dir / "train_histograms.jsonl").exists()
    assert (jax_dir / "train_histograms.jsonl").exists()
    assert sorted((r["step"], "params/" + _flax_path(r["name"][len("params/"):])[0])
                  for r in port_hists) == sorted((r["step"], r["name"]) for r in jax_hists)


def test_device_metrics_equal_host_suite(parity):
    """The reference's own cross-check: the in-step HR/MRR sums against the
    streaming suite's CHAMELEON columns, within the port."""
    for row in parity.port_rows:
        assert row["hitrate_at_n"] == row["hitrate_at_n_chameleon"]
        assert row["mrr_at_n"] == pytest.approx(row["mrr_at_n_chameleon"], rel=1e-6)


def test_artifacts_have_the_jax_names_and_columns(parity):
    port_dir = Path(parity.port_h.run_cfg.model_dir)
    jax_dir = Path(parity.jax_h.run_cfg.model_dir)
    names = sorted(p.name for p in jax_dir.iterdir() if p.suffix in (".csv", ".json"))
    assert names == sorted(p.name for p in port_dir.iterdir()
                           if p.suffix in (".csv", ".json"))
    with open(port_dir / "eval_stats_benchmarks.csv") as f:
        port_rows = list(csv.DictReader(f))
    with open(jax_dir / "eval_stats_benchmarks.csv") as f:
        jax_rows = list(csv.DictReader(f))
    assert len(port_rows) == len(jax_rows) == 2
    assert list(port_rows[0]) == list(jax_rows[0])


def test_eval_restores_stream_state(world):
    h = port_harness(world, "restore")
    h.train_hour(world.port_source(0))
    before = {k: v.clone() for k, v in h.state.stream._asdict().items()}
    host_step = h.host_state.current_step
    h.evaluate_hour(world.port_source(1))
    for name, value in before.items():
        assert torch.equal(getattr(h.state.stream, name), value), name
    assert h.host_state.current_step == host_step


def test_checkpoint_roundtrip(world, tmp_path):
    h1 = port_harness(world, "ckpt1")
    h1.run(world.port_source, range(2))  # train 0, eval 1, train 1
    ckpt = h1.save_checkpoint(tmp_path / "ckpt.pkl")
    h2 = port_harness(world, "ckpt2")
    h2.load_checkpoint(ckpt)
    assert (h2.hours_trained, h2.evals_done) == (2, 1)
    assert h2.artifacts.eval_sessions_metrics_log == h1.artifacts.eval_sessions_metrics_log
    for name, value in h1.state.stream._asdict().items():
        assert torch.equal(getattr(h2.state.stream, name), value), name
    assert h2.host_state.current_step == h1.host_state.current_step
    assert h2.state.step == h1.state.step
    # both resume bit for bit: the same params, Adam moments, generator
    s1 = h1.train_hour(world.port_source(2))
    s2 = h2.train_hour(world.port_source(2))
    assert s1 == s2
    for (name, p1), p2 in zip(h1.state.model.named_parameters(),
                              h2.state.model.parameters()):
        assert torch.equal(p1, p2), name
    # the eval rows too, but for the train throughput counters, which count
    # since each harness was built (as in the JAX harness, not checkpointed)
    row1, row2 = (h.evaluate_hour(world.port_source(3)) for h in (h1, h2))
    assert {k: v for k, v in row1.items() if not k.startswith("train_")} == {
        k: v for k, v in row2.items() if not k.startswith("train_")}
    # the file is plain types: it loads where torch cannot be imported
    script = ("import sys, pickle; sys.modules['torch'] = None; "
              f"p = pickle.load(open({str(ckpt)!r}, 'rb')); print(sorted(p))")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_checkpoint_from_the_other_device_type_loads(world, tmp_path):
    """A checkpoint written on the card loads on the CPU: the tensors are
    numpy arrays, and the card's generator state (torch's CUDA generator is
    another algorithm) gives way to the CPU generator's initial seed."""
    h1 = port_harness(world, "device1")
    h1.train_hour(world.port_source(0))
    path = h1.save_checkpoint(tmp_path / "card.pkl")
    payload = deserialize(path)
    payload["generator"] = {"device": "cuda", "state": np.arange(16, dtype=np.uint8)}
    serialize(path, payload)
    h2 = port_harness(world, "device2")
    h2.load_checkpoint(path)
    fresh = torch.Generator().manual_seed(h2.run_cfg.random_seed)
    assert torch.equal(h2.state.generator.get_state(), fresh.get_state())
    for (name, p1), p2 in zip(h1.state.model.named_parameters(),
                              h2.state.model.parameters()):
        assert torch.equal(p1, p2), name


def test_resume_skips_trained_hours(world, tmp_path):
    """``run`` after ``load_checkpoint`` continues from the hour cursor."""
    h1 = port_harness(world, "skip1")
    h1.run(world.port_source, range(3))
    assert h1.hours_trained == 3
    ckpt = h1.save_checkpoint(tmp_path / "resume.pkl")
    rows_before = len(h1.artifacts.eval_sessions_metrics_log)
    h2 = port_harness(world, "skip2")
    h2.load_checkpoint(ckpt)
    trained = spy_train_hours(h2)
    h2.run(world.port_source, range(5))  # only hours 3 and 4 train
    assert len(trained) == 2
    assert h2.hours_trained == 5
    assert len(h2.artifacts.eval_sessions_metrics_log) == rows_before + 2


def test_resume_reruns_pending_eval(world, tmp_path):
    """A checkpoint taken after a chunk's training but before its eval
    re-runs that eval on resume, and trains nothing again."""
    h1 = port_harness(world, "pending1")
    h1.train_hour(world.port_source(0))
    assert h1.evals_done == 0
    ckpt = h1.save_checkpoint(tmp_path / "pending.pkl")
    h2 = port_harness(world, "pending2")
    h2.load_checkpoint(ckpt)
    trained = spy_train_hours(h2)
    evals = []
    original = h2.evaluate_hour
    h2.evaluate_hour = lambda sessions: evals.append(1) or original(sessions)
    h2.run(world.port_source, range(2))  # the pending eval of hour 1, then train 1
    assert len(evals) == 1 and len(trained) == 1
    assert h2.evals_done == 1 and len(h2.artifacts.eval_sessions_metrics_log) == 1


def test_jax_checkpoint_converts_and_resumes(world, parity):
    """A JAX harness checkpoint through ``checkpoint_from_jax``: the port's
    next hour equals the JAX harness's next hour (Adam's moments and step
    carried over), and so does the eval after it."""
    payload = jax_deserialize(parity.jax_ckpt)
    state = payload["state"]
    adam = state.opt_state[0]
    numpy_payload = {
        "params": numpy_tree(state.params),
        "adam": {"count": np.asarray(adam.count), "mu": numpy_tree(adam.mu),
                 "nu": numpy_tree(adam.nu)},
        "stream": {k: np.asarray(v) for k, v in state.stream._asdict().items()},
        "step": int(state.step),
        **{k: payload[k] for k in ("hours_trained", "evals_done", "metrics_log",
                                   "host_cooccurrence", "host_first_click_step",
                                   "host_current_step", "host_benchmarks_states")},
    }
    h = port_harness(world, "converted")
    h.init_state()
    converted = checkpoint_from_jax(numpy_payload, h.state.model)
    serialize(world.model_dir / "converted.pkl", converted)
    h.load_checkpoint(world.model_dir / "converted.pkl")
    assert (h.hours_trained, h.evals_done) == (3, 2)
    assert int(h.state.optimizer.state_dict()["state"][0]["step"]) == int(adam.count) > 0
    # JAX's key has no torch counterpart: the harness keeps its own generator
    assert converted["generator"] is None
    fresh = torch.Generator().manual_seed(h.run_cfg.random_seed)
    assert torch.equal(h.state.generator.get_state(), fresh.get_state())

    jax_h = parity.jax_h
    jax_h.load_checkpoint(parity.jax_ckpt)
    with jax_draws(world, jax_h.state.rng):
        port_stats = h.train_hour(world.port_source(4))
        port_row = h.evaluate_hour(world.port_source(5))
    jax_stats = jax_h.train_hour(world.jax_source(4))
    jax_row = jax_h.evaluate_hour(world.jax_source(5))
    assert port_stats["avg_ce_loss"] == pytest.approx(jax_stats["avg_ce_loss"], rel=1e-5)
    for key, value in jax_row.items():
        if key.endswith(("_pop_recent", "_sr")):
            assert port_row[key] == value, key
    assert port_row["hitrate_at_n"] == pytest.approx(jax_row["hitrate_at_n"],
                                                     abs=1 / port_row["clicks_count"])


def test_parallel_benchmark_tier_matches_serial(world):
    """The thread-pool benchmark tier is observably the serial loop: every
    column of the eval row, cold-start statistics included, is equal."""
    def run_with(workers):
        h = port_harness(world, f"workers{workers}", eval_cold_start=True,
                         benchmark_workers=workers)
        assert (h._bench_pool is None) == (workers < 2)
        return h.run(world.port_source, range(2))[0]

    serial, parallel = run_with(0), run_with(2)
    assert set(serial) == set(parallel)
    for key, value in serial.items():
        if not key.endswith(WALL_CLOCK):
            assert parallel[key] == value, key


def test_from_checkpoint_serves_as_the_live_server(world, tmp_path):
    h = port_harness(world, "serve")
    h.run(world.port_source, range(2))
    ckpt = h.save_checkpoint(tmp_path / "serve.pkl")
    args = (world.pcfg, world.psess, world.part)
    aux = (world.pcorpus.ace_matrix, world.pcorpus.metadata)
    live = port.NARServer(*args, h.state.model.state_dict(), h.state.stream, *aux,
                          device="cpu")
    loaded = port.NARServer.from_checkpoint(ckpt, *args, *aux, device="cpu")
    sessions = world.port_source(5)[:8]
    ids, scores = live.recommend(sessions, top_k=10, num_candidates=50)
    got_ids, got_scores = loaded.recommend(sessions, top_k=10, num_candidates=50)
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_scores, scores)


def test_harness_raises_on_what_is_not_ported(world):
    """A mesh whose data parallelism does not divide the batch raises JAX's
    ``ValueError``; the tooling and every baseline of this package are
    taken, and a baseline of the JAX package is not."""
    dp = 3
    assert world.cfg.batch_size % dp
    with pytest.raises(ValueError) as jax_error:
        jax_harness(world, mesh_plan=jax_make_mesh(dp, 1, devices=jax.devices()[:dp]))
    plan = MeshPlan(dp, 0, dp, 1, None, None, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError) as port_error:
        port_harness(world, "raises", mesh_plan=plan)
    assert str(port_error.value) == str(jax_error.value)
    with pytest.raises(TypeError, match="BenchmarkRecommender"):
        port_harness(world, "raises",
                     benchmarks=[BenchmarkSpec(JaxRecentlyPopular, {})])
    taken = port_harness(world, "raises", artifact_store=object(),
                         artifact_remote_path="jobs/x", save_scalars=True,
                         save_histograms=True, histograms_every_n_hours=2,
                         benchmarks=default_benchmarks(world.pcorpus.ace_matrix))
    assert len(taken.bench_classifiers) == len(BASELINES)
    assert taken.scalar_writer is not None and taken.histogram_writer is not None
    not_ours = world.model_dir / "not_a_checkpoint.pkl"
    serialize(not_ours, {"state": None})  # the JAX harness's layout
    with pytest.raises(ValueError, match="format"):
        port_harness(world, "raises").load_checkpoint(not_ours)

"""The PyTorch port's NAR serving path against the JAX package's.

A tiny JAX NARModel is initialised as ``nar_init_state`` does, its params
are perturbed (so zero biases and unit gammas also test the bridge) and
converted with ``params_from_flax``.  Both ``NARServer``s observe the same
sessions, then recommend the same live sessions over explicit, distinct
candidates.  The JAX side runs the Pallas UGRNN in interpret mode, as
``ops/rnn.py`` selects off-TPU; the port runs on the CPU, where its kernel
wrapper takes the plain twin.

Tolerances: float32 scores at rtol 1e-5 / atol 1e-6 (the sums run in another
order); bfloat16 scores at atol 2e-2, ids compared where the JAX scores
around a rank are more than 2e-2 apart, and scores also at rtol 5e-2 (bf16
keeps 8 bits of mantissa and rounds at other places in the two frameworks;
the temperature of 0.1 scales a logit's rounding tenfold).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chameleon_recsys_tpu.data.collate import collate_sessions
from chameleon_recsys_tpu.data.synthetic import (
    make_synthetic_corpus,
    synthetic_hour_sessions,
)
from chameleon_recsys_tpu.models.nar import NARAux
from chameleon_recsys_tpu.models.nar import NARModel as JaxNARModel
from chameleon_recsys_tpu.serve import NARServer as JaxNARServer
from chameleon_recsys_tpu.state.stream_state import (
    init_stream_state as jax_init_stream_state,
)

import chameleon_recsys_tpu_torch as port
from chameleon_recsys_tpu_torch.convert import params_from_flax, stream_from_numpy
from chameleon_recsys_tpu_torch.ops.kernels import ugrnn as port_ugrnn

from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema

NUM_ITEMS = 200
NUM_CANDIDATES = 24
NUM_PADDING = 3  # trailing candidate slots set to 0 (padding, scored -inf)


def port_config(cfg):
    values = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    values["internal_features"] = port.InternalFeaturesConfig(
        **dataclasses.asdict(cfg.internal_features)
    )
    return port.NARConfig(**values)


def port_specs(specs):
    return tuple(port.FeatureSpec(**dataclasses.asdict(s)) for s in specs)


def port_session_schema(schema):
    return port.SessionFeaturesSchema(
        single=port_specs(schema.single), sequence=port_specs(schema.sequence)
    )


def port_article_schema(schema):
    return port.ArticleFeaturesSchema(features=port_specs(schema.features))


@pytest.fixture(scope="module")
def world():
    art = tiny_article_schema(NUM_ITEMS)
    sess = tiny_session_schema(NUM_ITEMS)
    cfg = tiny_nar_config()
    corpus = make_synthetic_corpus(art, ace_dim=8)
    observed = synthetic_hour_sessions(corpus, sess, 0, 16, cfg.max_session_length)
    live = synthetic_hour_sessions(corpus, sess, 1, 6, cfg.max_session_length)

    # as train/steps.py::nar_init_state initialises the model
    batch = {
        k: jnp.asarray(v)
        for k, v in collate_sessions(
            observed[: cfg.batch_size], sess, cfg.batch_size,
            cfg.max_session_length,
        ).items()
    }
    stream = jax_init_stream_state(cfg, NUM_ITEMS)
    aux = NARAux(
        ace_matrix=jnp.asarray(corpus.ace_matrix),
        metadata={k: jnp.asarray(v) for k, v in corpus.metadata.items()},
        recent_pop_norm=stream.recent_pop_norm,
        buffer_ids=stream.buffer_ids,
    )
    neg = jnp.zeros(
        (cfg.batch_size, cfg.max_inputs_length, cfg.negative_samples), jnp.int32
    )
    key = jax.random.key(42)
    params = JaxNARModel(cfg, sess, art).init(
        {"params": key, "dropout": key}, batch, aux, neg, train=False
    )["params"]
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32),
        params,
    )

    cand_rng = np.random.RandomState(7)
    candidates = np.stack([
        cand_rng.choice(np.arange(1, NUM_ITEMS), NUM_CANDIDATES, replace=False)
        for _ in live
    ]).astype(np.int32)
    candidates[:, -NUM_PADDING:] = 0
    return dict(
        art=art, sess=sess, corpus=corpus, observed=observed, live=live,
        params=params, candidates=candidates,
    )


CASES = {
    "kernel_f32": dict(use_pallas_rnn=True, compute_dtype="float32"),
    "kernel_bf16": dict(use_pallas_rnn=True, compute_dtype="bfloat16"),
    "plain_f32": dict(use_pallas_rnn=False, compute_dtype="float32"),
}


@pytest.fixture(scope="module", params=list(CASES))
def served(request, world):
    """Both servers after observing the same two batches, and their
    recommendations for the live sessions."""
    cfg = tiny_nar_config(**CASES[request.param])
    art, sess, corpus = world["art"], world["sess"], world["corpus"]
    jax_stream = jax_init_stream_state(cfg, NUM_ITEMS)
    jax_server = JaxNARServer(
        cfg, sess, art, jax.tree_util.tree_map(jnp.asarray, world["params"]),
        jax_stream, corpus.ace_matrix, corpus.metadata,
    )
    pcfg = port_config(cfg)
    psess, part = port_session_schema(sess), port_article_schema(art)
    model = port.NARModel(pcfg, psess, part, corpus.ace_matrix.shape[1])
    state_dict = params_from_flax(world["params"], model)
    port_server = port.NARServer(
        pcfg, psess, part, state_dict,
        stream_from_numpy(
            {k: np.asarray(v) for k, v in jax_stream._asdict().items()},
            device="cpu",
        ),
        corpus.ace_matrix, corpus.metadata, device="cpu",
    )
    observed = world["observed"]
    for server in (jax_server, port_server):
        server.observe(observed[:8])
        server.observe(observed[8:])

    top_k = NUM_CANDIDATES - NUM_PADDING  # the full ranking of real items
    launches = port_ugrnn.launches
    jax_out = jax_server.recommend(
        world["live"], candidates=world["candidates"], top_k=top_k
    )
    port_out = port_server.recommend(
        world["live"], candidates=world["candidates"], top_k=top_k
    )
    assert port_ugrnn.launches == launches  # the CPU path launches nothing
    return dict(
        case=request.param, jax_server=jax_server, port_server=port_server,
        model=model, state_dict=state_dict, jax_out=jax_out, port_out=port_out,
        candidates=world["candidates"],
    )


def test_state_dict_keys_equal_model_keys(served):
    assert set(served["state_dict"]) == set(served["model"].state_dict())


def test_observe_stream_equal(served):
    jax_stream = served["jax_server"].stream
    port_stream = served["port_server"].stream
    for name in jax_stream._fields:
        np.testing.assert_array_equal(
            getattr(port_stream, name).numpy(),
            np.asarray(getattr(jax_stream, name)),
            err_msg=name,
        )


def test_default_candidates_equal(served):
    for n in (5, 64, 400):
        np.testing.assert_array_equal(
            served["port_server"].default_candidates(n),
            served["jax_server"].default_candidates(n),
        )


def test_recommend_matches_jax(served):
    jax_ids, jax_scores = served["jax_out"]
    port_ids, port_scores = served["port_out"]
    assert port_ids.shape == jax_ids.shape
    assert port_ids.dtype == np.int32 and port_scores.dtype == np.float32
    assert np.isfinite(port_scores).all()
    if served["case"].endswith("f32"):
        np.testing.assert_array_equal(port_ids, jax_ids)
        np.testing.assert_allclose(port_scores, jax_scores, rtol=1e-5, atol=1e-6)
        return
    np.testing.assert_allclose(port_scores, jax_scores, atol=2e-2)
    # the tiny model's scores sit near 1/25, so also hold them relatively
    np.testing.assert_allclose(port_scores, jax_scores, rtol=5e-2, atol=0)
    gap = np.full(jax_scores.shape, np.inf, np.float32)
    diffs = np.abs(np.diff(jax_scores, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], diffs)
    gap[:, :-1] = np.minimum(gap[:, :-1], diffs)
    separated = gap > 2e-2
    np.testing.assert_array_equal(port_ids[separated], jax_ids[separated])
    # each returned id is a real candidate of its row, each at most once
    for row, cand in zip(port_ids, served["candidates"]):
        assert set(row.tolist()) == set(cand.tolist()) - {0}


def test_recommend_from_default_pool(served, world):
    port_server = served["port_server"]
    live = world["live"]
    ids, scores = port_server.recommend(live, top_k=3, num_candidates=16)
    pool = set(port_server.default_candidates(16).tolist()) - {0}
    assert ids.shape == (len(live), 3)
    assert set(ids.reshape(-1).tolist()) <= pool
    assert (np.diff(scores, axis=1) <= 0).all()
    ids, scores = port_server.recommend([], top_k=3)
    assert ids.shape == (0, 3) and scores.shape == (0, 3)


def test_params_from_flax_rejects_mismatch(world):
    art, sess = world["art"], world["sess"]
    model = port.NARModel(
        port_config(tiny_nar_config()), port_session_schema(sess),
        port_article_schema(art), world["corpus"].ace_matrix.shape[1],
    )
    params = dict(world["params"])
    with pytest.raises(KeyError, match="no rule"):
        params_from_flax({**params, "mystery_kernel": np.zeros(3)}, model)
    with pytest.raises(KeyError, match="not consumed"):
        params_from_flax({**params, "matching_9_bias": np.zeros(3)}, model)
    with pytest.raises(ValueError, match="CAR_bias"):
        params_from_flax({**params, "CAR_bias": np.zeros(3)}, model)
    params.pop("CAR_bias")
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(params, model)

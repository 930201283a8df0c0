"""The port's NAR eval step against the JAX package's ``eval_step_fn``.

A tiny JAX NARModel (matching layers 16/8/8, so that ``use_pallas_scorer``
reaches the fused scorer) is initialised by ``nar_init_state``, its params
perturbed and converted with ``params_from_flax``.  Both sides take the same
stream state and collated batches; the JAX sampler's uniforms are drawn
from ``state.rng`` the way ``build_nar_train`` splits it (``_split_state_rng``,
then ``_forward_and_negatives`` and ``sample_negatives_pooled``) and injected
into the port.  The JAX side runs its Pallas kernels (fused scorer, UGRNN) in
interpret mode, as it selects off-TPU; the port runs on the CPU, where its
kernel wrappers take the plain twins.

Tolerances: float32 probabilities at rtol 1e-5 / atol 1e-6 and ``ce_loss``
at rel 1e-5 (the same f32 arithmetic summed in another order); ranked ids
where JAX's neighbouring probabilities are more than 1e-5 apart; the
hit count, fetches and stream state exactly; the reciprocal-rank sum at rel
1e-6 (f32 fractions added in another order).  bfloat16 probabilities at atol
2e-2: bf16 keeps 8 bits of mantissa and the two frameworks round at other
places (the JAX dense path rounds ``u + i`` before adding the constant, the
kernel twin adds in f32), and the temperature of 0.1 scales a logit's
rounding tenfold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.data.collate import collate_sessions as jax_collate
from chameleon_recsys_tpu.data.synthetic import (
    make_synthetic_corpus,
    synthetic_hour_sessions,
)
from chameleon_recsys_tpu.models.nar import NARAux as JaxNARAux
from chameleon_recsys_tpu.ops.sampling import (
    sample_negatives_pooled as jax_sample_negatives_pooled,
)
from chameleon_recsys_tpu.state.stream_state import (
    update_stream_state as jax_update_stream_state,
)
from chameleon_recsys_tpu.train.steps import (
    _batch_all_clicks as jax_batch_all_clicks,
    build_nar_train,
    nar_init_state,
)

import chameleon_recsys_tpu_torch as port
from chameleon_recsys_tpu_torch.convert import params_from_flax, stream_from_numpy
from chameleon_recsys_tpu_torch.data import collate as port_collate
from chameleon_recsys_tpu_torch.models.nar import NARAux
from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer, ugrnn
from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
from chameleon_recsys_tpu_torch.train.steps import (
    eval_scorer_operands,
    eval_step,
    valid_click_mask,
)

from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema
from test_torch_serve import port_article_schema, port_config, port_session_schema

NUM_ITEMS = 200
MATCHING = (16, 8, 8)


def config(**overrides):
    return tiny_nar_config(
        matching_layer_sizes=MATCHING, use_pallas_rnn=True, **overrides
    )


@pytest.fixture(scope="module")
def world():
    art = tiny_article_schema(NUM_ITEMS)
    sess = tiny_session_schema(NUM_ITEMS)
    cfg = config()
    corpus = make_synthetic_corpus(art, ace_dim=8)
    hours = [
        synthetic_hour_sessions(corpus, sess, h, 2 * cfg.batch_size,
                                cfg.max_session_length)
        for h in range(3)
    ]
    ace = jnp.asarray(corpus.ace_matrix)
    metadata = {k: jnp.asarray(v) for k, v in corpus.metadata.items()}
    first = {k: jnp.asarray(v) for k, v in jax_collate(
        hours[0][: cfg.batch_size], sess, cfg.batch_size, cfg.max_session_length
    ).items()}
    _, _, state = nar_init_state(cfg, sess, art, first, ace, metadata)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32),
        state.params,
    )
    return dict(art=art, sess=sess, corpus=corpus, hours=hours, ace=ace,
                metadata=metadata, state=state, params=params)


def jax_batches(world, cfg, hour):
    sessions = world["hours"][hour]
    return [
        {k: jnp.asarray(v) for k, v in jax_collate(
            sessions[i: i + cfg.batch_size], world["sess"], cfg.batch_size,
            cfg.max_session_length,
        ).items()}
        for i in range(0, len(sessions), cfg.batch_size)
    ]


def port_model(world, cfg):
    model = port.NARModel(
        port_config(cfg), port_session_schema(world["sess"]),
        port_article_schema(world["art"]), world["corpus"].ace_matrix.shape[1],
    )
    model.load_state_dict(params_from_flax(world["params"], model), strict=True)
    return model.eval()


def port_aux_consts(world):
    ace = torch.from_numpy(world["corpus"].ace_matrix)
    metadata = {
        k: torch.from_numpy(np.asarray(
            v, np.float32 if np.asarray(v).dtype.kind == "f" else np.int64))
        for k, v in world["corpus"].metadata.items()
    }
    return ace, metadata


def to_port_stream(jax_stream):
    return stream_from_numpy(
        {k: np.asarray(v) for k, v in jax_stream._asdict().items()}, device="cpu"
    )


def warm_stream(world, cfg, hours):
    """The JAX stream after folding ``hours`` hours of clicks in."""
    stream = world["state"].stream
    for hour in range(hours):
        for batch in jax_batches(world, cfg, hour):
            all_clicked, all_ts = jax_batch_all_clicks(batch)
            stream = jax_update_stream_state(stream, all_clicked, all_ts, cfg)
    return stream


def jax_eval_uniforms(cfg, raw_rng, b, buffer_size):
    """The uniforms ``eval_step_fn`` draws from ``state.rng``."""
    key = jax.random.wrap_key_data(raw_rng, impl=cfg.rng_impl)
    _, step_rng = jax.random.split(key)
    rng_neg, _ = jax.random.split(step_rng)
    rng_buf, rng_pool, rng_u = jax.random.split(rng_neg, 3)
    l = cfg.max_session_length
    m = cfg.eval_negative_sample_from_buffer
    nc = min(cfg.eval_negative_samples * cfg.neg_sampling_multiplying_factor,
             b * l + m)

    def uniform(rng, shape):
        return torch.tensor(np.asarray(jax.random.uniform(rng, shape)))

    return SamplerUniforms(
        buffer=uniform(rng_buf, (buffer_size,)),
        pool=uniform(rng_pool, (b * l + m,)),
        click=uniform(rng_u, (b, l, nc)),
    )


def test_collate_sessions_bit_equal(world):
    sess, cfg = world["sess"], config()
    sessions = world["hours"][1][:5]
    long = dataclasses.replace(
        sessions[0], item_ids=list(range(1, 15)), timestamps=list(range(14)),
        context={k: v * 3 for k, v in sessions[0].context.items()},
    )
    for group in (sessions, [long] + sessions[1:3]):
        expected = jax_collate(group, sess, cfg.batch_size, cfg.max_session_length)
        ported = port_collate.collate_sessions(
            group, port_session_schema(sess), cfg.batch_size,
            cfg.max_session_length,
        )
        assert set(ported) == set(expected)
        for key, value in expected.items():
            assert ported[key].dtype == value.dtype, key
            np.testing.assert_array_equal(ported[key], value, err_msg=key)
    batches = list(port_collate.batches_from_sessions(
        world["hours"][2][:11], port_session_schema(sess), 4,
        cfg.max_session_length,
    ))
    assert len(batches) == 3 and (batches[-1]["session_size"][3:] == 0).all()
    with pytest.raises(ValueError):
        port_collate.collate_sessions(sessions, port_session_schema(sess), 2, 8)


CASES = {
    "fused_cold_f32": dict(use_pallas_scorer=True, warm_hours=0),
    "fused_warm_f32": dict(use_pallas_scorer=True, warm_hours=2),
    "plain_cold_f32": dict(use_pallas_scorer=False, warm_hours=0),
    "plain_warm_f32": dict(use_pallas_scorer=False, warm_hours=2),
    "fused_warm_bf16": dict(use_pallas_scorer=True, warm_hours=2,
                            compute_dtype="bfloat16"),
}


@pytest.fixture(scope="module", params=list(CASES))
def evaluated(request, world):
    """Two consecutive eval steps of the eval hour on both sides, the stream
    and the rng carried from the first to the second."""
    overrides = dict(CASES[request.param])
    warm_hours = overrides.pop("warm_hours")
    cfg = config(**overrides)
    jax_stream = warm_stream(world, cfg, warm_hours)
    state = world["state"]._replace(
        params=jax.tree_util.tree_map(jnp.asarray, world["params"]),
        stream=jax_stream,
    )
    # eager, not jitted: on an empty buffer every item has the same novelty
    # and recency standardisation divides a rounding residue by sqrt(1e-24),
    # so the cold-start features depend on the f32 order of the masked mean,
    # which jit changes (the jitted JAX step then scores every candidate
    # alike); the eager step computes it as the port does
    jax_step = build_nar_train(cfg, world["sess"], world["art"]).eval_step_fn
    model = port_model(world, cfg)
    ace, metadata = port_aux_consts(world)
    stream = to_port_stream(jax_stream)
    steps = []
    launches = (cand_scorer.launches, ugrnn.launches)
    for jax_batch in jax_batches(world, cfg, warm_hours):
        batch = {k: torch.from_numpy(np.array(v)) for k, v in jax_batch.items()}
        uniforms = jax_eval_uniforms(
            cfg, state.rng, cfg.batch_size, cfg.recent_clicks_buffer_max_size
        )
        state, jax_metrics, jax_fetches = jax_step(
            state, jax_batch, world["ace"], world["metadata"]
        )
        stream, metrics, fetches = eval_step(
            model, stream, batch, ace, metadata,
            generator=torch.Generator(), uniforms=uniforms,
        )
        slim = eval_step(
            model, to_port_stream(jax_stream), batch, ace, metadata,
            generator=torch.Generator(), fetch_full_ranking=False,
            uniforms=uniforms,
        )[2] if not steps else None
        steps.append(dict(
            jax_metrics={k: np.asarray(v) for k, v in jax_metrics.items()},
            jax_fetches={k: np.asarray(v) for k, v in jax_fetches.items()},
            jax_stream=state.stream, metrics=metrics, fetches=fetches,
            stream=stream, slim=slim, batch=batch,
        ))
    # the CPU path launches no kernel
    assert (cand_scorer.launches, ugrnn.launches) == launches
    return dict(case=request.param, cfg=cfg, steps=steps)


def _separated(probs, gap):
    diffs = np.abs(np.diff(probs, axis=-1))
    ok = np.ones(probs.shape, bool)
    ok[..., 1:] &= diffs > gap
    ok[..., :-1] &= diffs > gap
    return ok


def test_eval_probs_and_ranking_match_jax(evaluated):
    for step in evaluated["steps"]:
        probs = step["fetches"]["predicted_probs"].numpy()
        jax_probs = step["jax_fetches"]["predicted_probs"]
        ids = step["fetches"]["predicted_ids"].numpy()
        jax_ids = step["jax_fetches"]["predicted_ids"]
        assert probs.shape == jax_probs.shape and ids.shape == jax_ids.shape
        if evaluated["case"].endswith("bf16"):
            np.testing.assert_allclose(probs, jax_probs, rtol=0, atol=2e-2)
            continue
        np.testing.assert_allclose(probs, jax_probs, rtol=1e-5, atol=1e-6)
        sep = _separated(jax_probs, 1e-5)
        np.testing.assert_array_equal(ids[sep], jax_ids[sep])


def test_eval_metrics_match_jax(evaluated):
    for step in evaluated["steps"]:
        metrics, jax_metrics = step["metrics"], step["jax_metrics"]
        assert set(metrics) == set(jax_metrics)
        for key in ("label_count", "clicks", "sessions"):
            assert float(metrics[key]) == float(jax_metrics[key]), key
        if evaluated["case"].endswith("bf16"):
            assert np.isfinite(float(metrics["ce_loss"]))
            assert 0 <= float(metrics["hit_sum"]) <= float(metrics["label_count"])
            continue
        assert float(metrics["ce_loss"]) == pytest.approx(
            float(jax_metrics["ce_loss"]), rel=1e-5
        )
        assert float(metrics["hit_sum"]) == float(jax_metrics["hit_sum"])
        # sums of the f32 fractions 1 / (1 + rank): the order of the
        # additions moves the last bit
        assert float(metrics["rr_sum"]) == pytest.approx(
            float(jax_metrics["rr_sum"]), rel=1e-6
        )
        mask = valid_click_mask(step["batch"]["session_size"],
                                evaluated["cfg"].max_inputs_length)
        assert float(metrics["label_count"]) == float(mask.sum())


def test_eval_fetches_and_stream_match_jax(evaluated):
    top_n = evaluated["cfg"].metrics_top_n
    for i, step in enumerate(evaluated["steps"]):
        for key in ("labels", "neg_items", "clicked_items"):
            np.testing.assert_array_equal(
                step["fetches"][key].numpy(), step["jax_fetches"][key], err_msg=key
            )
        for name in step["jax_stream"]._fields:
            np.testing.assert_array_equal(
                getattr(step["stream"], name).numpy(),
                np.asarray(getattr(step["jax_stream"], name)), err_msg=name,
            )
        if i == 0:
            slim = step["slim"]
            assert set(slim) == {"labels", "neg_items", "clicked_items",
                                 "predicted_ids"}
            torch.testing.assert_close(
                slim["predicted_ids"],
                step["fetches"]["predicted_ids"][..., :top_n],
            )


def test_eval_ranking_is_a_permutation_of_candidates(evaluated):
    for step in evaluated["steps"]:
        ids = step["fetches"]["predicted_ids"]
        cand = torch.cat([step["batch"]["label_next_item"][..., None],
                          step["fetches"]["neg_items"]], -1)
        torch.testing.assert_close(ids.sort(-1).values, cand.sort(-1).values)
        probs = step["fetches"]["predicted_probs"]
        assert (probs[..., 1:] <= probs[..., :-1]).all()
        torch.testing.assert_close(
            probs.sum(-1), torch.ones(probs.shape[:-1]), rtol=0, atol=1e-5
        )


@pytest.mark.parametrize("warm_hours", [0, 2])
def test_eval_scorer_operands_are_the_eval_steps(world, warm_hours):
    """``eval_scorer_operands`` gives back the fused scorer's operands of
    the eval step with the same arguments: the plain twin's scores on them,
    softmaxed over the K negatives, are the step's negative probabilities
    renormalised, at every valid step (float32, the same arithmetic)."""
    cfg = config(use_pallas_scorer=True)
    jax_stream = warm_stream(world, cfg, warm_hours)
    model = port_model(world, cfg)
    ace, metadata = port_aux_consts(world)
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in jax_batches(world, cfg, warm_hours)[0].items()}
    uniforms = jax_eval_uniforms(
        cfg, world["state"].rng, cfg.batch_size, cfg.recent_clicks_buffer_max_size
    )
    args = (model, to_port_stream(jax_stream), batch, ace, metadata)
    _, _, fetches = eval_step(*args, generator=torch.Generator(), uniforms=uniforms)
    operands = eval_scorer_operands(*args, generator=torch.Generator(),
                                    uniforms=uniforms)
    b, t = batch["item_clicked"].shape
    k = cfg.eval_negative_samples
    assert len(operands) == 12
    assert operands[0].shape == (b * t * k, cfg.car_embedding_size)
    with torch.inference_mode():
        scores = (cand_scorer.cand_score_reference(*operands)
                  + model.matching_out_bias[0]).reshape(b, t, k)
    neg_prob = torch.softmax(scores / cfg.softmax_temperature, dim=-1)
    # each negative's probability in the step's ranking; repeated ids (the
    # padding sentinel) share one pool row and so one probability
    ids, probs = fetches["predicted_ids"], fetches["predicted_probs"]
    match = fetches["neg_items"][..., :, None] == ids[..., None, :]
    step_neg = (match * probs[..., None, :]).sum(-1) / match.sum(-1)
    step_neg = step_neg / step_neg.sum(-1, keepdim=True)
    mask = valid_click_mask(batch["session_size"], t)
    assert mask.any()
    torch.testing.assert_close(neg_prob[mask], step_neg[mask], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_pooled_forward_matches_jax(world, fused):
    """The model's pooled grid path alone, with novelty regularisation on,
    for a pool and indices from the JAX sampler."""
    cfg = config(use_pallas_scorer=fused, novelty_reg_factor=0.1)
    jax_stream = warm_stream(world, cfg, 1)
    (jax_batch,) = jax_batches(world, cfg, 1)[:1]
    all_clicked, _ = jax_batch_all_clicks(jax_batch)
    pool, idx, ids = jax_sample_negatives_pooled(
        jax.random.PRNGKey(5), all_clicked, jax_stream.buffer_ids,
        num_negatives=cfg.eval_negative_samples,
        buffer_sample_size=cfg.eval_negative_sample_from_buffer,
    )
    idx, ids = idx[:, :-1], ids[:, :-1]
    jax_out = build_nar_train(cfg, world["sess"], world["art"]).model.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, world["params"])},
        jax_batch,
        JaxNARAux(world["ace"], world["metadata"], jax_stream.recent_pop_norm,
                  jax_stream.buffer_ids),
        ids, train=False, rank=True, neg_pool=pool, neg_pool_idx=idx,
    )
    ace, metadata = port_aux_consts(world)
    stream = to_port_stream(jax_stream)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jax_batch.items()}
    with torch.inference_mode():
        out = port_model(world, cfg)(
            batch, NARAux(ace, metadata, stream.recent_pop_norm, stream.buffer_ids),
            torch.tensor(np.asarray(ids)), rank=True,
            neg_pool=torch.tensor(np.asarray(pool)),
            neg_pool_idx=torch.tensor(np.asarray(idx)),
        )
    np.testing.assert_allclose(out.items_prob.numpy(), np.asarray(jax_out.items_prob),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.predicted_probs.numpy(),
                               np.asarray(jax_out.predicted_probs),
                               rtol=1e-5, atol=1e-6)
    for name in ("ce_loss", "nov_reg_loss"):
        assert float(getattr(out, name)) == pytest.approx(
            float(getattr(jax_out, name)), rel=1e-5
        ), name
    assert float(out.nov_reg_loss) > 0
    np.testing.assert_array_equal(out.candidate_ids.numpy(),
                                  np.asarray(jax_out.candidate_ids))
    np.testing.assert_array_equal(out.loss_mask.numpy(), np.asarray(jax_out.loss_mask))


def test_forward_raises_on_paths_not_ported(world):
    model = port_model(world, config())
    # compacted rows serve the train path only, as in the JAX package
    with pytest.raises(ValueError, match="scoring_rows"):
        model({}, None, torch.zeros(1, 1, 1), rank=True, scoring_rows=(None, None))
    with pytest.raises(NotImplementedError):
        model({}, None, torch.zeros(1, 1, 1), candidate_positions=torch.zeros(1),
              scoring_rows=(None, None))
    with pytest.raises(NotImplementedError, match="neg_pool"):
        model({}, None, torch.zeros(1, 1, 1))

"""The port's NAR train step against the JAX package's ``train_step_fn``.

A tiny JAX NARModel (matching layers 16/8/8, so that ``use_pallas_scorer``
reaches the fused scorer) is initialised by ``nar_init_state``, its params
perturbed and converted with ``params_from_flax``.  Both sides start from the
same stream, warmed over two hours of clicks (on a cold stream the jitted
JAX step's novelty feature is ill-conditioned, ROADMAP section 3; warm, the
jitted step is driven), and take the same collated batches.  The sampler's
uniforms are drawn from the JAX ``state.rng`` the way ``build_nar_train``
splits it (``_split_state_rng``, ``_forward_and_negatives``,
``sample_negatives_pooled_rows``) and injected into the port.  The JAX side
runs its Pallas kernels in interpret mode, as it selects off-TPU; the port
runs on the CPU, where its kernel wrappers take the plain twins.

Tolerances (all float32): ``loss``, ``ce_loss`` and ``reg_loss`` at rel
1e-5; every gradient leaf at rtol 5e-4 / atol 5e-6, the tolerances of
``tests/test_row_compaction.py`` (near-zero leaves differ by the reduction
order of the two frameworks); the parameters after one Adam step at rtol
1e-4 / atol 1e-5, leaving out the elements whose gradient is under 5e-6 but not 0:
Adam's first step moves every element by about +-lr whatever the size of its
gradient, so where the two gradients are within rounding of 0 their signs,
and so the updates, may differ.  The loss trajectory over 30 steps at rel
1e-4 (the differences above, compounded by 30 steps); the sampler, the
compaction and the stream exactly.

The train steps run at the G1 configuration's learning rate, 1e-4 (the
``NARConfig`` default), not the tiny test configuration's 1e-3.  Some
gradient elements are 0 in exact arithmetic (a matching bias, wherever its
unit's leaky regime is the same across a row's candidates, shifts every
score of the row alike, and the softmax ignores the shift); both frameworks
give them f32 noise of ~1e-8 with either sign, which Adam's normalised
first step turns into a move of up to ~lr either way.  At lr 1e-3 that
drift alone moved the 30-step losses apart by up to 2.7e-3 relative; at
1e-4 by under 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.data.synthetic import make_synthetic_corpus, synthetic_hour_sessions
from chameleon_recsys_tpu.models.nar import NARAux as JaxNARAux
from chameleon_recsys_tpu.models.nar import l2_regularization as jax_l2_regularization
from chameleon_recsys_tpu.ops.sampling import (
    sample_negatives_pooled_rows as jax_sample_negatives_pooled_rows,
)
from chameleon_recsys_tpu.train.steps import (
    _batch_all_clicks as jax_batch_all_clicks,
    build_nar_train,
    nar_init_state,
    valid_click_mask as jax_valid_click_mask,
)
from chameleon_recsys_tpu.data.collate import collate_sessions as jax_collate

from chameleon_recsys_tpu_torch.convert import flax_from_tensors
from chameleon_recsys_tpu_torch.ops import sampling
from chameleon_recsys_tpu_torch.ops.kernels import cand_scorer, ugrnn
from chameleon_recsys_tpu_torch.ops.sampling import SamplerUniforms
from chameleon_recsys_tpu_torch.train.loss import is_regularized, l2_regularization
from chameleon_recsys_tpu_torch.train.steps import (
    compact_valid_rows,
    init_train_state,
    train_step,
)

from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema
from test_torch_eval_step import (
    jax_batches,
    port_aux_consts,
    port_model,
    to_port_stream,
    warm_stream,
)

NUM_ITEMS = 200
MATCHING = (16, 8, 8)
STEPS = 30
G1_LEARNING_RATE = 1e-4


def config(**overrides):
    return tiny_nar_config(matching_layer_sizes=MATCHING, **overrides)


@pytest.fixture(scope="module")
def world():
    art = tiny_article_schema(NUM_ITEMS)
    sess = tiny_session_schema(NUM_ITEMS)
    cfg = config()
    corpus = make_synthetic_corpus(art, ace_dim=8)
    hours = [
        synthetic_hour_sessions(corpus, sess, h, 2 * cfg.batch_size,
                                cfg.max_session_length)
        for h in range(4)
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
    world = dict(art=art, sess=sess, corpus=corpus, hours=hours, ace=ace,
                 metadata=metadata, state=state, params=params)
    batches = jax_batches(world, cfg, 2) + jax_batches(world, cfg, 3)
    max_valid = max(
        int(jax_valid_click_mask(b["session_size"], cfg.max_inputs_length, xp=np).sum())
        for b in batches
    )
    # as bench.py sizes it, rounded to the fused scorer's 8-row tile
    world["capacity"] = min(-(-max_valid // 8) * 8,
                            cfg.batch_size * cfg.max_inputs_length)
    world["batches"] = batches
    return world


def jax_train_uniforms(cfg, raw_rng, rows, b, l, buffer_size):
    """The uniforms ``train_step_fn`` draws from ``state.rng`` (per selected
    row with a capacity, per click of the grid without), and the state's
    next rng."""
    key = jax.random.wrap_key_data(raw_rng, impl=cfg.rng_impl)
    rng, step_rng = jax.random.split(key)
    rng_neg, _ = jax.random.split(step_rng)
    rng_buf, rng_pool, rng_u = jax.random.split(rng_neg, 3)
    m = cfg.negative_sample_from_buffer
    nc = min(cfg.negative_samples * cfg.neg_sampling_multiplying_factor, b * l + m)
    click_shape = (b, l, nc) if rows is None else (rows, nc)

    def uniform(r, shape):
        return torch.tensor(np.asarray(jax.random.uniform(r, shape)))

    uniforms = SamplerUniforms(
        buffer=uniform(rng_buf, (buffer_size,)),
        pool=uniform(rng_pool, (b * l + m,)),
        click=uniform(rng_u, click_shape),
    )
    return uniforms, jax.random.key_data(rng)


def jax_compaction(batch, cap):
    """The ``groups == 1`` compaction of ``build_nar_train``
    (chameleon_recsys_tpu/train/steps.py:181-190, 218), jnp as there."""
    item_clicked = batch["item_clicked"]
    b, t = item_clicked.shape
    mask = jax_valid_click_mask(batch["session_size"], t).reshape(-1)
    n_valid = jnp.sum(mask.astype(jnp.int32))
    mi = mask.astype(jnp.int32)
    dest = jnp.where(mask, jnp.cumsum(mi) - 1, n_valid + jnp.cumsum(1 - mi) - 1)
    perm = jnp.zeros((b * t,), jnp.int32).at[dest].set(
        jnp.arange(b * t, dtype=jnp.int32), unique_indices=True
    )
    rows_sel = perm[:cap]
    row_mask = mask[rows_sel].astype(jnp.float32)
    row_click = item_clicked.reshape(-1)[rows_sel]
    dropped = (n_valid - jnp.sum(row_mask)).astype(jnp.float32)
    return rows_sel, row_mask, row_click, dropped


def jax_loss_and_grads(cfg, world, params, stream, batch):
    """``train_step_fn``'s loss and gradients (its ``loss_fn`` under
    ``jax.value_and_grad``), for the compacted path and ``state.rng``."""
    model = build_nar_train(cfg, world["sess"], world["art"]).model
    key = jax.random.wrap_key_data(world["state"].rng, impl=cfg.rng_impl)
    _, step_rng = jax.random.split(key)
    rng_neg, rng_drop = jax.random.split(step_rng)
    all_clicked, _ = jax_batch_all_clicks(batch)
    rows_sel, row_mask, row_click, _ = jax_compaction(
        batch, cfg.train_valid_row_capacity
    )
    t = batch["item_clicked"].shape[1]
    pool, idx, ids = jax_sample_negatives_pooled_rows(
        rng_neg, all_clicked, stream.buffer_ids, rows_sel // t, row_click,
        num_negatives=cfg.negative_samples,
        buffer_sample_size=cfg.negative_sample_from_buffer,
        mult=cfg.neg_sampling_multiplying_factor,
    )
    aux = JaxNARAux(world["ace"], world["metadata"], stream.recent_pop_norm,
                    stream.buffer_ids)

    def loss_fn(p):
        out = model.apply(
            {"params": p}, batch, aux, ids, train=True, rank=False,
            neg_pool=pool, neg_pool_idx=idx, scoring_rows=(rows_sel, row_mask),
            rngs={"dropout": rng_drop},
        )
        reg = jax_l2_regularization(p, cfg.reg_weight_decay)
        return out.ce_loss + reg - out.nov_reg_loss, (out.ce_loss, reg)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def port_setup(world, cfg):
    model = port_model(world, cfg)
    stream = to_port_stream(warm_stream(world, cfg, 2))
    ace, metadata = port_aux_consts(world)
    return init_train_state(model, stream, torch.Generator()), ace, metadata


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the sampler and the compaction, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_sampler_matches_jax(world, seed):
    cfg = config()
    stream = warm_stream(world, cfg, 1)
    batch = world["batches"][seed]
    all_clicked, _ = jax_batch_all_clicks(batch)
    rng = np.random.RandomState(seed)
    b, l = all_clicked.shape
    row_session = rng.randint(0, b, size=24).astype(np.int32)
    row_click = np.asarray(all_clicked)[row_session, rng.randint(0, l, size=24)]
    row_click[:3] = 0  # padding rows
    key = jax.random.PRNGKey(seed + 7)
    pool, idx, ids = jax_sample_negatives_pooled_rows(
        key, all_clicked, stream.buffer_ids, jnp.asarray(row_session),
        jnp.asarray(row_click), num_negatives=cfg.negative_samples,
        buffer_sample_size=cfg.negative_sample_from_buffer,
    )
    rng_buf, rng_pool, rng_u = jax.random.split(key, 3)
    m = cfg.negative_sample_from_buffer
    nc = min(cfg.negative_samples * cfg.neg_sampling_multiplying_factor, b * l + m)
    uniforms = SamplerUniforms(*(
        torch.tensor(np.asarray(jax.random.uniform(r, shape))) for r, shape in (
            (rng_buf, stream.buffer_ids.shape), (rng_pool, (b * l + m,)),
            (rng_u, (24, nc)),
        )
    ))
    got = sampling.sample_negatives_pooled_rows(
        torch.tensor(np.asarray(all_clicked)), torch.tensor(np.asarray(stream.buffer_ids)),
        torch.from_numpy(row_session), torch.from_numpy(row_click),
        num_negatives=cfg.negative_samples,
        buffer_sample_size=cfg.negative_sample_from_buffer, uniforms=uniforms,
    )
    for name, a, e in zip(("pool", "neg_idx", "neg_ids"), got, (pool, idx, ids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e), err_msg=name)
    assert (got[2][:3] == 0).all() and (got[2][3:] != 0).any()
    # the generator path draws [M, NC] keys
    drawn = sampling.sample_negatives_pooled_rows(
        torch.tensor(np.asarray(all_clicked)), torch.tensor(np.asarray(stream.buffer_ids)),
        torch.from_numpy(row_session), torch.from_numpy(row_click),
        num_negatives=cfg.negative_samples,
        buffer_sample_size=cfg.negative_sample_from_buffer,
        generator=torch.Generator().manual_seed(seed),
    )
    assert drawn[1].shape == (24, cfg.negative_samples)


@pytest.mark.parametrize("cap", ["fit", 16, 1000])
def test_compaction_matches_jax(world, cap):
    for batch in world["batches"]:
        capacity = world["capacity"] if cap == "fit" else cap
        expected = jax_compaction(batch, capacity)
        got = compact_valid_rows(torch.from_numpy(np.array(batch["session_size"])),
                                 torch.from_numpy(np.array(batch["item_clicked"])),
                                 capacity)
        for name, a, e in zip(("rows_sel", "row_mask", "row_click", "dropped"),
                              (got.rows_sel, got.row_mask, got.row_click, got.dropped),
                              expected):
            np.testing.assert_array_equal(a.numpy(), np.asarray(e), err_msg=name)
        n_valid = int(got.n_valid)
        assert float(got.dropped) == max(n_valid - capacity, 0)


def test_l2_regularization_matches_jax(world):
    cfg = config(reg_weight_decay=1e-3)
    model = port_model(world, cfg)
    expected = float(jax_l2_regularization(
        jax.tree_util.tree_map(jnp.asarray, world["params"]), cfg.reg_weight_decay
    ))
    assert float(l2_regularization(model, cfg.reg_weight_decay).detach()) == pytest.approx(
        expected, rel=1e-6
    )
    names = [n for n, _ in model.named_parameters()]
    excluded = [n for n in names if not is_regularized(n)]
    assert "rnn.layers.0.input_proj.weight" in excluded
    assert all(n.startswith("rnn.") or n.endswith("bias") for n in excluded)
    assert "gamma_scale" in names and is_regularized("beta_center")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


CASES = {
    "kernels_on": dict(use_pallas_scorer=True, use_pallas_rnn=True),
    "kernels_off": dict(use_pallas_scorer=False, use_pallas_rnn=False),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, world):
    cfg = config(train_valid_row_capacity=world["capacity"], novelty_reg_factor=0.1,
                 learning_rate=G1_LEARNING_RATE, **CASES[request.param])
    return request.param, cfg


def test_one_train_step_matches_jax(world, case):
    name, cfg = case
    batch = world["batches"][0]
    jax_stream = warm_stream(world, cfg, 2)
    params = jax.tree_util.tree_map(jnp.asarray, world["params"])
    (loss, (ce, reg)), grads = jax_loss_and_grads(cfg, world, params, jax_stream, batch)
    programs = build_nar_train(cfg, world["sess"], world["art"])
    jax_state = world["state"]._replace(
        params=params, opt_state=programs.optimizer.init(params), stream=jax_stream
    )
    new_state, jax_metrics = jax.jit(programs.train_step_fn)(
        jax_state, batch, world["ace"], world["metadata"]
    )
    # the replica of loss_fn is train_step_fn's
    assert float(jax_metrics["loss"]) == pytest.approx(float(loss), rel=1e-6)

    state, ace, metadata = port_setup(world, cfg)
    rows = min(cfg.train_valid_row_capacity, cfg.batch_size * cfg.max_inputs_length)
    uniforms, _ = jax_train_uniforms(cfg, jax_state.rng, rows, cfg.batch_size,
                                     cfg.max_session_length,
                                     cfg.recent_clicks_buffer_max_size)
    launches = (cand_scorer.launches, cand_scorer.stash_launches,
                cand_scorer.bwd_launches, ugrnn.launches, ugrnn.bwd_launches)
    state, metrics = train_step(state, to_torch(batch), ace, metadata,
                                uniforms=uniforms)
    # the CPU path launches no kernel
    assert launches == (cand_scorer.launches, cand_scorer.stash_launches,
                        cand_scorer.bwd_launches, ugrnn.launches, ugrnn.bwd_launches)

    assert set(metrics) == set(jax_metrics)
    for key in ("loss", "ce_loss", "reg_loss"):
        assert float(metrics[key]) == pytest.approx(float(jax_metrics[key]),
                                                    rel=1e-5), key
    for key in ("sessions", "clicks", "dropped_clicks"):
        assert float(metrics[key]) == float(jax_metrics[key]), key
    assert float(metrics["dropped_clicks"]) == 0 and float(reg) > 0

    model = state.model
    jax_grads, port_grads = leaves(grads), leaves(flax_from_tensors(
        {n: p.grad for n, p in model.named_parameters()}))
    assert set(port_grads) == set(jax_grads)
    for path, expected in jax_grads.items():
        np.testing.assert_allclose(port_grads[path], expected, rtol=5e-4, atol=5e-6,
                                   err_msg=path)
    jax_params = leaves(new_state.params)
    port_params = leaves(flax_from_tensors(dict(model.named_parameters())))
    compared = 0
    for path, expected in jax_params.items():
        # an exact 0 (an embedding row the batch does not touch) stays put
        moved = (np.abs(jax_grads[path]) >= 5e-6) | (jax_grads[path] == 0)
        np.testing.assert_allclose(port_params[path][moved], expected[moved],
                                   rtol=1e-4, atol=1e-5, err_msg=path)
        compared += int(moved.sum())
    assert compared > 0.85 * sum(v.size for v in jax_params.values())
    for field in new_state.stream._fields:
        np.testing.assert_array_equal(getattr(state.stream, field).numpy(),
                                      np.asarray(getattr(new_state.stream, field)),
                                      err_msg=field)


def test_loss_trajectory_matches_jax(world, case):
    name, cfg = case
    params = jax.tree_util.tree_map(jnp.asarray, world["params"])
    programs = build_nar_train(cfg, world["sess"], world["art"])
    jax_state = world["state"]._replace(
        params=params, opt_state=programs.optimizer.init(params),
        stream=warm_stream(world, cfg, 2),
    )
    step_fn = jax.jit(programs.train_step_fn)
    state, ace, metadata = port_setup(world, cfg)
    rows = min(cfg.train_valid_row_capacity, cfg.batch_size * cfg.max_inputs_length)
    batches = world["batches"]
    losses, jax_losses = [], []
    for i in range(STEPS):
        batch = batches[i % len(batches)]
        uniforms, _ = jax_train_uniforms(cfg, jax_state.rng, rows, cfg.batch_size,
                                         cfg.max_session_length,
                                         cfg.recent_clicks_buffer_max_size)
        jax_state, jax_metrics = step_fn(jax_state, batch, world["ace"],
                                         world["metadata"])
        state, metrics = train_step(state, to_torch(batch), ace, metadata,
                                    uniforms=uniforms)
        losses.append(float(metrics["loss"]))
        jax_losses.append(float(jax_metrics["loss"]))
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert state.step == STEPS
    # it trains: the loss on the batches seen falls
    assert np.mean(losses[-len(batches):]) < np.mean(losses[:len(batches)])


def test_grid_train_step_without_capacity_matches_jax(world):
    """Without a capacity the step scores the whole grid, fused."""
    cfg = config(use_pallas_scorer=True, use_pallas_rnn=True,
                 learning_rate=G1_LEARNING_RATE)
    batch = world["batches"][1]
    params = jax.tree_util.tree_map(jnp.asarray, world["params"])
    programs = build_nar_train(cfg, world["sess"], world["art"])
    jax_state = world["state"]._replace(
        params=params, opt_state=programs.optimizer.init(params),
        stream=warm_stream(world, cfg, 2),
    )
    _, jax_metrics = jax.jit(programs.train_step_fn)(
        jax_state, batch, world["ace"], world["metadata"])
    state, ace, metadata = port_setup(world, cfg)
    uniforms, _ = jax_train_uniforms(cfg, jax_state.rng, None, cfg.batch_size,
                                     cfg.max_session_length,
                                     cfg.recent_clicks_buffer_max_size)
    _, metrics = train_step(state, to_torch(batch), ace, metadata, uniforms=uniforms)
    assert "dropped_clicks" not in metrics and set(metrics) == set(jax_metrics)
    for key in ("loss", "ce_loss", "reg_loss"):
        assert float(metrics[key]) == pytest.approx(float(jax_metrics[key]),
                                                    rel=1e-5), key


def test_train_step_raises_on_what_is_not_ported(world):
    state, ace, metadata = port_setup(world, config(
        train_valid_row_capacity=16, train_compaction_groups=2))
    with pytest.raises(NotImplementedError, match="groups"):
        train_step(state, to_torch(world["batches"][0]), ace, metadata)
    state, ace, metadata = port_setup(world, config(keep_prob=0.8))
    with pytest.raises(NotImplementedError, match="dropout"):
        train_step(state, to_torch(world["batches"][0]), ace, metadata,
                   uniforms=None)


def test_train_scorer_operands_are_the_train_steps(world):
    """``train_scorer_operands`` gives back the fused scorer's operands of the
    train step with the same arguments: the plain twin's scores on them,
    softmaxed over the K negatives, are the step's forward's negative
    probabilities renormalised, at every selected valid row (f32)."""
    from chameleon_recsys_tpu_torch.train.steps import _train_inputs, train_scorer_operands

    cfg = config(train_valid_row_capacity=world["capacity"], use_pallas_scorer=True)
    model = port_model(world, cfg)
    stream = to_port_stream(warm_stream(world, cfg, 2))
    ace, metadata = port_aux_consts(world)
    batch = to_torch(world["batches"][2])
    rows = min(cfg.train_valid_row_capacity, cfg.batch_size * cfg.max_inputs_length)
    uniforms, _ = jax_train_uniforms(cfg, world["state"].rng, rows, cfg.batch_size,
                                     cfg.max_session_length,
                                     cfg.recent_clicks_buffer_max_size)
    operands = train_scorer_operands(model, stream, batch, ace, metadata,
                                     generator=torch.Generator(), uniforms=uniforms)
    k = cfg.negative_samples
    assert len(operands) == 12 and operands[0].shape == (rows * k, cfg.car_embedding_size)
    inputs = _train_inputs(model, stream, batch, ace, metadata, torch.Generator(),
                           uniforms)
    with torch.no_grad():
        out = model(batch, inputs.aux, inputs.neg_ids, train=True, neg_pool=inputs.pool,
                    neg_pool_idx=inputs.neg_idx, scoring_rows=inputs.scoring_rows)
        scores = (cand_scorer.cand_score_reference(*operands)
                  + model.matching_out_bias[0]).reshape(rows, k)
    neg_prob = torch.softmax(scores / cfg.softmax_temperature, dim=-1)
    step_neg = out.items_prob[:, 1:] / out.items_prob[:, 1:].sum(-1, keepdim=True)
    valid = inputs.scoring_rows[1] > 0
    assert valid.any()
    torch.testing.assert_close(neg_prob[valid], step_neg[valid], rtol=1e-5, atol=1e-6)

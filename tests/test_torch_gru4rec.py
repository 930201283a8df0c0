"""GRU4Rec: the port (``chameleon_recsys_tpu_torch/baselines/gru4rec.py``)
against the JAX package's, on the CPU.

Both start from JAX's initial weights (``convert.gru4rec_params_from_jax``);
the port's negative draws (``gru4rec._draw_negative_indices``) and dropout
masks (``ops/dropout.py::_draw_mask``) are replaced by the ones JAX draws,
reproduced from its key chain (``jax_draws``).  Tolerances: each loss on the
same scores, and its gradient, at rel 1e-5 (the same f32 formulas); the
recurrence's states at 1e-5; the optimizer's parameters after 5 steps at
rtol 1e-5 / atol 1e-6 (optax's own test of the JAX rule); parameters after a
few ``fit_batch`` steps at 1e-5 and each step's loss at rel 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chameleon_recsys_tpu.baselines import gru4rec as jax_gru4rec

from chameleon_recsys_tpu_torch.baselines import gru4rec
from chameleon_recsys_tpu_torch.convert import gru4rec_params_from_jax
from chameleon_recsys_tpu_torch.ops import dropout as port_dropout

LOSS_NAMES = ("bpr-max", "cross-entropy", "bpr", "top1", "top1-max")


def jax_fields(params):
    return {k: jax.tree_util.tree_map(np.asarray, v) for k, v in params._asdict().items()}


def port_from_jax(jax_model, **kwargs):
    """A port ``GRU4Rec`` with the JAX model's hyperparameters and weights."""
    model = gru4rec.GRU4Rec(jax_model.n_items, layers=jax_model.layers,
                            n_sample=jax_model.n_sample, device="cpu", **kwargs)
    model.params.load_state_dict(gru4rec_params_from_jax(jax_fields(jax_model.params),
                                                         model.params))
    return model


def jax_draws(model, items, buffer_ids):
    """What ``GRU4RecJax.fit_batch`` is about to draw: its negative indices
    and, with dropout, each layer's keep mask, from the keys it will split."""
    nonzero = buffer_ids[buffer_ids != 0]
    n_valid = max(min(len(nonzero), model.neg_pool_capacity), 1)
    _, key, drop_rng = jax.random.split(model.rng, 3)
    indices = np.asarray(jax.random.randint(key, (model.n_sample,), 0, n_valid))
    masks = []
    if model.dropout_p_hidden > 0.0:
        for units in model.layers:
            drop_rng, key = jax.random.split(drop_rng)
            masks.append(np.asarray(jax.random.bernoulli(
                key, 1.0 - model.dropout_p_hidden, items.shape + (units,))))
    return indices, masks


def inject(monkeypatch, negatives, masks):
    """Makes the port draw ``negatives`` and ``masks`` (lists consumed in
    order) in place of its own."""
    def negative_indices(n_sample, n_valid, generator):
        indices = negatives.pop(0)
        assert len(indices) == n_sample and indices.max() < n_valid
        return torch.tensor(indices, dtype=torch.long)

    def mask(shape, keep, generator, device):
        m = masks.pop(0)
        assert tuple(m.shape) == tuple(shape)
        return torch.from_numpy(m.copy())

    monkeypatch.setattr(gru4rec, "_draw_negative_indices", negative_indices)
    monkeypatch.setattr(port_dropout, "_draw_mask", mask)


def _padded_scores(seed, steps=3, n=4, n_sample=3):
    rng = np.random.RandomState(seed)
    scores = rng.randn(steps, n, n + n_sample).astype(np.float32)
    valid_row = rng.rand(steps, n) > 0.3
    valid_row[:, 0] = True
    valid_col = np.concatenate([valid_row, np.ones((steps, n_sample), bool)], axis=1)
    return scores, valid_row, valid_col


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_loss_and_its_gradient_match_jax(name):
    """Each loss on the same scores with padded rows and columns, batched
    over three steps in the port and one step at a time in JAX, and the
    gradient of their sum, at rel 1e-5."""
    scores, valid_row, valid_col = _padded_scores(seed=LOSS_NAMES.index(name))
    jax_fn, port_fn = jax_gru4rec.LOSSES[name], gru4rec.LOSSES[name]

    def jax_total(s):
        return sum(jax_fn(s[i], jnp.asarray(valid_row[i]), jnp.asarray(valid_col[i]), 0.5)
                   for i in range(len(s)))

    expected = [float(jax_fn(jnp.asarray(scores[i]), jnp.asarray(valid_row[i]),
                             jnp.asarray(valid_col[i]), 0.5)) for i in range(len(scores))]
    expected_grad = np.asarray(jax.grad(jax_total)(jnp.asarray(scores)))
    s = torch.tensor(scores, requires_grad=True)
    got = port_fn(s, torch.from_numpy(valid_row), torch.from_numpy(valid_col), 0.5)
    np.testing.assert_allclose(got.detach().numpy(), expected, rtol=1e-5)
    got.sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), expected_grad, rtol=1e-5, atol=1e-7)


def test_parse_loss_reference_strings():
    assert gru4rec.parse_loss("bpr-max-0.5") == ("bpr-max", 0.5)
    assert gru4rec.parse_loss("bpr-max", 0.25) == ("bpr-max", 0.25)
    assert gru4rec.parse_loss("top1") == ("top1", 0.5)
    assert gru4rec.parse_loss("cross-entropy")[0] == "cross-entropy"
    with pytest.raises(ValueError):
        gru4rec.parse_loss("nope")


def _batch(seed, n_items, b=4, t=5):
    rng = np.random.RandomState(seed)
    items = rng.randint(1, n_items, size=(b, t))
    labels = rng.randint(1, n_items, size=(b, t))
    items[1, 3:], labels[1, 2:] = 0, 0  # a padded session
    labels[-1, -1] = 0
    return items, labels


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_recurrence_matches_jax(p, monkeypatch):
    """Two layers over padded steps, without dropout and with JAX's masks,
    at 1e-5."""
    jax_model = jax_gru4rec.GRU4RecJax(40, layers=(12, 8), dropout_p_hidden=p, seed=3)
    model = port_from_jax(jax_model, dropout_p_hidden=p)
    items, labels = _batch(0, 40)
    mask = labels != 0
    drop_rng = jax.random.PRNGKey(11) if p else None
    expected = jax_gru4rec._forward_states(jax_model.params, jnp.asarray(items),
                                           jnp.asarray(mask), (12, 8), p, drop_rng)
    masks = []
    if p:
        for units in (12, 8):
            drop_rng, key = jax.random.split(drop_rng)
            masks.append(np.asarray(jax.random.bernoulli(key, 1.0 - p,
                                                         items.shape + (units,))))
    inject(monkeypatch, [], masks)
    got = gru4rec.forward_states(model.params, torch.from_numpy(items),
                                 torch.from_numpy(mask), p)
    assert not masks
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expected), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("momentum,lmbd", [(0.0, 0.0), (0.5, 0.01)],
                         ids=["plain", "momentum_l2"])
@pytest.mark.parametrize("adapt", gru4rec.ADAPTATIONS)
def test_optimizer_matches_optax(adapt, momentum, lmbd):
    """``ReferenceOptimizer`` against the JAX ``make_reference_optimizer``
    over 5 steps of the same gradients, each adaptation alone and with
    momentum and decayed weights."""
    lr, decay = 0.1, 0.9
    opt = jax_gru4rec.make_reference_optimizer(adapt, lr, decay=decay, momentum=momentum,
                                               lmbd=lmbd)
    rng = np.random.RandomState(5)
    init = rng.randn(2, 4).astype(np.float32)
    p_jax = jnp.asarray(init)
    state = opt.init(p_jax)
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    port_opt = gru4rec.ReferenceOptimizer([p], adapt, lr, decay=decay, momentum=momentum,
                                          lmbd=lmbd)
    for _ in range(5):
        g = rng.randn(2, 4).astype(np.float32)
        updates, state = opt.update(jnp.asarray(g), state, p_jax)
        p_jax = optax.apply_updates(p_jax, updates)
        p.grad = torch.from_numpy(g)
        port_opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_jax), rtol=1e-5, atol=1e-6)


def test_optimizer_rejects_an_unknown_rule():
    with pytest.raises(ValueError, match="unknown GRU4Rec optimizer"):
        gru4rec.ReferenceOptimizer([torch.nn.Parameter(torch.zeros(1))], "lion")


def _assert_params_close(model, jax_model, tol=1e-5):
    got = model.params.state_dict()
    for key, value in gru4rec_params_from_jax(jax_fields(jax_model.params),
                                              model.params).items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=tol, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("loss,optimizer,p", [
    ("bpr-max", "adagrad", 0.0),  # the published configuration's rule
    ("top1-max", "adam", 0.2),
    ("cross-entropy", "rmsprop", 0.0),
])
def test_fit_batch_steps_match_jax(loss, optimizer, p, monkeypatch):
    """Four ``fit_batch`` steps from JAX's weights with JAX's negatives (and
    masks): each step's loss at rel 1e-5, the parameters after at 1e-5.  The
    buffer is longer than the pool's capacity, which decides what is drawn."""
    kwargs = dict(loss=loss, optimizer=optimizer, dropout_p_hidden=p,
                  neg_pool_capacity=16, learning_rate=0.1)
    jax_model = jax_gru4rec.GRU4RecJax(40, layers=(12, 8), n_sample=6, seed=3, **kwargs)
    model = port_from_jax(jax_model, **kwargs)
    negatives, masks = [], []
    inject(monkeypatch, negatives, masks)
    rng = np.random.RandomState(1)
    for step in range(4):
        items, labels = _batch(10 + step, 40)
        buffer_ids = rng.randint(0, 40, size=30)
        indices, step_masks = jax_draws(jax_model, items, buffer_ids)
        negatives.append(indices)
        masks.extend(step_masks)
        expected = float(jax_model.fit_batch(items, labels, buffer_ids))
        got = model.fit_batch(items, labels, buffer_ids)
        assert got.shape == () and not got.requires_grad
        assert float(got) == pytest.approx(expected, rel=1e-5)
    assert not negatives and not masks
    _assert_params_close(model, jax_model)


def test_negatives_come_from_the_buffer_cut_to_capacity(monkeypatch):
    """The draw is over the buffer's first ``neg_pool_capacity`` nonzero ids:
    a buffer of one valid id trains as JAX's step with every negative that
    id, and a long buffer is cut to the capacity."""
    seen = []
    draw = gru4rec._draw_negative_indices

    def recording(n_sample, n_valid, generator):
        seen.append(n_valid)
        return draw(n_sample, n_valid, generator)

    monkeypatch.setattr(gru4rec, "_draw_negative_indices", recording)
    jax_model = jax_gru4rec.GRU4RecJax(50, layers=(8,), n_sample=6, neg_pool_capacity=16)
    model = port_from_jax(jax_model, neg_pool_capacity=16)
    items, labels = _batch(2, 50, b=2, t=4)
    expected = jax_model._loss_for_batch(
        jax_model.params, jnp.asarray(items), jnp.asarray(labels),
        jnp.asarray(labels != 0), jnp.full((6,), 7), None)
    got = model.fit_batch(items, labels, np.array([7, 0, 0, 0]))
    assert float(got) == pytest.approx(float(expected), rel=1e-5)
    model.fit_batch(items, labels, np.arange(1, 41))
    model.fit_batch(items, labels, np.zeros(5, np.int64))  # empty: id 1
    assert seen == [1, 16, 1]


def test_rank_candidates_matches_jax():
    """The same ranked ids as JAX from the same weights, padding (id 0) last
    on every valid click."""
    jax_model = jax_gru4rec.GRU4RecJax(30, layers=(10,), seed=4)
    model = port_from_jax(jax_model)
    items, labels = _batch(3, 30)
    neg = np.random.RandomState(4).randint(0, 30, size=labels.shape + (6,))
    neg[0, 0, 3:] = 0
    got = model.rank_candidates(items, labels, neg)
    np.testing.assert_array_equal(got, jax_model.rank_candidates(items, labels, neg))
    assert (got[0, 0, -3:] == 0).all()
    model = gru4rec.GRU4Rec(20, layers=(8,), n_sample=4, seed=1, device="cpu")
    ranked = model.rank_candidates(np.array([[1, 2, 0]]), np.array([[2, 3, 0]]),
                                   np.array([[[4, 0], [5, 0], [0, 0]]]))
    assert ranked[0, 0, -1] == 0 and set(ranked[0, 0, :2].tolist()) == {2, 4}


def test_gru4rec_learns_transitions():
    """Deterministic item chains become predictable (the JAX package's own
    test of its model, on the port)."""
    n_items, b, t = 30, 8, 5
    model = gru4rec.GRU4Rec(n_items, layers=(16,), n_sample=8, learning_rate=0.5, seed=0,
                            device="cpu")
    rng = np.random.RandomState(0)
    buffer_ids = np.arange(1, n_items)

    def make_batch():
        starts = rng.randint(1, n_items - t - 1, size=b)
        items = np.stack([np.arange(s, s + t) for s in starts])  # chains i -> i+1
        return items, items + 1

    losses = [float(model.fit_batch(*make_batch(), buffer_ids)) for _ in range(150)]
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    items, labels = make_batch()
    ranked = model.rank_candidates(items, labels, rng.randint(1, n_items, size=(b, t, 5)))
    assert (ranked[:, :, 0] == labels).mean() > 0.5


def test_conversion_refuses_a_mismatched_tree():
    jax_model = jax_gru4rec.GRU4RecJax(20, layers=(8,))
    fields = jax_fields(jax_model.params)
    wider = gru4rec.GRU4RecParams(20, (9,))
    with pytest.raises(ValueError, match="shape"):
        gru4rec_params_from_jax(fields, wider)
    with pytest.raises(KeyError, match="missing"):
        gru4rec_params_from_jax({k: v for k, v in fields.items() if k != "by"},
                                gru4rec.GRU4RecParams(20, (8,)))

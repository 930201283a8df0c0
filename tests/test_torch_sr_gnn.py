"""SR-GNN: the port (``chameleon_recsys_tpu_torch/baselines/sr_gnn.py``)
against the JAX package's, on the CPU.

Both start from JAX's initial weights (``convert.srgnn_params_from_jax``)
and draw their negatives from numpy ``RandomState``s of one seed, so they
draw the same.  Tolerances: the session graphs bit for bit (the same numpy
code); logits at 1e-5; the staircase Adam against optax's over steps that
cross two decays at rtol 1e-5 / atol 1e-7; each ``fit_batch`` step's
cross-entropy at rel 1e-5 and the parameters after at 1e-5.  The loss's L2
term gives every element a gradient of l2 * p (about 1e-6 here), far above
f32 summation noise, so Adam's normalised step does not turn noise of
either sign into moves of ~lr (``ROADMAP.md`` §3.3) and 1e-5 holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chameleon_recsys_tpu.baselines import sr_gnn as jax_sr_gnn

from chameleon_recsys_tpu_torch.baselines import sr_gnn
from chameleon_recsys_tpu_torch.convert import srgnn_params_from_jax


def port_from_jax(jax_model, **kwargs):
    """A port ``SRGNN`` with the JAX model's widths and weights."""
    model = sr_gnn.SRGNN(jax_model.n_items, hidden_size=jax_model.hidden,
                         steps=jax_model.steps, device="cpu", **kwargs)
    fields = {k: np.asarray(v) for k, v in jax_model.params._asdict().items()}
    model.params.load_state_dict(srgnn_params_from_jax(fields, model.params))
    return model


def _sessions(seed, n_items, b=6, t=5):
    rng = np.random.RandomState(seed)
    items = rng.randint(1, n_items, size=(b, t))
    items[0, 2] = items[0, 0]  # a revisit: one node, two positions
    items[2, 3:] = 0
    items[4, 1:] = 0
    targets = rng.randint(1, n_items, size=b)
    targets[-1] = 0  # a row without a target
    return items, targets


def test_build_session_graphs_is_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    sessions = rng.randint(1, 6, size=(12, 7))  # small ids: repeats and cycles
    sessions[rng.rand(12, 7) < 0.2] = 0  # padding, inner gaps included
    sessions[3] = 0
    for got, expected in zip(sr_gnn.build_session_graphs(sessions),
                             jax_sr_gnn.build_session_graphs(sessions)):
        assert got.dtype == expected.dtype
        np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("steps", [1, 2])
def test_logits_match_jax(steps):
    """Propagation (one and two GNN steps), the readout and the scores."""
    jax_model = jax_sr_gnn.SRGNNJax(30, hidden_size=10, steps=steps, seed=1)
    model = port_from_jax(jax_model)
    items, targets = _sessions(2, 30)
    cand = np.random.RandomState(3).randint(1, 30, size=(len(items), 8))
    graphs = jax_sr_gnn.build_session_graphs(items)
    expected = jax_model._logits(jax_model.params, *map(jnp.asarray, graphs[:3]),
                                 jnp.asarray(graphs[3]), jnp.asarray(items != 0),
                                 jnp.asarray(cand))
    with torch.no_grad():
        got = model.logits(*model._graphs(items), torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-6)


def test_adam_with_staircase_decay_matches_optax():
    """``_OptaxAdam`` against ``optax.adam(exponential_decay(staircase))``
    over 7 steps with a decay every 3, the rate taken before each step."""
    schedule = optax.exponential_decay(1e-2, transition_steps=3, decay_rate=0.1,
                                       staircase=True)
    opt = optax.adam(schedule)
    rng = np.random.RandomState(4)
    init = rng.randn(3, 2).astype(np.float32)
    p_jax = jnp.asarray(init)
    state = opt.init(p_jax)
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    port_opt = sr_gnn._OptaxAdam([p], 1e-2, 0.1, 3)
    for _ in range(7):
        g = rng.randn(3, 2).astype(np.float32)
        updates, state = opt.update(jnp.asarray(g), state, p_jax)
        p_jax = optax.apply_updates(p_jax, updates)
        p.grad = torch.from_numpy(g)
        port_opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_jax), rtol=1e-5, atol=1e-7)


def test_fit_batch_steps_match_jax():
    """Six steps from JAX's weights, the rate decaying every 2 steps: each
    step's cross-entropy at rel 1e-5, every parameter after at 1e-5."""
    jax_model = jax_sr_gnn.SRGNNJax(30, hidden_size=10, seed=1, lr=5e-2, lr_dc_steps=2)
    model = port_from_jax(jax_model, lr=5e-2, lr_dc_steps=2)
    jax_rng, port_rng = np.random.RandomState(5), np.random.RandomState(5)
    buffer_ids = np.random.RandomState(6).randint(0, 30, size=50)
    for step in range(6):
        items, targets = _sessions(10 + step, 30)
        expected = float(jax_model.fit_batch(items, targets, buffer_ids, n_sample=7,
                                             rng=jax_rng))
        got = model.fit_batch(items, targets, buffer_ids, n_sample=7, rng=port_rng)
        assert got.shape == () and not got.requires_grad
        assert float(got) == pytest.approx(expected, rel=1e-5)
    for name in sr_gnn._PARAMS:
        np.testing.assert_allclose(getattr(model.params, name).detach().numpy(),
                                   np.asarray(getattr(jax_model.params, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_adapter_ranks_every_click_as_jax():
    """Per-click prefix ranking (JAX pads its rows to 256, the port does
    not): the same ranked ids, zeros at the padded clicks; training on each
    session's last label draws what JAX draws."""
    jax_model = jax_sr_gnn.SRGNNJax(25, hidden_size=8, seed=2)
    jax_adapter = jax_sr_gnn.SRGNNSessionAdapter(jax_model, n_sample=5)
    adapter = sr_gnn.SRGNNSessionAdapter(port_from_jax(jax_model), n_sample=5)
    assert adapter.recommender_name == "sr-gnn"
    rng = np.random.RandomState(7)
    items = rng.randint(1, 25, size=(4, 5))
    labels = rng.randint(1, 25, size=(4, 5))
    labels[1, 2:], items[1, 3:] = 0, 0
    labels[3] = 0
    neg = rng.randint(0, 25, size=(4, 5, 6))
    buffer_ids = rng.randint(0, 25, size=40)
    for _ in range(2):
        expected = float(jax_adapter.fit_batch(items, labels, buffer_ids))
        assert float(adapter.fit_batch(items, labels, buffer_ids)) == pytest.approx(
            expected, rel=1e-5)
    got = adapter.rank_candidates(items, labels, neg)
    np.testing.assert_array_equal(got, jax_adapter.rank_candidates(items, labels, neg))
    assert (got[labels == 0] == 0).all()
    empty = np.zeros_like(labels)
    assert adapter.fit_batch(items, empty, buffer_ids) == 0.0
    assert (adapter.rank_candidates(items, empty, neg) == 0).all()


def test_srgnn_learns_last_click():
    """Deterministic chains: the next item becomes predictable (the JAX
    package's own test of its model, on the port)."""
    n_items = 25
    model = sr_gnn.SRGNN(n_items, hidden_size=16, lr=5e-2, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    buffer_ids = np.arange(1, n_items)

    def make_batch(b=8, t=4):
        starts = rng.randint(1, n_items - t - 1, size=b)
        items = np.stack([np.arange(s, s + t) for s in starts])
        return items, items[:, -1] + 1

    losses = [float(model.fit_batch(*make_batch(), buffer_ids, n_sample=10, rng=rng))
              for _ in range(60)]
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    items, targets = make_batch()
    ranked = model.rank_candidates(items, targets, rng.randint(1, n_items, size=(8, 5)))
    assert (ranked[:, 0] == targets).mean() > 0.5


def test_conversion_refuses_a_mismatched_tree():
    fields = {k: np.asarray(v) for k, v in
              jax_sr_gnn.init_srgnn_params(jax.random.PRNGKey(0), 20, 6)._asdict().items()}
    with pytest.raises(ValueError, match="shape"):
        srgnn_params_from_jax(fields, sr_gnn.SRGNNParams(20, 7))
    with pytest.raises(KeyError, match="not consumed"):
        srgnn_params_from_jax({**fields, "extra": np.zeros(2)}, sr_gnn.SRGNNParams(20, 6))

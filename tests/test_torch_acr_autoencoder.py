"""The port's ACR autoencoder, ACR dropout and the RNN stacks' new inputs
against the JAX package, on the CPU.

Inputs come from numpy seeds; the port's weights are the JAX modules'
initial Flax params through ``convert.acr_params_from_flax``.  The JAX
side's random draws are read out and injected into the port: its dropout
masks through a Flax method interceptor (``tests/test_torch_dropout.py``'s
``dropout_calls``), the autoencoder's noise by wrapping
``jax.random.normal`` around an un-jitted apply (``models/acr.py::
_draw_noise`` takes it on the port's side).  Checked:

* ``ACRAutoencoderModel``: the ACE, the reconstruction and the loss, in
  training (noise 0; noise 0.1; noise 0.1 with dropout between two layers)
  and outside it, with a unidirectional and a bidirectional encoder (the
  latter with noise, and with dropout), within 1e-5 abs (f32 sums in
  another order);
* ``StackedGRU`` seeded with ``h0``, and ``StackedLSTM`` (both directions)
  with dropout between its layers (the autoencoder's cases hold the
  bidirectional GRU's): outputs and final states within 1e-5, the input's
  gradient within 1e-5;
* the classifier (CNN, GRU, LSTM) with dropout on the content, between the
  RNN layers and on the ACE: ACE, logits, loss within 1e-5, every gradient
  within 1e-5 abs;
* 8 autoencoder trainer steps (32 articles at batch 8, 2 epochs, two GRU
  layers) from the same weights with the global-norm clip active (an L2
  weight of 5 puts every step's norm past 5): the epoch losses,
  every parameter (normwise) and the ACE matrix within 1e-4, as
  ``tests/test_torch_acr.py``'s fit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.acr.trainer import ACRTrainer as JaxACRTrainer
from chameleon_recsys_tpu.config import ACRConfig as JaxACRConfig
from chameleon_recsys_tpu.models.acr import ACRAutoencoderModel as JaxAutoencoder
from chameleon_recsys_tpu.models.acr import ACRClassifierModel as JaxClassifier
from chameleon_recsys_tpu.models.acr import ACRLabelSpec as JaxLabelSpec
from chameleon_recsys_tpu.ops.rnn import StackedGRU as JaxStackedGRU
from chameleon_recsys_tpu.ops.rnn import StackedLSTM as JaxStackedLSTM

from chameleon_recsys_tpu_torch.acr import trainer as trainer_module
from chameleon_recsys_tpu_torch.acr.trainer import ACRTrainer
from chameleon_recsys_tpu_torch.config import ACRConfig
from chameleon_recsys_tpu_torch.convert import acr_params_from_flax
from chameleon_recsys_tpu_torch.models import acr as acr_module
from chameleon_recsys_tpu_torch.models.acr import (
    ACRAutoencoderModel,
    ACRClassifierModel,
    ACRLabelSpec,
)
from chameleon_recsys_tpu_torch.ops.rnn import StackedGRU, StackedLSTM

from test_torch_acr import Holder, numpy_tree
from test_torch_dropout import KEEP, dropout_calls, inject, masks_of  # noqa: F401

TOL = 1e-5
FIT_TOL = 1e-4
VOCAB, WORD_DIM, TEXT_LEN = 60, 8, 10


def corpus(n, seed=0, scale=0.3):
    rng = np.random.RandomState(seed)
    word_emb = (rng.randn(VOCAB, WORD_DIM) * scale).astype(np.float32)
    lengths = rng.randint(3, TEXT_LEN + 1, n)
    text = np.where(np.arange(TEXT_LEN)[None] < lengths[:, None],
                    rng.randint(2, VOCAB, (n, TEXT_LEN)), 0).astype(np.int32)
    return word_emb, text, lengths.astype(np.int32)


def config(cls, **overrides):
    fields = dict(training_task="autoencoder", text_feature_extractor="GRU",
                  word_embedding_size=WORD_DIM, vocab_size=VOCAB,
                  truncate_tokens_length=TEXT_LEN, acr_embeddings_size=6, rnn_units=9,
                  rnn_layers=2, learning_rate=3e-3, batch_size=8, training_epochs=2,
                  l2_reg_lambda=1e-3)
    fields.update(overrides)
    return cls(**fields)


def record_normal(monkeypatch):
    """Wrap ``jax.random.normal``: the list of what it returns."""
    drawn, normal = [], jax.random.normal
    monkeypatch.setattr(jax.random, "normal",
                        lambda *a, **k: drawn.append(normal(*a, **k)) or drawn[-1])
    return drawn


AE_CASES = {"noise0-uni": (0.0, 1.0, "unidirectional"),
            "noise-bi": (0.1, 1.0, "bidirectional"),
            "noise_dropout-uni": (0.1, KEEP, "unidirectional"),
            "noise_dropout-bi": (0.1, KEEP, "bidirectional")}


@pytest.mark.parametrize("case", list(AE_CASES))
def test_autoencoder_matches_jax(case, inject, monkeypatch):  # noqa: F811
    noise, keep, direction = AE_CASES[case]
    overrides = dict(autoencoder_noise=noise, dropout_keep_prob=keep, rnn_direction=direction)
    word_emb, text, lengths = corpus(6)
    special = np.random.RandomState(5).uniform(-0.04, 0.04, (1, WORD_DIM)).astype(np.float32)
    weights = np.array([1, 1, 1, 1, 0, 1], np.float32)
    jax_model = JaxAutoencoder(config(JaxACRConfig, **overrides))
    args = (jnp.asarray(text), jnp.asarray(lengths), jnp.asarray(word_emb),
            jnp.asarray(special), jnp.asarray(weights))
    params = jax.jit(lambda k: jax_model.init({"params": k}, *args, train=False))(
        jax.random.PRNGKey(2))["params"]
    model = ACRAutoencoderModel(config(ACRConfig, **overrides), word_emb)
    model.load_state_dict(acr_params_from_flax(numpy_tree(params), model))

    rngs = {"noise": jax.random.PRNGKey(7), "dropout": jax.random.PRNGKey(8)}
    drawn = record_normal(monkeypatch)

    def apply(p):
        return jax_model.apply({"params": p}, *args, train=True, rngs=rngs)

    calls = dropout_calls(apply, params)  # un-jitted: the normal is recorded
    want = [np.asarray(a) for a in apply(params)]
    assert len(drawn) == (2 if noise else 0)
    assert len(calls) == (2 if keep < 1 else 0)  # layer 1 of encoder, decoder
    monkeypatch.setattr(acr_module, "_draw_noise",
                        lambda shape, generator, device: torch.from_numpy(np.array(drawn[0])))
    inject(masks_of(calls))
    got = model(torch.from_numpy(text), torch.from_numpy(special),
                torch.from_numpy(weights), train=True)
    assert got[0].shape == (6, 6) and got[1].shape == (6, TEXT_LEN, WORD_DIM)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=TOL)
    # outside training: no noise, no dropout, nothing drawn
    want = jax.jit(lambda p: jax_model.apply({"params": p}, *args, train=False))(params)
    with torch.no_grad():
        got = model(torch.from_numpy(text), torch.from_numpy(special),
                    torch.from_numpy(weights))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


STACK_CASES = [("GRU", "unidirectional", True), ("LSTM", "bidirectional", False),
               ("LSTM", "unidirectional", False)]


@pytest.mark.parametrize("kind,direction,h0", STACK_CASES,
                         ids=[f"{k}-{d[:3]}{'-h0' if h else ''}" for k, d, h in STACK_CASES])
def test_stacked_rnn_dropout_and_h0_match_jax(kind, direction, h0, inject):  # noqa: F811
    jax_cls, port_cls = {"GRU": (JaxStackedGRU, StackedGRU),
                         "LSTM": (JaxStackedLSTM, StackedLSTM)}[kind]
    rng = np.random.RandomState(4)
    b, t, d, units = 5, 7, 6, 9
    x = rng.randn(b, t, d).astype(np.float32)
    seed_states = rng.randn(2, b, units).astype(np.float32) if h0 else None
    mask = jnp.ones((b, t), bool)
    module = jax_cls(units, 2, keep_prob=KEEP, direction=direction)
    params = jax.jit(module.init)(jax.random.PRNGKey(1), jnp.asarray(x), mask)["params"]
    kwargs = {} if seed_states is None else {"h0": [jnp.asarray(s) for s in seed_states]}

    def f(p, xs):
        return module.apply({"params": p}, xs, mask, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(9)}, **kwargs)

    (out, finals), vjp = jax.vjp(lambda xs: f(params, xs), jnp.asarray(x))
    g_out = rng.randn(*out.shape).astype(np.float32)
    (g_x,) = vjp((jnp.asarray(g_out), jnp.zeros_like(finals)))
    calls = dropout_calls(f, params, jnp.asarray(x))
    assert len(calls) == 1

    port = Holder(port_cls(d, units, 2, keep_prob=KEEP, direction=direction))
    port.load_state_dict(acr_params_from_flax({"rnn": numpy_tree(params)}, port))
    xt = torch.from_numpy(x).requires_grad_()
    inject(masks_of(calls))
    got_out, got_finals = port.encoder(
        xt, None if seed_states is None else torch.from_numpy(seed_states), train=True)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), atol=TOL)
    np.testing.assert_allclose(got_finals.detach().numpy(), np.asarray(finals), atol=TOL)
    got_out.backward(torch.from_numpy(g_out))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=TOL)


@pytest.mark.parametrize("extractor", ["CNN", "GRU", "LSTM"])
def test_classifier_dropout_matches_jax(extractor, inject):  # noqa: F811
    word_emb, text, lengths = corpus(8, seed=1)
    labels = {"category0": np.random.RandomState(2).randint(1, 5, 8)}
    cfg = dict(training_task="metadata_classification", text_feature_extractor=extractor,
               dropout_keep_prob=KEEP, rnn_direction="bidirectional",
               cnn_filter_sizes=(2, 3), cnn_num_filters=5)
    jax_model = JaxClassifier(config(JaxACRConfig, **cfg),
                              (JaxLabelSpec("category0", 5, "multiclass"),))
    params = jax.jit(lambda k: jax_model.init(
        {"params": k}, jnp.asarray(text), jnp.asarray(lengths), jnp.asarray(word_emb),
        train=False))(jax.random.PRNGKey(3))["params"]

    def apply(p):
        return jax_model.apply(
            {"params": p}, jnp.asarray(text), jnp.asarray(lengths), jnp.asarray(word_emb),
            labels={"category0": jnp.asarray(labels["category0"])}, train=True,
            rngs={"dropout": jax.random.PRNGKey(4)})

    want = jax.jit(apply)(params)
    grads = jax.jit(jax.grad(lambda p: apply(p).loss))(params)
    calls = jax.jit(lambda p: dropout_calls(apply, p))(params)
    assert len(calls) == (2 if extractor == "CNN" else 3)

    model = ACRClassifierModel(config(ACRConfig, **cfg), (ACRLabelSpec("category0", 5,
                                                                       "multiclass"),),
                               word_emb)
    model.load_state_dict(acr_params_from_flax(numpy_tree(params), model))
    inject(masks_of(calls))
    out = model(torch.from_numpy(text), {"category0": torch.from_numpy(labels["category0"])},
                train=True)
    np.testing.assert_allclose(out.ace.detach().numpy(), np.asarray(want.ace), atol=TOL)
    np.testing.assert_allclose(out.label_logits["category0"].detach().numpy(),
                               np.asarray(want.label_logits["category0"]), atol=TOL)
    assert float(out.loss) == pytest.approx(float(want.loss), abs=TOL)
    out.loss.backward()
    # the conversion adds the LSTM's forget bias to bias_hh: take it off again
    expected = acr_params_from_flax(numpy_tree(grads), model)
    offset = acr_params_from_flax(
        numpy_tree(jax.tree_util.tree_map(jnp.zeros_like, grads)), model)
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(),
                                   (expected[name] - offset[name]).numpy(), atol=TOL,
                                   err_msg=name)


def test_autoencoder_trainer_matches_jax(monkeypatch):
    """8 steps of the autoencoder's train step (L2, the global-norm clip,
    Adam) from the JAX trainer's initial weights, no noise, no dropout."""
    word_emb, text, lengths = corpus(32, seed=3)
    articles = {"article_id": np.arange(1, 33), "text": text, "text_length": lengths}
    # a strong L2 term puts every step's global norm past 5 (the clip
    # active) without saturating the GRUs, as large inputs would
    jax_t = JaxACRTrainer(config(JaxACRConfig, l2_reg_lambda=5.0), word_emb)
    jax_t.params = jax.jit(lambda k: jax_t.model.init(
        {"params": k}, jnp.asarray(text[:8]), jnp.asarray(lengths[:8]),
        jax_t.word_embeddings, jax_t.special_token_embedding, train=False))(
        jax.random.PRNGKey(0))["params"]
    jax_t.opt_state = jax_t.optimizer.init(jax_t.params)
    port_t = ACRTrainer(config(ACRConfig, l2_reg_lambda=5.0), word_emb, device="cpu")
    port_t.model.load_state_dict(acr_params_from_flax(numpy_tree(jax_t.params),
                                                      port_t.model))
    np.testing.assert_array_equal(port_t.special_token_embedding.numpy(),
                                  np.asarray(jax_t.special_token_embedding))
    norms, clip = [], trainer_module._clip_by_global_norm

    def recording_clip(params, max_norm):
        params = list(params)
        norms.append(float(torch.sqrt(sum(p.grad.square().sum() for p in params))))
        clip(params, max_norm)

    monkeypatch.setattr(trainer_module, "_clip_by_global_norm", recording_clip)
    jax_losses, port_losses = jax_t.fit(articles), port_t.fit(articles)
    assert len(norms) == 8 and min(norms) > 5.0, norms  # every step clipped
    np.testing.assert_allclose(port_losses, jax_losses, rtol=FIT_TOL)
    final = acr_params_from_flax(numpy_tree(jax_t.params), port_t.model)
    state = port_t.model.state_dict()
    for key, ref in final.items():
        assert float((state[key] - ref).norm()) <= FIT_TOL * float(ref.norm()), key
    np.testing.assert_allclose(port_t.build_ace_matrix(articles),
                               jax_t.build_ace_matrix(articles), rtol=0, atol=FIT_TOL)
    assert port_t.evaluate(articles) == {} == jax_t.evaluate(articles)


def test_clip_is_optax_clip_by_global_norm():
    import optax

    rng = np.random.RandomState(0)
    for scale in (0.1, 10.0):
        grads = [rng.randn(4, 3).astype(np.float32) * scale, rng.randn(5).astype(np.float32)]
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        trainer_module._clip_by_global_norm(params, 5.0)
        want, _ = optax.clip_by_global_norm(5.0).update([jnp.asarray(g) for g in grads], None)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)

"""The port's ACR modules against the JAX package's, on the CPU.

Inputs come from numpy seeds; the port's weights are the JAX modules'
initial Flax params through ``convert.acr_params_from_flax``.  Checked:

* ``TextCNN`` (widths 2, 3, 5), ``StackedGRU`` and ``StackedLSTM`` (2
  layers, both directions, widths 9 and 16, every step valid)
  and the classifier's ACE, logits and per-label and total losses (CNN, GRU,
  LSTM; class weights, a multilabel head, a zero-weight tail) within 1e-5
  abs: f32 sums of the same products in another order;
* 20 ``fit`` steps (37 articles at batch 8 over 4 epochs: one shuffle
  stream, a zero-weight tail each epoch) from the same weights: the epoch
  losses and every parameter within 1e-4 relative (normwise per parameter);
* ``_l2`` on the same weights, ``_batched``'s plan, ``build_ace_matrix``
  (its mean row 0, the contiguous-id assertion) within 1e-4 of JAX's after
  the fit, and ``evaluate``'s accuracy and precision/recall equal.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from chameleon_recsys_tpu.acr.trainer import ACRTrainer as JaxACRTrainer
from chameleon_recsys_tpu.acr.trainer import _batched as jax_batched
from chameleon_recsys_tpu.config import ACRConfig as JaxACRConfig
from chameleon_recsys_tpu.models.acr import ACRLabelSpec as JaxLabelSpec
from chameleon_recsys_tpu.models.acr import TextCNN as JaxTextCNN
from chameleon_recsys_tpu.ops.rnn import StackedGRU as JaxStackedGRU
from chameleon_recsys_tpu.ops.rnn import StackedLSTM as JaxStackedLSTM

from chameleon_recsys_tpu_torch.acr.trainer import ACRTrainer, _epoch_plan
from chameleon_recsys_tpu_torch.config import ACRConfig
from chameleon_recsys_tpu_torch.convert import acr_params_from_flax
from chameleon_recsys_tpu_torch.models.acr import ACRLabelSpec, TextCNN
from chameleon_recsys_tpu_torch.ops.rnn import StackedGRU, StackedLSTM

FWD_TOL = 1e-5
FIT_TOL = 1e-4
VOCAB, WORD_DIM, TEXT_LEN, N_ARTICLES, CATEGORIES, KEYWORDS = 120, 16, 12, 37, 6, 9


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Holder(nn.Module):
    """A module whose ``encoder`` is one ACR text encoder: the shape of state
    that ``acr_params_from_flax`` fills for a lone encoder."""

    def __init__(self, encoder):
        super().__init__()
        self.encoder = encoder


def test_text_cnn_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 11, 7).astype(np.float32)
    module = JaxTextCNN((2, 3, 5), 6)
    params = numpy_tree(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    port = Holder(TextCNN(7, (2, 3, 5), 6))
    port.load_state_dict(acr_params_from_flax({"cnn": params}, port))
    ref = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    out = port.encoder(torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape == (4, 18)
    np.testing.assert_allclose(out, ref, rtol=0, atol=FWD_TOL)


RNN_CASES = [(kind, direction, units) for kind in ("GRU", "LSTM")
             for direction in ("unidirectional", "bidirectional") for units in (9, 16)]


@pytest.mark.parametrize("kind,direction,units", RNN_CASES,
                         ids=[f"{k}-{d[:3]}-{u}" for k, d, u in RNN_CASES])
def test_stacked_rnn_matches_jax(kind, direction, units):
    """Every step valid: the mask the ACR models pass."""
    jax_cls, port_cls = {"GRU": (JaxStackedGRU, StackedGRU),
                         "LSTM": (JaxStackedLSTM, StackedLSTM)}[kind]
    rng = np.random.RandomState(units)
    b, t, d = 5, 8, 6
    x = rng.randn(b, t, d).astype(np.float32)
    mask = jnp.ones((b, t), bool)
    module = jax_cls(units, 2, direction=direction)
    params = numpy_tree(jax.jit(module.init)(jax.random.PRNGKey(1), jnp.asarray(x),
                                             mask)["params"])
    port = Holder(port_cls(d, units, 2, direction=direction))
    port.load_state_dict(acr_params_from_flax({"rnn": params}, port))
    ref_out, ref_finals = (np.asarray(a) for a in jax.jit(module.apply)(
        {"params": params}, jnp.asarray(x), mask))
    out, finals = (a.detach().numpy() for a in port.encoder(torch.from_numpy(x)))
    width = units * (2 if direction == "bidirectional" else 1)
    assert out.shape == ref_out.shape == (b, t, width)
    assert finals.shape == ref_finals.shape == (2, b, width)
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(finals, ref_finals, rtol=0, atol=FWD_TOL)


def _corpus(seed=0):
    rng = np.random.RandomState(seed)
    word_emb = (rng.randn(VOCAB, WORD_DIM) * 0.3).astype(np.float32)
    lengths = rng.randint(4, TEXT_LEN + 1, N_ARTICLES)
    text = np.where(np.arange(TEXT_LEN)[None] < lengths[:, None],
                    rng.randint(2, VOCAB, (N_ARTICLES, TEXT_LEN)), 0).astype(np.int32)
    keywords = rng.randint(1, KEYWORDS, (N_ARTICLES, 4))
    keywords[:, 2:] *= rng.rand(N_ARTICLES, 2) < 0.5  # padded id lists
    articles = {
        "article_id": np.arange(1, N_ARTICLES + 1),
        "text": text,
        "text_length": lengths.astype(np.int32),
        "category0": rng.randint(1, CATEGORIES, N_ARTICLES),
        "keywords": keywords,
    }
    class_weights = {"category0": (rng.rand(CATEGORIES) + 0.5).astype(np.float32)}
    return word_emb, articles, class_weights


def _config(cls, extractor, direction="unidirectional"):
    return cls(text_feature_extractor=extractor, word_embedding_size=WORD_DIM,
               vocab_size=VOCAB, truncate_tokens_length=TEXT_LEN,
               acr_embeddings_size=10, cnn_filter_sizes=(2, 3), cnn_num_filters=8,
               rnn_units=9, rnn_layers=2, rnn_direction=direction,
               learning_rate=3e-3, batch_size=8, training_epochs=4, l2_reg_lambda=1e-3)


def _specs(cls):
    return (cls("category0", CATEGORIES, "multiclass"),
            cls("keywords", KEYWORDS, "multilabel", 0.5))


def trainers(extractor, direction="unidirectional"):
    """The JAX trainer after ``init`` and the port's on its params."""
    word_emb, articles, class_weights = _corpus()
    jax_t = JaxACRTrainer(_config(JaxACRConfig, extractor, direction), word_emb,
                          _specs(JaxLabelSpec), class_weights)
    # ``ACRTrainer.init``, jitted (eager, each op compiles on its own)
    jax_t.params = jax.jit(lambda key, text, length: jax_t.model.init(
        {"params": key}, text, length, jax_t.word_embeddings, labels=None,
        train=False))(jax.random.PRNGKey(0), articles["text"][:8],
                      articles["text_length"][:8])["params"]
    jax_t.opt_state = jax_t.optimizer.init(jax_t.params)
    port_t = ACRTrainer(_config(ACRConfig, extractor, direction), word_emb,
                        _specs(ACRLabelSpec), class_weights, device="cpu")
    port_t.model.load_state_dict(acr_params_from_flax(numpy_tree(jax_t.params),
                                                      port_t.model))
    return jax_t, port_t, articles


EXTRACTORS = [("CNN", "unidirectional"), ("GRU", "bidirectional"),
              ("LSTM", "unidirectional")]


def forward_both(jax_t, port_t, articles):
    """Both models' outputs on one batch with a zero-weight tail."""
    weights = np.ones(8, np.float32)
    weights[5:] = 0.0
    batch = {k: v[8:16] for k, v in articles.items()}
    labels = {s.name: batch[s.name] for s in port_t.label_specs}
    ref = jax.jit(jax_t.model.apply)(
        {"params": jax_t.params}, jnp.asarray(batch["text"]), jnp.asarray(batch["text_length"]),
        jax_t.word_embeddings, labels={k: jnp.asarray(v) for k, v in labels.items()},
        label_class_weights=jax_t.label_class_weights,
        example_weights=jnp.asarray(weights))
    with torch.no_grad():
        out = port_t.model(torch.from_numpy(batch["text"]),
                           {k: torch.from_numpy(v) for k, v in labels.items()},
                           port_t.label_class_weights, torch.from_numpy(weights))
        l2 = float(port_t._l2())
    return out, ref, l2, float(jax.jit(jax_t._l2)(jax_t.params))


@pytest.fixture(scope="module", params=EXTRACTORS, ids=[e for e, _ in EXTRACTORS])
def fitted(request):
    """Both trainers from the same weights: their outputs there, then
    ``fit``."""
    jax_t, port_t, articles = trainers(*request.param)
    initial = forward_both(jax_t, port_t, articles)
    return types.SimpleNamespace(jax_t=jax_t, port_t=port_t, articles=articles,
                                 initial=initial, jax_losses=jax_t.fit(articles),
                                 port_losses=port_t.fit(articles))


def test_classifier_matches_jax(fitted):
    out, ref, port_l2, jax_l2 = fitted.initial
    np.testing.assert_allclose(out.ace.numpy(), np.asarray(ref.ace), atol=FWD_TOL)
    for name in ("category0", "keywords"):
        np.testing.assert_allclose(out.label_logits[name].numpy(),
                                   np.asarray(ref.label_logits[name]), atol=FWD_TOL)
        assert float(out.per_label_loss[name]) == pytest.approx(
            float(ref.per_label_loss[name]), abs=FWD_TOL)
    assert float(out.loss) == pytest.approx(float(ref.loss), abs=FWD_TOL)
    assert port_l2 == pytest.approx(jax_l2, rel=1e-6)


def test_epoch_plan_is_batched_plan():
    shuffle_jax, shuffle_port = np.random.RandomState(0), np.random.RandomState(0)
    columns = {"row": np.arange(N_ARTICLES)}
    for _ in range(3):  # one stream across the epochs
        rows, weights = zip(*((b["row"], w) for b, w in jax_batched(columns, 8, shuffle_jax)))
        plan = _epoch_plan(N_ARTICLES, 8, shuffle_port)
        np.testing.assert_array_equal(plan[0], np.concatenate(rows))
        np.testing.assert_array_equal(plan[1], np.concatenate(weights))
    assert plan[1].sum() == N_ARTICLES and plan[0].shape == (40,)


def test_fit_matches_jax(fitted):
    assert len(fitted.port_losses) == 4
    np.testing.assert_allclose(fitted.port_losses, fitted.jax_losses, rtol=FIT_TOL)
    final = acr_params_from_flax(numpy_tree(fitted.jax_t.params), fitted.port_t.model)
    port_state = fitted.port_t.model.state_dict()
    for key, ref in final.items():
        diff = float((port_state[key] - ref).norm())
        assert diff <= FIT_TOL * float(ref.norm()), key
    assert fitted.port_t.optimizer.state_dict()["state"][0]["step"] == 20


def test_build_ace_matrix_matches_jax(fitted):
    port_matrix = fitted.port_t.build_ace_matrix(fitted.articles)
    jax_matrix = fitted.jax_t.build_ace_matrix(fitted.articles)
    assert port_matrix.shape == (N_ARTICLES + 1, 10) and port_matrix.dtype == np.float32
    np.testing.assert_allclose(port_matrix, jax_matrix, rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(port_matrix[0], port_matrix[1:].mean(axis=0), atol=1e-6)
    # rows are indexed by article id, whatever the input order
    order = np.random.RandomState(3).permutation(N_ARTICLES)
    shuffled = {k: v[order] for k, v in fitted.articles.items()}
    np.testing.assert_allclose(fitted.port_t.build_ace_matrix(shuffled)[1:],
                               port_matrix[1:], atol=1e-6)
    broken = dict(fitted.articles, article_id=fitted.articles["article_id"].copy())
    broken["article_id"][3] = 999
    with pytest.raises(AssertionError, match="contiguous"):
        fitted.port_t.build_ace_matrix(broken)


def test_evaluate_matches_jax(fitted):
    port_metrics = fitted.port_t.evaluate(fitted.articles)
    assert port_metrics == fitted.jax_t.evaluate(fitted.articles)
    assert set(port_metrics) == {"accuracy-category0", "precision-keywords",
                                 "recall-keywords"}


def test_flax_tree_must_match_the_model(fitted):
    params, model = numpy_tree(fitted.jax_t.params), fitted.port_t.model
    with pytest.raises(KeyError, match="missing"):
        acr_params_from_flax({k: v for k, v in params.items() if k != "fc2"}, model)
    with pytest.raises(KeyError, match="no rule"):
        acr_params_from_flax(dict(params, extra={"kernel": np.zeros(2)}), model)

"""The port's ACR models in bfloat16 against the JAX package's, on the CPU.

``ACRConfig.compute_dtype = "bfloat16"``: Flax's ``dtype=bf16`` with
``param_dtype=f32`` on the JAX side; on the port's, f32 parameters cast at
each use, bf16 convs, Dense layers and RNN stacks (the cuDNN call on bf16
inputs and weights, the states carried in bf16), f32 losses and ACE matrix.  Both sides start
from the same Flax params (``convert.acr_params_from_flax``, unchanged: the
parameters are f32 in both dtypes).  Checked, for the classifier with a CNN,
a bidirectional GRU and an LSTM encoder, and for the GRU autoencoder:

* one forward on a batch with a zero-weight tail: the ACE, the logits (or
  the reconstruction) and the loss;
* three ``fit`` steps (24 articles at batch 8, one epoch, the same
  shuffle): the epoch loss, every parameter and the exported ACE matrix;
* the rule of the bf16 dense NAR step (``test_torch_dropout.py``): the
  port's bf16 lies no further from the port's f32 than 1.5 times JAX's
  bf16 from JAX's f32.
  On the activations and the ACE matrix it is held both ways, no nearer
  than that distance over 1.5 either, so that the port rounds about as
  much as JAX does (a port computing in f32 would pass the comparison with
  JAX's bf16 within ``ACT_TOL``, not this).  On the parameters' update it
  is held one way only: there the distance is that of the leaves whose bf16
  gradient is rounding noise (below), and JAX's lies up to 2.4 times the
  port's (the LSTM classifier).

Tolerances.  bf16 keeps 8 significant bits, so one rounding moves a value
by up to 2^-9 (2.0e-3) of itself.  The two implementations round at other
points of the same chain (XLA fuses elementwise ops and may keep their
intermediates in f32; the port rounds after every op), so their outputs
part by a few roundings, as the bf16 outputs part from the f32 ones (both
0.3-0.7% normwise here).  Held normwise: activations (ACE, logits,
reconstruction, the ACE matrix) within ``ACT_TOL`` = 2e-2, about ten
roundings; the f32 losses, sums over the whole batch in which the roundings
average out, within ``LOSS_TOL`` = 1e-3 relative.  The parameters after
three Adam steps: all of them together within ``PARAM_TOL`` = 5e-3 of
their norm, and each within ``UPDATE_TOL`` = 0.25 of the norm of its JAX
update (the three steps' sum).  Adam moves an element by about lr
whatever the size of its gradient, so where a bf16 gradient is rounding
noise (a bias that starts at 0, a weight whose gradient cancels over the
batch) the element moves either way; such leaves part by a share of their
update, not of their value (measured up to 12% here, in both directions:
JAX's bf16 updates of the Dense weights part from the f32 ones by up to
12%, the port's by under 1%).  The 1.5x rule is held on the whole update.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.acr.trainer import ACRTrainer as JaxACRTrainer
from chameleon_recsys_tpu.config import ACRConfig as JaxACRConfig
from chameleon_recsys_tpu.models.acr import ACRLabelSpec as JaxLabelSpec

from chameleon_recsys_tpu_torch.acr.trainer import ACRTrainer
from chameleon_recsys_tpu_torch.config import ACRConfig
from chameleon_recsys_tpu_torch.convert import acr_params_from_flax
from chameleon_recsys_tpu_torch.models import acr as acr_module
from chameleon_recsys_tpu_torch.models.acr import ACRLabelSpec

from test_torch_acr import _config, _corpus, _specs, numpy_tree
from test_torch_acr_autoencoder import config as ae_config
from test_torch_acr_autoencoder import corpus as ae_corpus
from test_torch_acr_autoencoder import record_normal

ACT_TOL = 2e-2
LOSS_TOL = 1e-3
PARAM_TOL = 5e-3
UPDATE_TOL = 0.25
RULE = 1.5
N_FIT = 24
DTYPES = ("float32", "bfloat16")


def rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_rule(key, port_gap: float, jax_gap: float, both_ways: bool = True):
    """The port's bf16-from-f32 distance at most ``RULE`` times JAX's and,
    ``both_ways``, at least JAX's over ``RULE``."""
    low = jax_gap / RULE if both_ways else 0.0
    assert low <= port_gap <= RULE * jax_gap and port_gap > 0, (key, port_gap, jax_gap)


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------


def classifier_pair(extractor, direction, dtype, params=None):
    """The JAX trainer and the port's at ``dtype``, both on ``params`` (the
    JAX model's initial params when None), over the first ``N_FIT``
    articles."""
    word_emb, articles, class_weights = _corpus()
    articles = {k: v[:N_FIT] for k, v in articles.items()}
    jax_cfg = dataclasses.replace(_config(JaxACRConfig, extractor, direction),
                                  compute_dtype=dtype, training_epochs=1)
    port_cfg = dataclasses.replace(_config(ACRConfig, extractor, direction),
                                   compute_dtype=dtype, training_epochs=1)
    jax_t = JaxACRTrainer(jax_cfg, word_emb, _specs(JaxLabelSpec), class_weights)
    if params is None:
        params = jax.jit(lambda key, text, length: jax_t.model.init(
            {"params": key}, text, length, jax_t.word_embeddings, labels=None,
            train=False))(jax.random.PRNGKey(0), articles["text"][:8],
                          articles["text_length"][:8])["params"]
    jax_t.params = params
    jax_t.opt_state = jax_t.optimizer.init(params)
    port_t = ACRTrainer(port_cfg, word_emb, _specs(ACRLabelSpec), class_weights,
                        device="cpu")
    port_t.model.load_state_dict(acr_params_from_flax(numpy_tree(params), port_t.model))
    return jax_t, port_t, articles, params


def classifier_forward(jax_t, port_t, articles):
    weights = np.ones(8, np.float32)
    weights[5:] = 0.0
    batch = {k: v[8:16] for k, v in articles.items()}
    labels = {s.name: batch[s.name] for s in port_t.label_specs}
    ref = jax.jit(jax_t.model.apply)(
        {"params": jax_t.params}, jnp.asarray(batch["text"]),
        jnp.asarray(batch["text_length"]), jax_t.word_embeddings,
        labels={k: jnp.asarray(v) for k, v in labels.items()},
        label_class_weights=jax_t.label_class_weights, example_weights=jnp.asarray(weights))
    with torch.no_grad():
        out = port_t.model(torch.from_numpy(batch["text"]),
                           {k: torch.from_numpy(v) for k, v in labels.items()},
                           port_t.label_class_weights, torch.from_numpy(weights))
    return ({"ace": as_f32(out.ace), "logits": as_f32(out.label_logits["category0"]),
             "keywords": as_f32(out.label_logits["keywords"]), "loss": float(out.loss)},
            {"ace": as_f32(ref.ace), "logits": as_f32(ref.label_logits["category0"]),
             "keywords": as_f32(ref.label_logits["keywords"]), "loss": float(ref.loss)},
            out)


def fit_both(jax_t, port_t, articles, **port_extra):
    """Both trainers' ``fit`` (three steps): their epoch losses, ACE
    matrices and parameters (numpy, in the port's names), with the initial
    parameters."""
    initial = {k: v.numpy().copy() for k, v in port_t.model.state_dict().items()}
    jax_losses, port_losses = jax_t.fit(articles), port_t.fit(articles)
    jax_params = acr_params_from_flax(numpy_tree(jax_t.params), port_t.model)
    assert all(v.dtype == torch.float32 for v in port_t.model.state_dict().values())
    return dict(
        initial=initial,
        port=dict(port_extra, fit=port_losses, matrix=port_t.build_ace_matrix(articles),
                  params={k: v.numpy() for k, v in port_t.model.state_dict().items()}),
        jax=dict(fit=jax_losses, matrix=jax_t.build_ace_matrix(articles),
                 params={k: v.numpy() for k, v in jax_params.items()}),
        steps=port_t.optimizer.state_dict()["state"][0]["step"],
    )


def fitted_run(pair):
    """Forward, then three fit steps, of both trainers of ``pair``."""
    jax_t, port_t, articles, _ = pair
    port_fwd, jax_fwd, out = classifier_forward(jax_t, port_t, articles)
    run = fit_both(jax_t, port_t, articles, raw=out, **port_fwd)
    run["jax"].update(jax_fwd)
    return run


def flat(params):
    return np.concatenate([np.ravel(v) for _, v in sorted(params.items())])


def assert_steps_match(runs):
    """The bf16 run's fit losses, parameters and ACE matrix against JAX's,
    and the 1.5x rule on the ACE matrix and on the whole update."""
    run, f32 = runs["bfloat16"], runs["float32"]
    assert run["steps"] == 3
    np.testing.assert_allclose(run["port"]["fit"], run["jax"]["fit"], rtol=LOSS_TOL)
    port, ref, initial = run["port"]["params"], run["jax"]["params"], run["initial"]
    assert rel(flat(port), flat(ref)) <= PARAM_TOL
    for key in ref:
        assert np.linalg.norm(port[key] - ref[key]) <= UPDATE_TOL * np.linalg.norm(
            ref[key] - initial[key]), key
    matrix = run["port"]["matrix"]
    assert matrix.dtype == np.float32
    assert rel(matrix, run["jax"]["matrix"]) <= ACT_TOL
    np.testing.assert_allclose(matrix[0], matrix[1:].mean(axis=0), atol=1e-6)
    update = {(dt, side): flat(runs[dt][side]["params"]) - flat(initial)
              for dt in DTYPES for side in ("port", "jax")}
    for key, port_gap, jax_gap in (
            ("matrix", rel(matrix, f32["port"]["matrix"]),
             rel(run["jax"]["matrix"], f32["jax"]["matrix"])),
            ("update", rel(update["bfloat16", "port"], update["float32", "port"]),
             rel(update["bfloat16", "jax"], update["float32", "jax"]))):
        assert_rule(key, port_gap, jax_gap, both_ways=key != "update")


EXTRACTORS = [("CNN", "unidirectional"), ("GRU", "bidirectional"),
              ("LSTM", "unidirectional")]


@pytest.fixture(scope="module", params=EXTRACTORS, ids=[e for e, _ in EXTRACTORS])
def classifier_runs(request):
    """The classifier's runs in both dtypes from the same initial params."""
    runs = {}
    params = None
    for dtype in DTYPES:
        pair = classifier_pair(*request.param, dtype, params)
        params = pair[3]
        runs[dtype] = fitted_run(pair)
    return runs


def test_classifier_bf16_forward_matches_jax(classifier_runs):
    port, ref = classifier_runs["bfloat16"]["port"], classifier_runs["bfloat16"]["jax"]
    raw = port["raw"]
    assert raw.ace.dtype == torch.bfloat16 and raw.label_logits["category0"].dtype == \
        torch.float32 and raw.loss.dtype == torch.float32
    for key in ("ace", "logits", "keywords"):
        assert rel(port[key], ref[key]) <= ACT_TOL, key
    assert port["loss"] == pytest.approx(ref["loss"], rel=LOSS_TOL)


def test_classifier_bf16_steps_match_jax(classifier_runs):
    assert_steps_match(classifier_runs)
    assert classifier_runs["bfloat16"]["port"]["matrix"].shape == (N_FIT + 1, 10)


def test_classifier_bf16_no_further_from_f32_than_jax(classifier_runs):
    bf16, f32 = classifier_runs["bfloat16"], classifier_runs["float32"]
    for key in ("ace", "logits", "keywords"):
        port_gap = rel(bf16["port"][key], f32["port"][key])
        jax_gap = rel(bf16["jax"][key], f32["jax"][key])
        assert_rule(key, port_gap, jax_gap)


# ---------------------------------------------------------------------------
# the autoencoder
# ---------------------------------------------------------------------------


def autoencoder_pair(dtype, params=None, **overrides):
    word_emb, text, lengths = ae_corpus(N_FIT, seed=3)
    articles = {"article_id": np.arange(1, N_FIT + 1), "text": text,
                "text_length": lengths}
    fields = dict(compute_dtype=dtype, training_epochs=1, rnn_units=16,
                  l2_reg_lambda=1e-3, **overrides)
    jax_t = JaxACRTrainer(ae_config(JaxACRConfig, **fields), word_emb)
    if params is None:
        params = jax.jit(lambda key: jax_t.model.init(
            {"params": key}, jnp.asarray(text[:8]), jnp.asarray(lengths[:8]),
            jax_t.word_embeddings, jax_t.special_token_embedding, train=False))(
                jax.random.PRNGKey(4))["params"]
    jax_t.params = params
    jax_t.opt_state = jax_t.optimizer.init(params)
    port_t = ACRTrainer(ae_config(ACRConfig, **fields), word_emb, device="cpu")
    port_t.model.load_state_dict(acr_params_from_flax(numpy_tree(params), port_t.model))
    return jax_t, port_t, articles, params


def autoencoder_forward(jax_t, port_t, articles, monkeypatch, train):
    """One forward of both models on a batch with a zero-weight row; in
    training with JAX's noise (drawn in bf16 by ``jax.random.normal``)
    injected into the port."""
    text, lengths = articles["text"][:8], articles["text_length"][:8]
    weights = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
    args = (jnp.asarray(text), jnp.asarray(lengths), jax_t.word_embeddings,
            jax_t.special_token_embedding, jnp.asarray(weights))
    drawn = record_normal(monkeypatch)
    want = jax_t.model.apply({"params": jax_t.params}, *args, train=train,
                             rngs={"noise": jax.random.PRNGKey(9)} if train else {})
    if train:
        bf16 = jax_t.cfg.compute_dtype == "bfloat16"
        assert len(drawn) == 1 and drawn[0].dtype == (jnp.bfloat16 if bf16 else jnp.float32)
        monkeypatch.setattr(acr_module, "_draw_noise", lambda shape, generator, device:
                            torch.from_numpy(as_f32(drawn[0])))
    with torch.no_grad():
        got = port_t.model(torch.from_numpy(text), port_t.special_token_embedding,
                           torch.from_numpy(weights), train=train)
    return got, want


@pytest.fixture(scope="module")
def autoencoder_runs():
    """The autoencoder's three fit steps (noise 0: its draws cannot be
    matched) in both dtypes from the same initial params."""
    runs, params = {}, None
    for dtype in DTYPES:
        jax_t, port_t, articles, params = autoencoder_pair(dtype, params)
        runs[dtype] = fit_both(jax_t, port_t, articles)
    runs["params"] = params
    return runs


@pytest.mark.parametrize("train", [True, False], ids=["noise", "eval"])
def test_autoencoder_bf16_forward_matches_jax(autoencoder_runs, train, monkeypatch):
    """With noise 0.1 in training (JAX's bf16 draw injected), and outside
    it; the ACE, the reconstruction and the loss f32 on both sides."""
    outs = {}
    for dtype in DTYPES:
        jax_t, port_t, articles, _ = autoencoder_pair(
            dtype, autoencoder_runs["params"], autoencoder_noise=0.1)
        outs[dtype] = autoencoder_forward(jax_t, port_t, articles, monkeypatch, train)
    (got, want), (got32, want32) = outs["bfloat16"], outs["float32"]
    assert all(g.dtype == torch.float32 for g in got)
    for name, g, w, g32, w32 in zip(("ace", "reconstruction"), got, want, got32, want32):
        assert rel(as_f32(g), as_f32(w)) <= ACT_TOL, name
        port_gap, jax_gap = rel(as_f32(g), as_f32(g32)), rel(as_f32(w), as_f32(w32))
        assert_rule(name, port_gap, jax_gap)
    assert float(got[2]) == pytest.approx(float(want[2]), rel=LOSS_TOL)


def test_autoencoder_bf16_steps_match_jax(autoencoder_runs):
    assert_steps_match(autoencoder_runs)
    assert autoencoder_runs["bfloat16"]["port"]["matrix"].shape == (N_FIT + 1, 6)


def test_bf16_models_keep_f32_parameters():
    """The weight bridge needs no change: Flax keeps bf16 models' params in
    f32, and the port's bf16 models hold the same f32 parameters, with the
    same names, as its f32 models; an unknown dtype is refused."""
    word_emb = _corpus()[0]
    for extractor, direction in EXTRACTORS:
        _, port16, _, params = classifier_pair(extractor, direction, "bfloat16")
        assert all(np.asarray(leaf).dtype == np.float32
                   for leaf in jax.tree_util.tree_leaves(params))
        _, port32, _, _ = classifier_pair(extractor, direction, "float32", params)
        state16, state32 = port16.model.state_dict(), port32.model.state_dict()
        assert list(state16) == list(state32)
        for key in state16:
            assert state16[key].dtype == torch.float32
            assert torch.equal(state16[key], state32[key]), key
    bad = dataclasses.replace(_config(ACRConfig, "CNN"), compute_dtype="float16")
    with pytest.raises(ValueError, match="compute_dtype"):
        acr_module.ACRClassifierModel(bad, _specs(ACRLabelSpec), word_emb)

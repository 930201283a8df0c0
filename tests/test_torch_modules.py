"""The port's jax-free copies and small modules against the JAX package's:
config defaults, the synthetic corpus and sessions (bit-equal for one seed),
the buffer-statistic normalization and the feature towers.

Tolerances: normalization in float32 at rtol 1e-6 / atol 1e-6 (the same
formula, reductions summed in another order); the towers exactly (one-hot,
gathers and casts only)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu import config as jax_config
from chameleon_recsys_tpu.data import synthetic as jax_synthetic
from chameleon_recsys_tpu.models.towers import FeatureTowers as JaxFeatureTowers
from chameleon_recsys_tpu.ops import normalization as jax_norm

import chameleon_recsys_tpu_torch as port
from chameleon_recsys_tpu_torch import config as port_config
from chameleon_recsys_tpu_torch.data import synthetic as port_synthetic
from chameleon_recsys_tpu_torch.models.towers import FeatureTowers
from chameleon_recsys_tpu_torch.ops import normalization as port_norm

from conftest import tiny_article_schema, tiny_session_schema


def _port_specs(specs):
    return tuple(port.FeatureSpec(**dataclasses.asdict(s)) for s in specs)


def test_config_defaults_match_jax():
    assert dataclasses.asdict(port.NARConfig()) == dataclasses.asdict(
        jax_config.NARConfig()
    )
    assert [f.name for f in dataclasses.fields(port.NARConfig)] == [
        f.name for f in dataclasses.fields(jax_config.NARConfig)
    ]
    assert port.NARConfig().max_inputs_length == jax_config.NARConfig().max_inputs_length
    assert port_config.SECONDS_PER_DAY == jax_config.SECONDS_PER_DAY
    assert port_config.SECONDS_PER_HOUR == jax_config.SECONDS_PER_HOUR
    for card in (2, 5, 11, 461, 46033, 322897):
        assert port_config.embedding_dim_for_cardinality(
            card
        ) == jax_config.embedding_dim_for_cardinality(card)


def test_schemas_match_jax():
    art, sess = tiny_article_schema(), tiny_session_schema()
    part = port.ArticleFeaturesSchema(features=_port_specs(art.features))
    psess = port.SessionFeaturesSchema(
        single=_port_specs(sess.single), sequence=_port_specs(sess.sequence)
    )
    assert part.num_items == art.num_items
    assert [s.name for s in part.metadata_features()] == [
        s.name for s in art.metadata_features()
    ]
    assert [s.name for s in psess.context_sequence_features()] == [
        s.name for s in sess.context_sequence_features()
    ]
    with pytest.raises(ValueError):
        port.FeatureSpec("bad", "categorical")


@pytest.mark.parametrize("length_distribution", ["uniform", "g1"])
@pytest.mark.parametrize("seed", [42, 7])
def test_synthetic_data_bit_equal(seed, length_distribution):
    art, sess = tiny_article_schema(300), tiny_session_schema(300)
    jax_corpus = jax_synthetic.make_synthetic_corpus(art, ace_dim=16, seed=seed)
    corpus = port_synthetic.make_synthetic_corpus(
        port.ArticleFeaturesSchema(features=_port_specs(art.features)),
        ace_dim=16, seed=seed,
    )
    assert corpus.num_items == jax_corpus.num_items
    assert corpus.metadata.keys() == jax_corpus.metadata.keys()
    for name, col in jax_corpus.metadata.items():
        assert corpus.metadata[name].dtype == col.dtype
        np.testing.assert_array_equal(corpus.metadata[name], col)
    np.testing.assert_array_equal(corpus.ace_matrix, jax_corpus.ace_matrix)
    np.testing.assert_array_equal(corpus.item_popularity, jax_corpus.item_popularity)

    psess = port.SessionFeaturesSchema(
        single=_port_specs(sess.single), sequence=_port_specs(sess.sequence)
    )
    for hour in (0, 3):
        expected = jax_synthetic.synthetic_hour_sessions(
            jax_corpus, sess, hour, 12, 8, seed=seed,
            length_distribution=length_distribution,
        )
        got = port_synthetic.synthetic_hour_sessions(
            corpus, psess, hour, 12, 8, seed=seed,
            length_distribution=length_distribution,
        )
        assert [dataclasses.asdict(s) for s in got] == [
            dataclasses.asdict(s) for s in expected
        ]


@pytest.mark.parametrize("case", ["partial", "empty_mask", "one_valid", "no_minmax"])
def test_normalize_values_matches_jax(case):
    rng = np.random.RandomState(3)
    values = (rng.randn(4, 6) * 3 + 1).astype(np.float32)
    stats = (rng.randn(40) * 2).astype(np.float32)
    mask = rng.rand(40) > 0.4
    kwargs = {}
    if case == "empty_mask":
        mask[:] = False
    elif case == "one_valid":
        mask[:] = False
        mask[5] = True
    elif case == "no_minmax":
        kwargs = dict(min_max_scaling_after_znorm=False)
    expected = jax_norm.normalize_values(
        jnp.asarray(values), jnp.asarray(stats), jnp.asarray(mask), **kwargs
    )
    got = port_norm.normalize_values(
        torch.from_numpy(values), torch.from_numpy(stats), torch.from_numpy(mask),
        **kwargs,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-6, atol=1e-6)


def test_log_helpers_match_jax():
    x = np.linspace(0.01, 50.0, 64).astype(np.float32)
    for base in (1.3, 2.0):
        np.testing.assert_allclose(
            port_norm.log1p_base(torch.from_numpy(x), base).numpy(),
            np.asarray(jax_norm.log1p_base(jnp.asarray(x), base)),
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            port_norm.log_base(torch.from_numpy(x), base).numpy(),
            np.asarray(jax_norm.log_base(jnp.asarray(x), base)),
            rtol=1e-6, atol=1e-7,
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_towers_match_jax(dtype):
    specs = tiny_session_schema().context_sequence_features() + (
        jax_config.FeatureSpec("region", "categorical", 29),
    )
    rng = np.random.RandomState(5)
    inputs = {}
    for spec in specs:
        if spec.kind == "categorical":
            # one-hot ids may pass the cardinality (an all-zero row)
            high = spec.cardinality + (spec.cardinality <= 10)
            inputs[spec.name] = rng.randint(0, high, (3, 4)).astype(np.int32)
        else:
            inputs[spec.name] = rng.randn(3, 4).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jax_towers = JaxFeatureTowers(specs, max_cardinality_for_ohe=10, dtype=jdt)
    jax_inputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jax_towers.init(jax.random.key(0), jax_inputs)["params"]
    expected = jax_towers.apply({"params": params}, jax_inputs)

    towers = FeatureTowers(_port_specs(specs), max_cardinality_for_ohe=10, dtype=tdt)
    towers.load_state_dict({
        f"embeddings.{name}.weight": torch.from_numpy(np.array(p["embedding"]))
        for name, p in params.items()
    })
    with torch.no_grad():
        got = towers({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert towers.output_dim == expected.shape[-1]
    assert got.dtype == tdt and tuple(got.shape) == expected.shape
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(expected.astype(jnp.float32))
    )

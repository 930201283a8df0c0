"""The port's grid sampler against the JAX package's.

Exact parity: the JAX sampler's three uniform arrays are drawn from its key as
``sample_negatives_pooled`` splits it (``split(rng, 3)``, then one uniform
array of each shape) and handed to the port, which must then give the same
``pool_ext``, ``neg_idx`` and ``neg_ids`` bit for bit.  The distribution
checks draw from a ``torch.Generator``, as ``tests/test_sampling.py`` does
for the JAX sampler.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.ops.sampling import (
    sample_negatives_pooled as jax_sample_negatives_pooled,
)

from chameleon_recsys_tpu_torch.ops import sampling

CLICKED = np.array(
    [[1, 2, 3, 4, 5], [6, 7, 0, 0, 0], [0, 0, 0, 0, 0]], np.int32
)

CASES = {
    # buffer empty: the pool holds only the batch's clicks
    "empty_buffer": (CLICKED, np.zeros(32, np.int32), 4, 16, 20),
    # buffer under-full: fewer non-zero entries than the buffer sample
    "underfull_buffer": (
        CLICKED, np.array([9, 10, 11, 12] + [0] * 28, np.int32), 4, 16, 20,
    ),
    # repeated clicks and buffer ids: popularity-weighted segments
    "repeated": (
        np.array([[3, 3, 8, 8, 8], [8, 9, 3, 0, 0], [5, 0, 0, 0, 0]], np.int32),
        (np.arange(64, dtype=np.int32) % 12), 6, 40, 20,
    ),
    # a full pool cut at mult * K, with padded sessions
    "padded_sessions": (
        np.array([[11, 12, 13, 0], [14, 15, 0, 0], [0, 0, 0, 0],
                  [16, 11, 17, 18]], np.int32),
        np.arange(0, 200, dtype=np.int32), 5, 64, 4,
    ),
}


def jax_uniforms(seed, clicked, buffer_ids, k, m, mult):
    b, l = clicked.shape
    nc = min(k * mult, b * l + m)
    rng_buf, rng_pool, rng_u = jax.random.split(jax.random.PRNGKey(seed), 3)
    return sampling.SamplerUniforms(
        buffer=torch.tensor(np.asarray(
            jax.random.uniform(rng_buf, buffer_ids.shape))),
        pool=torch.tensor(np.asarray(jax.random.uniform(rng_pool, (b * l + m,)))),
        click=torch.tensor(np.asarray(jax.random.uniform(rng_u, (b, l, nc)))),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_pooled_sampler_matches_jax_exactly(case, seed):
    clicked, buffer_ids, k, m, mult = CASES[case]
    jax_pool, jax_idx, jax_ids = jax_sample_negatives_pooled(
        jax.random.PRNGKey(seed), jnp.asarray(clicked), jnp.asarray(buffer_ids),
        num_negatives=k, buffer_sample_size=m, mult=mult, approx_topk=False,
    )
    pool, idx, ids = sampling.sample_negatives_pooled(
        torch.from_numpy(clicked), torch.from_numpy(buffer_ids),
        num_negatives=k, buffer_sample_size=m, mult=mult,
        uniforms=jax_uniforms(seed, clicked, buffer_ids, k, m, mult),
    )
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jax_pool))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax_idx))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax_ids))
    assert ids.dtype == torch.int32 and int(pool[-1]) == 0


def _sample(clicked, buffer_ids, k, m, seed, mult=20):
    return sampling.sample_negatives(
        torch.as_tensor(clicked), torch.as_tensor(buffer_ids),
        num_negatives=k, buffer_sample_size=m, mult=mult,
        generator=torch.Generator().manual_seed(seed),
    ).numpy()


@pytest.mark.parametrize("seed", range(4))
def test_negatives_exclude_session_dedup_and_pad_with_sentinel(seed):
    buffer_ids = np.arange(0, 64, dtype=np.int32) % 40
    neg = _sample(CLICKED, buffer_ids, 8, 32, seed)
    assert neg.shape == (3, 5, 8)
    for b in range(3):
        session_items = set(CLICKED[b].tolist()) - {0}
        for t in range(5):
            row = neg[b, t]
            if CLICKED[b, t] == 0:
                assert (row == 0).all()
                continue
            nonzero = row[row != 0]
            assert not set(nonzero.tolist()) & session_items
            assert len(set(nonzero.tolist())) == len(nonzero)
            # padding only as the sentinel, after every real candidate
            assert (row[len(nonzero):] == 0).all()


def test_negatives_padded_when_candidates_scarce():
    clicked = np.array([[1, 2, 0, 0]], np.int32)
    buffer_ids = np.array([5, 6, 7, 0, 0, 0, 0, 0], np.int32)
    for seed in range(5):
        row = _sample(clicked, buffer_ids, 6, 8, seed)[0, 0]
        assert sorted(row[:3].tolist()) == [5, 6, 7]
        assert (row[3:] == 0).all()


def test_first_pick_probability_proportional_to_duplicates():
    """With K = 1, P(picked = v) = count(v) / total: the law of the first
    element of a uniform shuffle of the pool."""
    clicked = np.array([[900, 901, 0]], np.int32)
    buffer_ids = np.array([1, 1, 1, 1, 2, 2, 3, 4] + [0] * 8, np.int32)
    expected = {1: 4 / 8, 2: 2 / 8, 3: 1 / 8, 4: 1 / 8}
    n_trials = 1500
    picks = np.array([
        _sample(clicked, buffer_ids, 1, 16, 77_000 + seed)[0, 0, 0]
        for seed in range(n_trials)
    ])
    for v, p in expected.items():
        freq = float(np.mean(picks == v))
        band = 4 * (p * (1 - p) / n_trials) ** 0.5  # 4 sigma
        assert abs(freq - p) < band + 0.01, (v, freq, p)


def test_sampler_needs_a_source_of_randomness():
    with pytest.raises(ValueError, match="generator or uniforms"):
        sampling.sample_negatives_pooled(
            torch.from_numpy(CLICKED), torch.zeros(8, dtype=torch.int32),
            num_negatives=2, buffer_sample_size=4,
        )

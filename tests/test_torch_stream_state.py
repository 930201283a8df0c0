"""The port's StreamState update against the JAX package's, field by field
and exactly, over a multi-batch stream that crosses the buffer window and
holds ids at and above ``num_items`` (the JAX scatter drops them from the
counts; ``index_add_`` would raise on them)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleon_recsys_tpu.config import SECONDS_PER_HOUR
from chameleon_recsys_tpu.state.stream_state import (
    init_stream_state as jax_init,
    update_stream_state as jax_update,
)

import chameleon_recsys_tpu_torch as port
from chameleon_recsys_tpu_torch.state.stream_state import (
    init_stream_state,
    update_stream_state,
)

from conftest import tiny_nar_config

NUM_ITEMS = 40


def _batch(rng, b, length, hour):
    ids = rng.randint(1, NUM_ITEMS + 6, size=(b, length))  # some >= NUM_ITEMS
    lengths = rng.randint(1, length + 1, size=b)
    ts = 100000 + hour * SECONDS_PER_HOUR + rng.randint(0, 3600, size=(b, length))
    ts = np.sort(ts, axis=1)
    for i in range(b):
        ids[i, lengths[i]:] = 0
        ts[i, lengths[i]:] = 0
    return ids.astype(np.int32), ts.astype(np.int32)


def _assert_equal(port_state, jax_state):
    for name in jax_state._fields:
        np.testing.assert_array_equal(
            getattr(port_state, name).numpy(),
            np.asarray(getattr(jax_state, name)),
            err_msg=name,
        )


@pytest.mark.parametrize("buffer_size,hours", [(50, 1.0), (12, 1.0), (64, 0.5)])
def test_stream_state_matches_jax(buffer_size, hours):
    kwargs = dict(
        recent_clicks_buffer_max_size=buffer_size,
        recent_clicks_buffer_hours=hours,
    )
    jax_cfg = tiny_nar_config(**kwargs)
    port_cfg = port.NARConfig(**kwargs, recent_clicks_for_normalization=64)
    assert jax_cfg.recent_clicks_for_normalization == 64
    jax_state = jax_init(jax_cfg, NUM_ITEMS)
    port_state = init_stream_state(port_cfg, NUM_ITEMS, device="cpu")
    _assert_equal(port_state, jax_state)

    rng = np.random.RandomState(buffer_size)
    saw_out_of_range = False
    for hour in (0, 0, 1, 3):  # 4 batches; the last jumps past the window
        ids, ts = _batch(rng, 6, 5, hour)
        saw_out_of_range |= bool((ids >= NUM_ITEMS).any())
        jax_state = jax_update(jax_state, jnp.asarray(ids), jnp.asarray(ts), jax_cfg)
        port_state = update_stream_state(
            port_state, torch.from_numpy(ids), torch.from_numpy(ts), port_cfg
        )
        _assert_equal(port_state, jax_state)
    assert saw_out_of_range
    assert int(port_state.current_step) == 4


def test_empty_batch_matches_jax():
    """A batch without clicks has no minimum timestamp: the window threshold
    then lies near INT32_MAX and, as in the JAX package, the buffer empties."""
    cfg = port.NARConfig(
        recent_clicks_buffer_max_size=8, recent_clicks_for_normalization=64
    )
    jax_cfg = tiny_nar_config(recent_clicks_buffer_max_size=8)
    ids = np.array([[3, 4, 0]], np.int32)
    ts = np.array([[1000, 1010, 0]], np.int32)
    empty = np.zeros((1, 3), np.int32)
    port_state = init_stream_state(cfg, 10, device="cpu")
    jax_state = jax_init(jax_cfg, 10)
    for batch_ids, batch_ts in ((ids, ts), (empty, empty)):
        port_state = update_stream_state(
            port_state, torch.from_numpy(batch_ids), torch.from_numpy(batch_ts), cfg
        )
        jax_state = jax_update(
            jax_state, jnp.asarray(batch_ids), jnp.asarray(batch_ts), jax_cfg
        )
        _assert_equal(port_state, jax_state)
        if batch_ids is ids:
            assert port_state.buffer_ids[:2].tolist() == [4, 3]
    assert not port_state.buffer_ids.any()

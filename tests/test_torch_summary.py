"""The port's scalar and histogram writers against the JAX package's.

``utils/summary.py`` writes the same JSON-lines rows as the JAX copy: the
same keys in the same order, the same values (but ``wall_time``, the
clock's).  A model's histograms: a tiny JAX ``NARModel``'s params go
through ``convert.params_from_flax`` into the port's model, and each
package writes the histograms of its own tree; under the names mapped by
``convert`` the counts, bin edges, minima and maxima are equal, and the
means and standard deviations agree to 1e-12 relative (float64 sums of
the same values, a transposed kernel summed in another order).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chameleon_recsys_tpu.data.collate import collate_sessions
from chameleon_recsys_tpu.data.synthetic import make_synthetic_corpus, synthetic_hour_sessions
from chameleon_recsys_tpu.models.nar import NARAux
from chameleon_recsys_tpu.models.nar import NARModel as JaxNARModel
from chameleon_recsys_tpu.state.stream_state import init_stream_state as jax_init_stream
from chameleon_recsys_tpu.utils import summary as jax_summary

import chameleon_recsys_tpu_torch as port
from chameleon_recsys_tpu_torch.convert import _flax_path, params_from_flax
from chameleon_recsys_tpu_torch.utils import summary

from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema
from test_torch_serve import port_article_schema, port_config, port_session_schema

NUM_ITEMS = 120


def rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_scalar_rows_match_jax(tmp_path):
    writes = [(1, {"loss": 3.2, "clicks": 40}), (2, {"loss": np.float32(3.1), "clicks": 41}),
              (3, {"loss": 3.0, "clicks": np.int64(42)})]
    for module, name in ((summary, "port"), (jax_summary, "jax")):
        writer = module.ScalarWriter(str(tmp_path / name), buffer_rows=2)
        for step, values in writes:
            writer.write(step, values)
        writer.flush()
    port_rows = rows(tmp_path / "port" / "train_scalars.jsonl")
    jax_rows = rows(tmp_path / "jax" / "train_scalars.jsonl")
    assert [list(r) for r in port_rows] == [list(r) for r in jax_rows]
    for p, j in zip(port_rows, jax_rows):
        assert {k: v for k, v in p.items() if k != "wall_time"} == \
            {k: v for k, v in j.items() if k != "wall_time"}
    assert port_rows == list(summary.read_jsonl(tmp_path / "port" / "train_scalars.jsonl"))


@pytest.mark.parametrize("bins", [10, 30])
def test_histogram_rows_match_jax(tmp_path, bins):
    values = np.random.RandomState(bins).randn(50, 4).astype(np.float32)
    for module, name in ((summary, "port"), (jax_summary, "jax")):
        writer = module.HistogramWriter(str(tmp_path / name), bins=bins)
        writer.write(7, "layer/kernel", values)
        writer.write(8, "empty", np.zeros(0))  # an empty array writes no row
    port_rows = rows(tmp_path / "port" / "train_histograms.jsonl")
    assert port_rows == rows(tmp_path / "jax" / "train_histograms.jsonl")
    assert len(port_rows) == 1 and sum(port_rows[0]["counts"]) == 200


def test_converted_weights_histograms_match_jax(tmp_path):
    cfg = tiny_nar_config()
    art, sess = tiny_article_schema(NUM_ITEMS), tiny_session_schema(NUM_ITEMS)
    corpus = make_synthetic_corpus(art, ace_dim=8)
    batch = {k: jnp.asarray(v) for k, v in collate_sessions(
        synthetic_hour_sessions(corpus, sess, 0, cfg.batch_size, cfg.max_session_length),
        sess, cfg.batch_size, cfg.max_session_length).items()}
    stream = jax_init_stream(cfg, NUM_ITEMS)
    aux = NARAux(ace_matrix=jnp.asarray(corpus.ace_matrix),
                 metadata={k: jnp.asarray(v) for k, v in corpus.metadata.items()},
                 recent_pop_norm=stream.recent_pop_norm, buffer_ids=stream.buffer_ids)
    neg = jnp.zeros((cfg.batch_size, cfg.max_inputs_length, cfg.negative_samples),
                    jnp.int32)
    key = jax.random.key(3)
    params = JaxNARModel(cfg, sess, art).init({"params": key, "dropout": key}, batch, aux,
                                              neg, train=False)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    model = port.NARModel(port_config(cfg), port_session_schema(sess),
                          port_article_schema(art), corpus.ace_matrix.shape[1])
    model.load_state_dict(params_from_flax(params, model))

    jax_summary.HistogramWriter(str(tmp_path / "jax")).write_tree(5, params,
                                                                  prefix="params/")
    summary.HistogramWriter(str(tmp_path / "port")).write_tree(5, model, prefix="params/")
    jax_rows = {r["name"]: r for r in rows(tmp_path / "jax" / "train_histograms.jsonl")}
    port_rows = rows(tmp_path / "port" / "train_histograms.jsonl")
    names = [r["name"] for r in port_rows]
    assert names == ["params/" + n for n, _ in model.named_parameters()]
    mapped = {"params/" + _flax_path(n[len("params/"):])[0]: r
              for n, r in zip(names, port_rows)}
    assert sorted(mapped) == sorted(jax_rows)
    for name, row in mapped.items():
        want = jax_rows[name]
        for key in ("step", "counts", "bin_edges", "min", "max"):
            assert row[key] == want[key], (name, key)
        for key in ("mean", "std"):
            assert row[key] == pytest.approx(want[key], rel=1e-12, abs=1e-15), (name, key)

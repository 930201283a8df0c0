"""The port's artifact store against the JAX package's.

``utils/artifact_store.py``: the local backend's round trip, the ``gs://``
backend on the JAX tests' in-memory fake client, ``open_artifact_store``,
``warm_start_model_dir`` and the rejection of a blob key that escapes the
download directory.  Each operation runs on both packages' stores over the
same tree; the files moved and the lists returned (relative to each
store's root) are equal.  Then the port's harness uploads ``model_dir`` on
every export, as the JAX harness does.
"""
import pytest

from chameleon_recsys_tpu.utils import artifact_store as jax_store

from chameleon_recsys_tpu_torch.config import RunConfig
from chameleon_recsys_tpu_torch.data.synthetic import (
    make_synthetic_corpus,
    synthetic_hour_sessions,
)
from chameleon_recsys_tpu_torch.train.temporal import TemporalHarness
from chameleon_recsys_tpu_torch.utils import artifact_store

from conftest import tiny_article_schema, tiny_nar_config, tiny_session_schema
from test_artifact_store import _FakeGCSClient, _tree
from test_torch_serve import port_article_schema, port_config, port_session_schema

MODULES = {"port": artifact_store, "jax": jax_store}


def relative(paths, root):
    return [str(p).replace(str(root), "<root>") for p in paths]


def read_tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("backend", ["local", "gs"])
def test_store_round_trip_matches_jax(tmp_path, backend):
    src = _tree(tmp_path)
    results = {}
    for name, module in MODULES.items():
        base = tmp_path / name
        client = _FakeGCSClient()
        root = "gs://bucket/exp" if backend == "gs" else str(base / "remote")
        store = module.open_artifact_store(root, client=client)
        assert isinstance(store, module.ArtifactStore)
        assert isinstance(store, module.GCSArtifactStore if backend == "gs"
                          else module.LocalArtifactStore)
        results[name] = dict(
            uploaded=relative(store.upload_dir(src, "jobs/run1"), base),
            filtered=relative(store.upload_dir(src, "jobs/ckpt", filename_pattern="ckpt"),
                              base),
            exists=(store.exists("jobs/run1"), store.exists("jobs/other")),
            downloaded=relative(store.download_dir("jobs/run1", base / "dst"), base),
            only_csv=relative(store.download_dir("jobs/run1", base / "csv",
                                                 filename_pattern=".csv"), base),
            dst=read_tree(base / "dst"),
            csv=read_tree(base / "csv"),
            warm=relative(module.warm_start_model_dir(store, "jobs/run1", base / "md"),
                          base),
            warm_missing=module.warm_start_model_dir(store, "nope", base / "md2"),
            blobs=sorted(client.blobs),
        )
    assert results["port"] == results["jax"]
    port = results["port"]
    assert len(port["uploaded"]) == len(port["downloaded"]) == len(port["warm"]) == 3
    assert port["exists"] == (True, False) and port["warm_missing"] == []
    assert port["dst"] == read_tree(src) and list(port["csv"]) == ["metrics.csv"]


def test_gcs_rejects_path_traversal_as_jax(tmp_path):
    for name, module in MODULES.items():
        client = _FakeGCSClient()
        store = module.GCSArtifactStore("gs://bucket", client=client)
        client.blobs["r/../../evil.txt"] = b"pwned"
        with pytest.raises(ValueError, match="escapes"):
            store.download_dir("r", tmp_path / name / "out")
        assert not (tmp_path / name / "evil.txt").exists()
        with pytest.raises(ValueError, match="gs://"):
            module.GCSArtifactStore("s3://bucket", client=client)


def test_harness_uploads_on_export(tmp_path):
    """Every export uploads model_dir through the store; a warm start from
    the store resumes the run."""
    cfg = port_config(tiny_nar_config(batch_size=8, max_session_length=6))
    art = port_article_schema(tiny_article_schema(120))
    sess = port_session_schema(tiny_session_schema(120))
    corpus = make_synthetic_corpus(art, ace_dim=8)
    store = artifact_store.LocalArtifactStore(tmp_path / "remote")

    def source(hour):
        return synthetic_hour_sessions(corpus, sess, hour, 10, cfg.max_session_length)

    def harness(model_dir, **kw):
        return TemporalHarness(
            cfg, RunConfig(model_dir=str(model_dir), training_hours_for_each_eval=1),
            sess, art, corpus.ace_matrix, corpus.metadata, device="cpu", **kw)

    h1 = harness(tmp_path / "run1", artifact_store=store, artifact_remote_path="jobs/run1")
    h1.run(source, range(2))
    assert store.exists("jobs/run1/eval_stats_benchmarks.csv")
    assert read_tree(tmp_path / "remote" / "jobs" / "run1") == read_tree(tmp_path / "run1")
    h1.save_checkpoint()
    h1.export_artifacts()
    fetched = artifact_store.warm_start_model_dir(store, "jobs/run1", tmp_path / "run2")
    assert any(f.endswith("checkpoint.pkl") for f in fetched)
    h2 = harness(tmp_path / "run2")
    h2.load_checkpoint(tmp_path / "run2" / "checkpoint.pkl")
    assert (h2.hours_trained, h2.evals_done) == (h1.hours_trained, h1.evals_done)
    for name, value in h1.state.stream._asdict().items():
        assert (getattr(h2.state.stream, name) == value).all(), name

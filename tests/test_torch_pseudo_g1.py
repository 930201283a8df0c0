"""The port's pseudo-G1 bundle and G1 preprocessing CLI against the JAX
package's.

``data/pseudo_g1.py::write_bundle`` must write the same bytes as the JAX
generator for the same ``PseudoG1Spec``, in both regimes (``legacy`` and
``mixed``) and at one and two workers (``cli/make_pseudo_g1.py`` is held to
the JAX CLI's bytes in ``tests/test_torch_cli_g1.py``).
``cli/nar_preprocess_gcom.py`` must turn the same click CSVs into the same
session TFRecords as the JAX CLI, at one and two workers: the payload
equal, and the raw gzip file equal but for the header's mtime (the clock's).
"""
import gzip
from pathlib import Path

import pytest

from chameleon_recsys_tpu.cli import nar_preprocess_gcom as jax_preprocess
from chameleon_recsys_tpu.data import pseudo_g1 as jax_pseudo_g1

from chameleon_recsys_tpu_torch.cli import nar_preprocess_gcom
from chameleon_recsys_tpu_torch.data import pseudo_g1

SPEC = dict(num_articles=400, num_categories=12, ace_dim=16, hours=4,
            mean_sessions_per_hour=60, num_users=500, seed=3)


def spec(module, regime):
    ctor = module.PseudoG1Spec.mixed if regime == "mixed" else module.PseudoG1Spec
    return ctor(**SPEC)


def files(root: Path):
    return {p.relative_to(root).as_posix(): p for p in sorted(root.rglob("*"))
            if p.is_file()}


def assert_same_tree(port_root, jax_root):
    port_files, jax_files = files(port_root), files(jax_root)
    assert sorted(port_files) == sorted(jax_files) and port_files
    for rel, path in port_files.items():
        assert path.read_bytes() == jax_files[rel].read_bytes(), rel


@pytest.fixture(scope="module")
def jax_bundles(tmp_path_factory):
    """The JAX generator's bundle of each regime, written serially."""
    root = tmp_path_factory.mktemp("jax_bundles")
    out = {}
    for regime in ("legacy", "mixed"):
        out[regime] = root / regime
        totals = jax_pseudo_g1.write_bundle(spec(jax_pseudo_g1, regime), str(out[regime]),
                                            verbose=False)
        out[regime, "totals"] = totals
    return out


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("regime", ["legacy", "mixed"])
def test_bundle_byte_equal_jax(jax_bundles, tmp_path, regime, workers):
    totals = pseudo_g1.write_bundle(spec(pseudo_g1, regime), str(tmp_path),
                                    num_workers=workers, verbose=False)
    assert totals == jax_bundles[regime, "totals"]
    assert_same_tree(tmp_path, jax_bundles[regime])


@pytest.mark.parametrize("workers", [1, 2])
def test_preprocess_byte_equal_jax(jax_bundles, tmp_path, workers):
    clicks = str(jax_bundles["mixed"] / "clicks" / "clicks_hour_*.csv")
    outputs = {}
    for name, cli, platform in (("port", nar_preprocess_gcom, "cuda"),
                                ("jax", jax_preprocess, "cpu")):
        out = tmp_path / name
        cli.main(["--input_clicks_csv_path_regex", clicks,
                  "--output_sessions_tfrecords_path",
                  str(out / "sessions_hour_*.tfrecord.gz"),
                  "--num_workers", str(workers), "--platform", platform])
        outputs[name] = files(out)
    assert sorted(outputs["port"]) == sorted(outputs["jax"])
    assert len(outputs["port"]) == SPEC["hours"]
    for rel, path in outputs["port"].items():
        port_raw, jax_raw = (bytearray(p.read_bytes())
                             for p in (path, outputs["jax"][rel]))
        assert gzip.decompress(port_raw) == gzip.decompress(jax_raw), rel
        port_raw[4:8] = jax_raw[4:8] = b"\0\0\0\0"  # the header's mtime
        assert port_raw == jax_raw, rel

"""The port's TFRecord / SequenceExample IO against the JAX package's.

Both packages write the G1 session files: gzipped TFRecords of
SequenceExamples (``data/tfrecord.py``, ``data/example_proto.py``,
``data/sessions.py``).  The port must write the same bytes (the gzip
header's mtime aside, which is the clock's) and each package must read the
other's files into equal sessions.  Exact equality throughout: the codecs
are integer and byte code, and floats go through the same struct packing.
"""
import dataclasses
import gzip
import zlib

import numpy as np
import pytest

from chameleon_recsys_tpu.config import gcom_session_schema as jax_gcom_session_schema
from chameleon_recsys_tpu.data import example_proto as jax_proto
from chameleon_recsys_tpu.data import sessions as jax_sessions
from chameleon_recsys_tpu.data import tfrecord as jax_tfrecord
from chameleon_recsys_tpu.data.collate import Session as JaxSession
from chameleon_recsys_tpu.data.preprocessing import time_features as jax_time

from chameleon_recsys_tpu_torch.config import gcom_session_schema
from chameleon_recsys_tpu_torch.data import example_proto, sessions, tfrecord
from chameleon_recsys_tpu_torch.data.collate import Session
from chameleon_recsys_tpu_torch.data.preprocessing import time_features

EPOCH_MS = 1_506_826_800_000


def gzip_payload_and_header(path):
    """(the decompressed bytes, the raw file with the header's mtime
    field, bytes 4-8, zeroed).  The header also holds the file's name, so
    the files compared have the same name in two directories."""
    raw = bytearray(path.read_bytes())
    raw[4:8] = b"\0\0\0\0"
    return gzip.decompress(bytes(raw)), bytes(raw)


@pytest.mark.parametrize("data", [b"", b"123456789", b"a", bytes(range(256)) * 5])
def test_crc32c_matches_jax(data):
    assert tfrecord.crc32c(data) == jax_tfrecord.crc32c(data)
    assert tfrecord.masked_crc32c(data) == jax_tfrecord.masked_crc32c(data)
    # the Castagnoli check value, and the stdlib's CRC-32 is another polynomial
    assert tfrecord.crc32c(b"123456789") == 0xE3069283
    if data:
        assert tfrecord.crc32c(data) != zlib.crc32(data)


def test_tfrecord_files_byte_equal(tmp_path):
    records = [b"hello", b"", b"x" * 10000, bytes(range(256))]
    port_path, jax_path = (tmp_path / d / "hour.tfrecord.gz" for d in ("port", "jax"))
    tfrecord.write_tfrecord_file(port_path, records)
    jax_tfrecord.write_tfrecord_file(jax_path, records)
    assert gzip_payload_and_header(port_path) == gzip_payload_and_header(jax_path)
    for reader, path in ((tfrecord.read_tfrecord_file, jax_path),
                         (jax_tfrecord.read_tfrecord_file, port_path)):
        assert list(reader(path, verify_crc=True)) == records


EXAMPLES = {
    "ints_floats_bytes": ({"session_id": [123456789012], "neg": [-5], "name": [b"abc"]},
                          {"items": [[1], [2], [3]], "scores": [[0.5], [1.5], [-2.25]]}),
    "empty_lists": ({"empty": []}, {"steps": [[], [7], []]}),
    "wide_values": ({"big": [2 ** 62, -(2 ** 62)], "s": ["text"]},
                    {"f": [[1e-30, 3.4e38, -0.0]], "i": [[0, 1, 2 ** 40]]}),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_sequence_example_bytes_equal(name):
    context, sequences = EXAMPLES[name]
    buf = example_proto.encode_sequence_example(context, sequences)
    assert buf == jax_proto.encode_sequence_example(context, sequences)
    assert example_proto.decode_sequence_example(buf) == \
        jax_proto.decode_sequence_example(buf)
    features = {**context, **{k: v[0] for k, v in sequences.items()}}
    buf = example_proto.encode_example(features)
    assert buf == jax_proto.encode_example(features)
    assert example_proto.decode_example(buf) == jax_proto.decode_example(buf)


def g1_sessions(seed, n=20):
    """Sessions with every G1 context feature, from a seeded numpy draw."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k = int(rng.randint(2, 8))
        start = int(rng.randint(0, 10 ** 6))
        ts = (start + np.cumsum(rng.randint(0, 60, size=k))).tolist()
        context = {name: rng.randint(1, 5, size=k).tolist() for name in (
            "environment", "deviceGroup", "os", "country", "region", "referrer_type")}
        for name in ("local_hour_sin", "local_hour_cos", "local_weekday"):
            context[name] = rng.uniform(-1, 1, size=k).tolist()
        out.append(Session(session_id=10_000_000 + i, user_id=int(rng.randint(1, 1000)),
                           session_start=ts[0],
                           item_ids=rng.randint(1, 500, size=k).tolist(),
                           timestamps=ts, context=context))
    return out


def test_sessions_tfrecord_byte_equal_and_cross_read(tmp_path):
    port_sessions = g1_sessions(0)
    jax_sessions_in = [JaxSession(**dataclasses.asdict(s)) for s in port_sessions]
    schema, jax_schema = gcom_session_schema(500), jax_gcom_session_schema(500)
    port_path, jax_path = (tmp_path / d / "hour.tfrecord.gz" for d in ("port", "jax"))
    sessions.write_sessions_tfrecord(port_sessions, schema, port_path, epoch_ms=EPOCH_MS)
    jax_sessions.write_sessions_tfrecord(jax_sessions_in, jax_schema, jax_path,
                                         epoch_ms=EPOCH_MS)
    assert gzip_payload_and_header(port_path) == gzip_payload_and_header(jax_path)
    port_read = sessions.read_sessions_tfrecord(jax_path, schema, epoch_ms=EPOCH_MS)
    jax_read = jax_sessions.read_sessions_tfrecord(port_path, jax_schema,
                                                   epoch_ms=EPOCH_MS)
    assert all(isinstance(s, Session) for s in port_read)
    assert [dataclasses.asdict(s) for s in port_read] == \
        [dataclasses.asdict(s) for s in jax_read]
    # the round trip keeps the ints exactly and the floats to f32
    for orig, got in zip(port_sessions, port_read):
        assert (got.session_id, got.user_id, got.item_ids, got.timestamps) == \
            (orig.session_id, orig.user_id, orig.item_ids, orig.timestamps)
        np.testing.assert_array_equal(
            np.float32(got.context["local_hour_sin"]),
            np.float32(orig.context["local_hour_sin"]))


@pytest.mark.parametrize("timestamp_ms", [
    EPOCH_MS,
    # across Brazil's 2017 DST start (2017-10-15 00:00 local, -03:00 -> -02:00)
    1_508_036_399_000, 1_508_036_400_000,
    1_509_000_000_123,
])
def test_time_features_match_jax(timestamp_ms):
    assert time_features.local_time_features(timestamp_ms) == \
        jax_time.local_time_features(timestamp_ms)

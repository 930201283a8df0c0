"""Minimal protobuf wire-format codec for tf.train.{Example, SequenceExample}.

The reference's on-disk session/article artifacts are gzipped TFRecord files
of SequenceExample protos (tf_records_management.py:22-32, datasets.py:35-82).
This codec speaks exactly that format without a TensorFlow dependency —
enough of proto wire encoding (varints, length-delimited submessages) to
round-trip the three Feature list types.

Schema (tensorflow/core/example/{example,feature}.proto):
  Feature        { oneof: bytes_list=1, float_list=2, int64_list=3 }
  BytesList      { repeated bytes value = 1 }
  FloatList      { repeated float value = 1 (packed) }
  Int64List      { repeated int64 value = 1 (packed) }
  Features       { map<string, Feature> feature = 1 }
  FeatureList    { repeated Feature feature = 1 }
  FeatureLists   { map<string, FeatureList> feature_list = 1 }
  Example        { Features features = 1 }
  SequenceExample{ Features context = 1; FeatureLists feature_lists = 2 }

The port's copy of ``chameleon_recsys_tpu/data/example_proto.py``: the same
bytes out for the same values.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

FeatureValue = Union[List[int], List[float], List[bytes]]

# ---------------------------------------------------------------------------
# varint / wire primitives
# ---------------------------------------------------------------------------


def _write_varint(out: bytearray, value: int):
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag_int64(value: int) -> int:
    return value & 0xFFFFFFFFFFFFFFFF  # int64 negatives use 10-byte varints


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delimited(out: bytearray, field: int, payload: bytes):
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out.extend(payload)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _encode_feature(values: FeatureValue) -> bytes:
    inner = bytearray()
    if len(values) and isinstance(values[0], (bytes, str)):
        for v in values:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _write_len_delimited(inner, 1, v)
        out = bytearray()
        _write_len_delimited(out, 1, bytes(inner))  # Feature.bytes_list
        return bytes(out)
    if len(values) and isinstance(values[0], float):
        packed = struct.pack(f"<{len(values)}f", *values)
        _write_len_delimited(inner, 1, packed)
        out = bytearray()
        _write_len_delimited(out, 2, bytes(inner))  # Feature.float_list
        return bytes(out)
    # default: int64 list (possibly empty)
    packed = bytearray()
    for v in values:
        _write_varint(packed, _zigzag_int64(int(v)))
    if values:
        _write_len_delimited(inner, 1, bytes(packed))
    out = bytearray()
    _write_len_delimited(out, 3, bytes(inner))  # Feature.int64_list
    return bytes(out)


def _encode_features_map(features: Dict[str, FeatureValue]) -> bytes:
    out = bytearray()
    for name, values in features.items():
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))
        _write_len_delimited(entry, 2, _encode_feature(values))
        _write_len_delimited(out, 1, bytes(entry))
    return bytes(out)


def encode_sequence_example(
    context: Dict[str, FeatureValue],
    sequences: Dict[str, List[FeatureValue]],
) -> bytes:
    """``sequences[name]`` is a list of per-step value lists."""
    out = bytearray()
    _write_len_delimited(out, 1, _encode_features_map(context))

    fl_out = bytearray()
    for name, steps in sequences.items():
        flist = bytearray()
        for step_values in steps:
            _write_len_delimited(flist, 1, _encode_feature(step_values))
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))
        _write_len_delimited(entry, 2, bytes(flist))
        _write_len_delimited(fl_out, 1, bytes(entry))
    _write_len_delimited(out, 2, bytes(fl_out))
    return bytes(out)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    out = bytearray()
    _write_len_delimited(out, 1, _encode_features_map(features))
    return bytes(out)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:
            value = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            value = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _decode_int64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _decode_feature(buf: bytes) -> FeatureValue:
    for field, wire, value in _iter_fields(buf):
        if field == 1:  # bytes_list
            return [v for f, w, v in _iter_fields(value) if f == 1]
        if field == 2:  # float_list
            floats: List[float] = []
            for f, w, v in _iter_fields(value):
                if f == 1 and w == 2:  # packed
                    floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                elif f == 1 and w == 5:
                    floats.append(struct.unpack("<f", v)[0])
            return floats
        if field == 3:  # int64_list
            ints: List[int] = []
            for f, w, v in _iter_fields(value):
                if f == 1 and w == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(_decode_int64(x))
                elif f == 1 and w == 0:
                    ints.append(_decode_int64(v))
            return ints
    return []


def _decode_features_map(buf: bytes) -> Dict[str, FeatureValue]:
    out: Dict[str, FeatureValue] = {}
    for field, _, value in _iter_fields(buf):
        if field != 1:
            continue
        name = None
        feature: FeatureValue = []
        for f, _, v in _iter_fields(value):
            if f == 1:
                name = v.decode("utf-8")
            elif f == 2:
                feature = _decode_feature(v)
        if name is not None:
            out[name] = feature
    return out


def decode_sequence_example(buf: bytes):
    context: Dict[str, FeatureValue] = {}
    sequences: Dict[str, List[FeatureValue]] = {}
    for field, _, value in _iter_fields(buf):
        if field == 1:
            context = _decode_features_map(value)
        elif field == 2:
            for f, _, entry in _iter_fields(value):
                if f != 1:
                    continue
                name = None
                steps: List[FeatureValue] = []
                for ff, _, vv in _iter_fields(entry):
                    if ff == 1:
                        name = vv.decode("utf-8")
                    elif ff == 2:
                        steps = [
                            _decode_feature(fv)
                            for f3, _, fv in _iter_fields(vv)
                            if f3 == 1
                        ]
                if name is not None:
                    sequences[name] = steps
    return context, sequences


def decode_example(buf: bytes) -> Dict[str, FeatureValue]:
    for field, _, value in _iter_fields(buf):
        if field == 1:
            return _decode_features_map(value)
    return {}

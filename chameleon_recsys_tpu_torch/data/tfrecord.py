"""TFRecord container IO (gzip-compressed), TensorFlow-free.

Record framing (tensorflow/core/lib/io/record_writer.cc):
    uint64 length | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)
with CRC32-C (Castagnoli) and TF's mask ``((crc >> 15 | crc << 17) +
0xa282ead8)``.  The reference writes one gzipped TFRecord file of
SequenceExamples per hour (tf_records_management.py:22-32); these functions
read and write that exact artifact.

The port's copy of ``chameleon_recsys_tpu/data/tfrecord.py``, byte for byte
the same writer (the gzip header's mtime included: ``gzip.open``'s default).
"""
from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Iterable, Iterator, Optional

_CRC_TABLE = []


def _build_crc_table():
    poly = 0x82F63B78  # reversed Castagnoli polynomial
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def write_tfrecord_file(
    path, records: Iterable[bytes], compression: Optional[str] = "GZIP"
):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    opener = gzip.open if compression == "GZIP" else open
    with opener(path, "wb") as f:
        for record in records:
            length = struct.pack("<Q", len(record))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(record)
            f.write(struct.pack("<I", masked_crc32c(record)))


def read_tfrecord_file(
    path, compression: Optional[str] = "GZIP", verify_crc: bool = False
) -> Iterator[bytes]:
    opener = gzip.open if compression == "GZIP" else open
    with opener(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if crc != masked_crc32c(header[:8]):
                    raise IOError(f"corrupt TFRecord length crc in {path}")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise IOError(f"truncated TFRecord in {path}")
            if verify_crc:
                (crc,) = struct.unpack("<I", footer)
                if crc != masked_crc32c(data):
                    raise IOError(f"corrupt TFRecord data crc in {path}")
            yield data

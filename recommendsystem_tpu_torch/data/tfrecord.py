"""TFRecord container I/O without TensorFlow.

Counterpart of ``recommendsystem_tpu/data/tfrecord.py``, byte for byte the
same framing and CRC.  The reference reads TFRecord shards of tf.Example
(``staytime/parse.py:81-83``).  This is a dependency-free implementation of
the on-disk format: each record is

    uint64 length (LE) | uint32 masked_crc32c(length) |
    bytes  data        | uint32 masked_crc32c(data)

CRC verification is optional on read (off by default for speed — the C++
loader, ``data/native_loader.py``, does checksummed reads at full rate).
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator, List, Optional

_CRC_TABLE: Optional[List[int]] = None
_MASK_DELTA = 0xA282EAD8


def _crc32c_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78   # Castagnoli, reversed
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA & 0xFFFFFFFF


def write_tfrecord(path: str, records: Iterable[bytes]) -> int:
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc32c(rec)))
            n += 1
    return n


def read_tfrecord(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != crc:
                    raise IOError(f"{path}: corrupted length crc")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise IOError(f"{path}: truncated record")
            if verify_crc:
                (crc,) = struct.unpack("<I", footer)
                if masked_crc32c(data) != crc:
                    raise IOError(f"{path}: corrupted data crc")
            yield data

"""Minimal tf.Example protobuf codec (pure Python, no protobuf runtime).

Counterpart of ``recommendsystem_tpu/data/example_proto.py``: for the same
dict the encoder gives the same bytes, and each package's decoder reads the
other's records.  Implements exactly the subset ``tf.io.parse_example``
needs for the reference's readers (``staytime/parse.py:16-25``): Example >
Features > map<string, Feature> with BytesList / FloatList / Int64List
values.

Wire format (proto3): Example{features=1} Features{feature(map)=1}
Feature{bytes_list=1, float_list=2, int64_list=3} *List{value=1}, with
numeric lists packed.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

FeatureValue = Union[List[int], List[float], List[bytes]]


# ---------------- varint ----------------

def _write_varint(buf: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag_int64(value: int) -> int:
    """int64 fields are encoded as plain (two's-complement) varints."""
    return value & 0xFFFFFFFFFFFFFFFF


def _unzigzag_int64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


# ---------------- encode ----------------

def _encode_feature(value: FeatureValue) -> bytes:
    inner = bytearray()
    if not value:
        field = 3          # empty -> Int64List
        payload = b""
    elif isinstance(value[0], (bytes, str)):
        field = 1
        for v in value:
            if isinstance(v, str):
                v = v.encode()
            _write_varint(inner, _tag(1, 2))
            _write_varint(inner, len(v))
            inner += v
        payload = bytes(inner)
    elif isinstance(value[0], float):
        field = 2
        packed = struct.pack(f"<{len(value)}f", *value)
        _write_varint(inner, _tag(1, 2))
        _write_varint(inner, len(packed))
        inner += packed
        payload = bytes(inner)
    else:
        field = 3
        for v in value:
            _write_varint(inner, _tag(1, 0))
            _write_varint(inner, _zigzag_int64(int(v)))
        payload = bytes(inner)

    out = bytearray()
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out += payload
    return bytes(out)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    feats = bytearray()
    for name, value in features.items():
        entry = bytearray()
        key = name.encode()
        _write_varint(entry, _tag(1, 2))
        _write_varint(entry, len(key))
        entry += key
        fv = _encode_feature(value)
        _write_varint(entry, _tag(2, 2))
        _write_varint(entry, len(fv))
        entry += fv
        _write_varint(feats, _tag(1, 2))
        _write_varint(feats, len(entry))
        feats += entry

    out = bytearray()
    _write_varint(out, _tag(1, 2))
    _write_varint(out, len(feats))
    out += feats
    return bytes(out)


# ---------------- decode ----------------

def _skip_field(data: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(data, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _decode_list(data: bytes, kind: int) -> FeatureValue:
    pos = 0
    out: list = []
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1:
            pos = _skip_field(data, pos, wire)
            continue
        if kind == 1:                      # bytes
            n, pos = _read_varint(data, pos)
            out.append(data[pos:pos + n])
            pos += n
        elif kind == 2:                    # float
            if wire == 2:                  # packed
                n, pos = _read_varint(data, pos)
                out.extend(struct.unpack(f"<{n // 4}f", data[pos:pos + n]))
                pos += n
            else:                          # unpacked fixed32
                out.extend(struct.unpack("<f", data[pos:pos + 4]))
                pos += 4
        else:                              # int64
            if wire == 2:                  # packed
                n, pos = _read_varint(data, pos)
                stop = pos + n
                while pos < stop:
                    v, pos = _read_varint(data, pos)
                    out.append(_unzigzag_int64(v))
            else:
                v, pos = _read_varint(data, pos)
                out.append(_unzigzag_int64(v))
    return out


def _decode_feature(data: bytes) -> FeatureValue:
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field in (1, 2, 3) and wire == 2:
            n, pos = _read_varint(data, pos)
            return _decode_list(data[pos:pos + n], field)
        pos = _skip_field(data, pos, wire)
    return []


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
    """serialized tf.Example -> {name: list of int/float/bytes}."""
    out: Dict[str, FeatureValue] = {}
    pos = 0
    end = len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1 or wire != 2:
            pos = _skip_field(data, pos, wire)
            continue
        n, pos = _read_varint(data, pos)
        feats = data[pos:pos + n]
        pos += n
        fpos = 0
        while fpos < len(feats):
            ftag, fpos = _read_varint(feats, fpos)
            ffield, fwire = ftag >> 3, ftag & 7
            if ffield != 1 or fwire != 2:
                fpos = _skip_field(feats, fpos, fwire)
                continue
            fn, fpos = _read_varint(feats, fpos)
            entry = feats[fpos:fpos + fn]
            fpos += fn
            # map entry: key=1 (string), value=2 (Feature)
            epos = 0
            key = b""
            feat = b""
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                efield, ewire = etag >> 3, etag & 7
                if efield == 1 and ewire == 2:
                    kn, epos = _read_varint(entry, epos)
                    key = entry[epos:epos + kn]
                    epos += kn
                elif efield == 2 and ewire == 2:
                    vn, epos = _read_varint(entry, epos)
                    feat = entry[epos:epos + vn]
                    epos += vn
                else:
                    epos = _skip_field(entry, epos, ewire)
            out[key.decode()] = _decode_feature(feat)
    return out

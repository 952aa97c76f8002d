"""TFRecord framing + tf.train.Example codec, dependency-free. Ported from
``ray_tpu/data/tfrecord.py`` as written (numpy and ``struct`` only).

Role parity: python/ray/data/datasource/tfrecords_datasource.py — the
reference decodes via the tensorflow/crc32c packages; a data pipeline
shouldn't drag TF in just for the container format, so this implements
the two layers directly:

- TFRecord framing: [len u64le][masked crc32c(len) u32le][data]
  [masked crc32c(data) u32le] per record.
- `tf.train.Example` protobuf: Example{ Features features=1 } /
  Features{ map<string, Feature> feature=1 } / Feature{ oneof
  BytesList=1 | FloatList=2 | Int64List=3 }, each list `repeated` field 1
  (packed or not). Hand-rolled wire codec — the message shapes are frozen
  in the TF data format and four nested message types don't justify a
  protoc dependency.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

import numpy as np

# -- crc32c (software, slice-by-1; fine for data-loading checksums) -------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        tab = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tab.append(c)
        _CRC_TABLE = tab
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# -- record framing -------------------------------------------------------

def read_tfrecord_frames(path: str, *,
                         verify_crc: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                return
            (length,) = struct.unpack("<Q", hdr[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", hdr[8:12])
                if crc != _masked_crc(hdr[:8]):
                    raise ValueError(f"{path}: corrupt length crc")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"{path}: truncated record")
            tail = f.read(4)
            if verify_crc:
                (crc,) = struct.unpack("<I", tail)
                if crc != _masked_crc(data):
                    raise ValueError(f"{path}: corrupt data crc")
            yield data


def write_tfrecord_frames(path: str, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        for data in records:
            hdr = struct.pack("<Q", len(data))
            f.write(hdr)
            f.write(struct.pack("<I", _masked_crc(hdr)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


# -- minimal protobuf wire codec ------------------------------------------

def _read_varint(buf: bytes, pos: int):
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(buf: bytes) -> Iterator[tuple]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:                       # varint
            v, pos = _read_varint(buf, pos)
        elif wt == 1:                     # fixed64
            v = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:                     # length-delimited
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                     # fixed32
            v = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def decode_example(buf: bytes) -> Dict[str, Any]:
    """tf.train.Example bytes -> {name: list|ndarray} feature dict."""
    out: Dict[str, Any] = {}
    for field, _wt, features_buf in _fields(buf):
        if field != 1:       # Example.features
            continue
        for ffield, _fwt, entry in _fields(features_buf):
            if ffield != 1:  # Features.feature (map entry)
                continue
            name, feat = None, None
            for mfield, _mwt, mval in _fields(entry):
                if mfield == 1:
                    name = mval.decode()
                elif mfield == 2:
                    feat = mval
            if name is None or feat is None:
                continue
            out[name] = _decode_feature(feat)
    return out


def _decode_feature(buf: bytes):
    for field, wt, val in _fields(buf):
        if field == 1:       # BytesList
            vals = [v for f, _w, v in _fields(val) if f == 1]
            return vals
        if field == 2:       # FloatList (packed or repeated fixed32)
            floats: List[float] = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:   # packed
                    floats.extend(np.frombuffer(v, "<f4").tolist())
                else:        # unpacked fixed32
                    floats.append(struct.unpack("<f", v)[0])
            return np.asarray(floats, np.float32)
        if field == 3:       # Int64List (packed or repeated varint)
            ints: List[int] = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:   # packed
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(x - (1 << 64) if x >> 63 else x)
                    continue
                ints.append(v - (1 << 64) if v >> 63 else v)
            return np.asarray(ints, np.int64)
    return []


def _encode_ld(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, field << 3 | 2)
    _write_varint(out, len(payload))
    out += payload


def encode_example(features: Dict[str, Any]) -> bytes:
    """{name: bytes|[bytes]|floats|ints} -> tf.train.Example bytes."""
    features_buf = bytearray()
    for name, value in features.items():
        feat = bytearray()
        if isinstance(value, bytes):
            value = [value]
        if isinstance(value, (list, tuple)) and value and \
                isinstance(value[0], bytes):
            blist = bytearray()
            for b in value:
                _encode_ld(blist, 1, b)
            _encode_ld(feat, 1, bytes(blist))
        else:
            arr = np.asarray(value).ravel()
            if arr.dtype.kind == "f":
                flist = bytearray()   # FloatList{ repeated float value=1 }
                _encode_ld(flist, 1, arr.astype("<f4").tobytes())
                _encode_ld(feat, 2, bytes(flist))
            else:
                packed = bytearray()
                for x in arr.astype(np.int64).tolist():
                    _write_varint(packed, x + (1 << 64) if x < 0 else x)
                ilist = bytearray()   # Int64List{ repeated int64 value=1 }
                _encode_ld(ilist, 1, bytes(packed))
                _encode_ld(feat, 3, bytes(ilist))
        entry = bytearray()
        _encode_ld(entry, 1, name.encode())
        _encode_ld(entry, 2, bytes(feat))
        _encode_ld(features_buf, 1, bytes(entry))
    out = bytearray()
    _encode_ld(out, 1, bytes(features_buf))
    return bytes(out)

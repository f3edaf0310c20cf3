"""File datasources: binary blobs, images, TFRecord (a copy of
ray_tpu/data/datasource.py; PIL is imported only to decode images).

Reference: python/ray/data/_internal/datasource/ (image_datasource.py,
binary_datasource.py, tfrecords_datasource.py).  The readers produce
dict-of-ndarray blocks on the existing read-marker path (loaders execute
inside read tasks, not on the driver).

TFRecord support is self-contained: the record framing (length + masked
crc32c) and the tf.train.Example protobuf (BytesList/FloatList/Int64List
features) are implemented directly — no tensorflow dependency — so shards
written here are readable by TF tooling and vice versa.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

# --------------------------------------------------------------------- #
# crc32c (Castagnoli), table-driven — used for TFRecord masked crcs.
# --------------------------------------------------------------------- #

_CRC_TABLE: Optional[List[int]] = None


def _crc32c_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --------------------------------------------------------------------- #
# TFRecord framing
# --------------------------------------------------------------------- #

def tfrecord_iter(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (lcrc,) = struct.unpack("<I", header[8:])
                if _masked_crc(header[:8]) != lcrc:
                    raise ValueError(f"{path}: bad length crc")
            payload = f.read(length)
            footer = f.read(4)
            if len(payload) < length or len(footer) < 4:
                raise ValueError(f"{path}: truncated record")
            if verify_crc:
                (pcrc,) = struct.unpack("<I", footer)
                if _masked_crc(payload) != pcrc:
                    raise ValueError(f"{path}: bad payload crc")
            yield payload


def tfrecord_write(path: str, payloads: Iterator[bytes]) -> None:
    with open(path, "wb") as f:
        for p in payloads:
            header = struct.pack("<Q", len(p))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(p)
            f.write(struct.pack("<I", _masked_crc(p)))


# --------------------------------------------------------------------- #
# Minimal tf.train.Example protobuf codec
#   Example{1: Features}; Features{1: map<string, Feature>};
#   Feature{1: BytesList, 2: FloatList, 3: Int64List};
#   BytesList{1: repeated bytes}, FloatList{1: repeated float packed},
#   Int64List{1: repeated int64 packed varint}.
# --------------------------------------------------------------------- #

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _field(tag: int, wire: int, payload: bytes) -> bytes:
    return _varint((tag << 3) | wire) + (
        _varint(len(payload)) + payload if wire == 2 else payload)


def encode_example(features: Dict[str, Any]) -> bytes:
    """dict of str -> bytes | str | float(s) | int(s) -> tf.train.Example."""
    entries = b""
    for key, value in features.items():
        if isinstance(value, (bytes, str)):
            value = [value.encode() if isinstance(value, str) else value]
            inner = b"".join(_field(1, 2, v) for v in value)
            feature = _field(1, 2, inner)  # BytesList
        elif isinstance(value, (list, tuple, np.ndarray)) and len(value) \
                and isinstance(np.asarray(value).flat[0], (bytes, str)):
            vs = [v.encode() if isinstance(v, str) else v for v in value]
            feature = _field(1, 2, b"".join(_field(1, 2, v) for v in vs))
        else:
            arr = np.atleast_1d(np.asarray(value))
            if np.issubdtype(arr.dtype, np.floating):
                packed = struct.pack(f"<{arr.size}f",
                                     *arr.astype(np.float32).tolist())
                feature = _field(2, 2, _field(1, 2, packed))  # FloatList
            else:
                packed = b"".join(
                    _varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                    for v in arr.astype(np.int64).tolist())
                feature = _field(3, 2, _field(1, 2, packed))  # Int64List
        entry = _field(1, 2, key.encode()) + _field(2, 2, feature)
        entries += _field(1, 2, entry)  # map entry in Features
    return _field(1, 2, entries)  # Example.features


def _parse_fields(buf: bytes) -> Iterator[tuple]:
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        tag, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield tag, wire, val


def decode_example(payload: bytes) -> Dict[str, Any]:
    """tf.train.Example bytes -> dict of str -> np.ndarray | list[bytes]."""
    out: Dict[str, Any] = {}
    features = b""
    for tag, _w, val in _parse_fields(payload):
        if tag == 1:
            features = val
    for tag, _w, entry in _parse_fields(features):
        if tag != 1:
            continue
        key = None
        feature = b""
        for t2, _w2, v2 in _parse_fields(entry):
            if t2 == 1:
                key = v2.decode()
            elif t2 == 2:
                feature = v2
        if key is None:
            continue
        for t3, _w3, v3 in _parse_fields(feature):
            if t3 == 1:  # BytesList
                vals = [v for t4, _w4, v in _parse_fields(v3) if t4 == 1]
                out[key] = vals
            elif t3 == 2:  # FloatList (packed)
                for t4, _w4, v in _parse_fields(v3):
                    if t4 == 1:
                        out[key] = np.frombuffer(v, np.float32).copy()
            elif t3 == 3:  # Int64List (packed varints)
                for t4, _w4, v in _parse_fields(v3):
                    if t4 == 1:
                        vals64: List[int] = []
                        pos = 0
                        while pos < len(v):
                            x, pos = _read_varint(v, pos)
                            if x >= 1 << 63:
                                x -= 1 << 64
                            vals64.append(x)
                        out[key] = np.asarray(vals64, np.int64)
    return out


# --------------------------------------------------------------------- #
# Block loaders (run inside read tasks via the read-marker path)
# --------------------------------------------------------------------- #

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")


def load_binary_block(path: str):
    with open(path, "rb") as f:
        data = f.read()
    return {"bytes": np.asarray([data], object),
            "path": np.asarray([path], object)}


def load_image_block(path: str, size=None, mode=None):
    """Decode one image file -> a single-row block.  ``size`` (H, W)
    resizes at decode; ``mode`` converts (e.g. 'RGB', 'L')."""
    from PIL import Image
    img = Image.open(path)
    if mode:
        img = img.convert(mode)
    if size is not None:
        img = img.resize((size[1], size[0]))
    arr = np.asarray(img)
    return {"image": arr[None, ...],
            "path": np.asarray([path], object)}


def load_tfrecord_block(path: str, verify_crc: bool = False):
    rows: Dict[str, List[Any]] = {}
    count = 0
    for payload in tfrecord_iter(path, verify_crc=verify_crc):
        ex = decode_example(payload)
        for k, v in ex.items():
            rows.setdefault(k, [])
            # Backfill rows missed before this key first appeared.
            while len(rows[k]) < count:
                rows[k].append(None)
            if isinstance(v, list) and len(v) == 1:
                v = v[0]
            rows[k].append(v)
        count += 1
    for k in rows:
        while len(rows[k]) < count:
            rows[k].append(None)
    out: Dict[str, np.ndarray] = {}
    for k, vs in rows.items():
        if vs and isinstance(vs[0], np.ndarray) and \
                all(isinstance(v, np.ndarray) and v.shape == vs[0].shape
                    for v in vs):
            stacked = np.stack(vs)
            # Scalar-per-row features flatten to a 1-D column.
            if stacked.ndim == 2 and stacked.shape[1] == 1:
                stacked = stacked[:, 0]
            out[k] = stacked
        else:
            out[k] = np.asarray(vs, object)
    return out


def write_tfrecord_block(block: Dict[str, np.ndarray], path: str) -> None:
    n = len(next(iter(block.values()))) if block else 0

    def payloads():
        for i in range(n):
            yield encode_example({k: v[i] for k, v in block.items()})
    tfrecord_write(path, payloads())


def expand_paths(paths, exts=None) -> List[str]:
    """Expand files / dirs / globs into a sorted file list."""
    import glob as g
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in files)
        elif any(ch in p for ch in "*?["):
            out.extend(g.glob(p))
        else:
            out.append(p)
    if exts:
        out = [p for p in out if p.lower().endswith(exts)]
    return sorted(out)

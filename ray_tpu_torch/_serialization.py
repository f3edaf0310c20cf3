"""Serialization of values that cross the head's client channel (a copy of
``ray_tpu/_private/serialization.py`` with ``pickle`` in place of
``cloudpickle``).

The frame layout is the JAX package's:

    [u32 n_buffers] [u64 len_meta] [meta: pickle protocol 5]
    ([u64 len_buf] [buf bytes]) * n_buffers

Large numpy arrays and CPU tensors leave their data out of band (pickle
protocol 5's ``PickleBuffer``), so a frame is written with one copy of
each buffer and read back as views over the frame.  There is no
cloudpickle here: functions and classes inside a value pickle by
reference (their module and name), as everywhere in the port.

``persistent_id``/``persistent_load`` let a caller swap objects for ids
on the way out and back (the client sends its refs as their object ids).
"""

from __future__ import annotations

import io
import pickle
import struct
from typing import Any, Callable, List, Optional, Tuple

_HEADER = struct.Struct("<IQ")
_LEN = struct.Struct("<Q")


def dumps_control(obj: Any) -> bytes:
    """Serialize a control-plane message (no user objects)."""
    return pickle.dumps(obj, protocol=5)


def loads_control(data: bytes) -> Any:
    return pickle.loads(data)


class _Pickler(pickle.Pickler):
    def __init__(self, file, buffer_callback, persistent_id):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        self._pid = persistent_id

    def persistent_id(self, obj):
        return self._pid(obj)


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, buffers, persistent_load):
        super().__init__(file, buffers=buffers)
        self._load = persistent_load

    def persistent_load(self, pid):
        return self._load(pid)


def serialize_payload(obj: Any, persistent_id: Optional[Callable] = None
                      ) -> Tuple[bytes, List[memoryview]]:
    """(meta, out-of-band buffers) of a user object; the buffers come back
    apart so a caller can place them without an intermediate copy."""
    buffers: List[pickle.PickleBuffer] = []
    if persistent_id is None:
        meta = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    else:
        out = io.BytesIO()
        _Pickler(out, buffers.append, persistent_id).dump(obj)
        meta = out.getvalue()
    return meta, [b.raw() for b in buffers]


def payload_nbytes(meta: bytes, buffers: List[memoryview]) -> int:
    return _HEADER.size + len(meta) + sum(_LEN.size + b.nbytes
                                          for b in buffers)


def write_payload_into(dest: memoryview, meta: bytes,
                       buffers: List[memoryview]) -> int:
    """Pack meta and buffers into ``dest``; returns the bytes written."""
    off = 0
    _HEADER.pack_into(dest, off, len(buffers), len(meta))
    off += _HEADER.size
    dest[off: off + len(meta)] = meta
    off += len(meta)
    for b in buffers:
        _LEN.pack_into(dest, off, b.nbytes)
        off += _LEN.size
        flat = b.cast("B") if b.format != "B" or b.ndim != 1 else b
        if flat.nbytes >= (1 << 20):
            # numpy's copy loop is faster than memoryview slice assignment
            # for large buffers; numpy stays optional.
            try:
                import numpy as np
            except ImportError:
                dest[off: off + flat.nbytes] = flat
            else:
                np.copyto(np.frombuffer(dest[off: off + flat.nbytes],
                                        dtype=np.uint8),
                          np.frombuffer(flat, dtype=np.uint8))
        else:
            dest[off: off + flat.nbytes] = flat
        off += flat.nbytes
    return off


def pack_payload(obj: Any, persistent_id: Optional[Callable] = None
                 ) -> bytes:
    meta, buffers = serialize_payload(obj, persistent_id)
    out = bytearray(payload_nbytes(meta, buffers))
    write_payload_into(memoryview(out), meta, buffers)
    return bytes(out)


def read_payload_from(src: memoryview,
                      persistent_load: Optional[Callable] = None) -> Any:
    """Deserialize a packed payload; its buffers become views of ``src``."""
    off = 0
    n_buffers, len_meta = _HEADER.unpack_from(src, off)
    off += _HEADER.size
    meta = bytes(src[off: off + len_meta])
    off += len_meta
    bufs = []
    for _ in range(n_buffers):
        (n,) = _LEN.unpack_from(src, off)
        off += _LEN.size
        bufs.append(src[off: off + n])
        off += n
    if persistent_load is None:
        return pickle.loads(meta, buffers=bufs)
    return _Unpickler(io.BytesIO(meta), bufs, persistent_load).load()


def unpack_payload(data: bytes,
                   persistent_load: Optional[Callable] = None) -> Any:
    return read_payload_from(memoryview(data), persistent_load)

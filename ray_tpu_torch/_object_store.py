"""A host's store of sealed objects for the KV handoff between processes
(counterpart of the part of ``ray_tpu/_private/object_store.py`` that the
disaggregated serving path uses: ``SharedMemoryStore`` and the page-blob
``export_page_blob``/``release_page_blob``/``import_page_blob``).

An object is kept in one of two kinds, chosen by what it holds:

- ``"shm"``: host values (numpy arrays, CPU tensors, anything picklable).
  The value is pickled (protocol 5) with its array and tensor buffers out
  of band, each aligned to 64 bytes, into one POSIX shared-memory segment
  per object (``rtt_<id>``).  Any process on the host maps it by name;
  ``import_page_blob`` hands back numpy arrays and tensors that are views
  of the mapping, valid while the keepalive it returns is held.
- ``"cuda_ipc"``: a value holding tensors on the card.  The store keeps
  the value itself (its tensors stay allocated: the pin); sending the
  descriptor to another process pickles the value with each CUDA tensor
  as a CUDA IPC handle (``torch.multiprocessing.reductions.reduce_tensor``)
  and each interprocess CUDA event as its event handle.  A process on the
  same host opens the handles and reads the exporter's memory in place;
  nothing crosses the host.  CUDA cannot open a process's own handles,
  so an import in the exporting process returns the stored value itself.
  A failed open is an error: there is no copy through the host.

Capacity counts the segment bytes of ``"shm"`` objects and the device
bytes of ``"cuda_ipc"`` objects; a ``put`` beyond it raises
``ObjectStoreFullError`` (``export_page_blob`` then returns None and the
caller hands the value off directly, as JAX's does).  The store does not
spill.  An object id is any string (``new_object_id()``).
"""

from __future__ import annotations

import atexit
import inspect
import io
import mmap
import os
import pickle
import struct
import sys
import threading
import uuid
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: Default capacity (bytes) of a store built without one.
DEFAULT_CAPACITY = 4 << 30
_ALIGN = 64
_HEADER = struct.Struct("<QQ")       # number of buffers, metadata length
_LEN = struct.Struct("<Q")
#: Where POSIX shared memory lives on Linux.
SHM_DIR = "/dev/shm"

#: object id -> value: the "cuda_ipc" objects this process exported, so an
#: import in this process gets the value itself (CUDA cannot open a
#: process's own IPC handles).
_local_values: Dict[str, Any] = {}
_local_lock = threading.Lock()


class ObjectStoreFullError(Exception):
    """The store cannot hold the object (JAX: ``ObjectStoreFullError``)."""


def new_object_id() -> str:
    return uuid.uuid4().hex


def _segment_name(object_id: str) -> str:
    return "rtt_" + str(object_id)


class _Segment:
    """One object's shared-memory segment: a file under ``/dev/shm``
    mapped into this process (POSIX shared memory on Linux, without the
    multiprocessing resource tracker, which would unlink a segment when
    any process that attached it exits: the store unlinks its own)."""

    def __init__(self, name: str, create: bool, size: int = 0):
        self.name = name
        path = os.path.join(SHM_DIR, name)
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            size = os.fstat(fd).st_size
            self._mmap = mmap.mmap(fd, size)
        except BaseException:
            if create:
                os.unlink(path)
            raise
        finally:
            os.close(fd)
        self.buf = memoryview(self._mmap)

    def close(self) -> None:
        """Unmap, unless views of the mapping are still alive (zero-copy
        reads hand them out; the mapping then goes with the last one)."""
        try:
            self.buf.release()
            self._mmap.close()
        except BufferError:
            pass

    def unlink(self) -> None:
        try:
            os.unlink(os.path.join(SHM_DIR, self.name))
        except FileNotFoundError:
            pass


# -- host payloads ("shm") ------------------------------------------------------


def _rebuild_host_tensor(buf, dtype: str, shape: tuple):
    """A CPU tensor over ``buf`` (a view of the segment when imported)."""
    import torch
    dt = getattr(torch, dtype)
    if len(buf) == 0:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dt).reshape(shape)


class _HostPickler(pickle.Pickler):
    """Pickles CPU tensors as raw out-of-band bytes (numpy arrays go out
    of band by themselves under protocol 5)."""

    def reducer_override(self, obj):
        # A process that never imported torch holds no tensor (a task
        # worker imports it only when its function does).
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            if obj.device.type != "cpu":
                raise ValueError("a host payload holds a tensor on "
                                 f"{obj.device}")
            t = obj.detach().contiguous()
            raw = t.reshape(-1).view(torch.uint8).numpy()
            return (_rebuild_host_tensor,
                    (pickle.PickleBuffer(raw), str(t.dtype).split(".")[-1],
                     tuple(t.shape)))
        return NotImplemented


def _serialize(value: Any) -> Tuple[bytes, List[memoryview]]:
    buffers: List[pickle.PickleBuffer] = []
    out = io.BytesIO()
    _HostPickler(out, protocol=5, buffer_callback=buffers.append).dump(value)
    return out.getvalue(), [b.raw() for b in buffers]


def _layout(meta: bytes, buffers: List[memoryview]) -> Tuple[int, List[int]]:
    """(total bytes, offset of each buffer): header, metadata, then each
    buffer's length and bytes, every buffer starting on ``_ALIGN``."""
    off = _HEADER.size + len(meta)
    offsets = []
    for b in buffers:
        off += _LEN.size
        off = -(-off // _ALIGN) * _ALIGN
        offsets.append(off)
        off += b.nbytes
    return off, offsets


def _write(dest: memoryview, meta: bytes, buffers: List[memoryview],
           offsets: List[int]) -> None:
    _HEADER.pack_into(dest, 0, len(buffers), len(meta))
    dest[_HEADER.size:_HEADER.size + len(meta)] = meta
    for b, off in zip(buffers, offsets):
        _LEN.pack_into(dest, off - _LEN.size, b.nbytes)
        if b.nbytes:
            np.copyto(np.frombuffer(dest[off:off + b.nbytes], np.uint8),
                      np.frombuffer(b, np.uint8))


def _read_parts(src: memoryview) -> Tuple[bytes, List[memoryview]]:
    """(metadata, views of the buffers) of a layout ``_write`` made."""
    n, len_meta = _HEADER.unpack_from(src, 0)
    meta = bytes(src[_HEADER.size:_HEADER.size + len_meta])
    off = _HEADER.size + len_meta
    bufs = []
    for _ in range(n):
        off += _LEN.size
        off = -(-off // _ALIGN) * _ALIGN
        (nbytes,) = _LEN.unpack_from(src, off - _LEN.size)
        bufs.append(src[off:off + nbytes])
        off += nbytes
    return meta, bufs


def _read(src: memoryview) -> Any:
    meta, bufs = _read_parts(src)
    return pickle.loads(meta, buffers=bufs)


# -- device payloads ("cuda_ipc") ----------------------------------------------


class _IpcPickler(pickle.Pickler):
    """Pickles CUDA tensors as IPC handles and CUDA events as event
    handles (torch's own reductions).  ``shares`` collects each tensor
    share's reference counter (its file and offset)."""

    def __init__(self, file, shares: List[Tuple[str, int]]):
        super().__init__(file, protocol=5)
        self.shares = shares

    def reducer_override(self, obj):
        import torch
        from torch.multiprocessing.reductions import (reduce_event,
                                                      rebuild_cuda_tensor,
                                                      reduce_tensor)
        if isinstance(obj, torch.Tensor) and obj.device.type == "cuda":
            rebuild, args = reduce_tensor(obj.detach())
            named = dict(zip(
                inspect.signature(rebuild_cuda_tensor).parameters, args))
            if named.get("ref_counter_handle") is not None:
                self.shares.append((named["ref_counter_handle"],
                                    named["ref_counter_offset"]))
            return rebuild, args
        if isinstance(obj, torch.cuda.Event):
            return reduce_event(obj)
        return NotImplemented


class IpcBlob:
    """A ``"cuda_ipc"`` descriptor's value part.  It shares the value's
    memory when, and each time, it is pickled (to be sent to another
    process): torch frees the exporter's blocks only once each share has
    been released, which the process that opens it does when it lets go.
    A share nobody opens (the receiver died first) is released by
    :func:`settle_sends`.  An import in the exporting process never
    pickles it."""

    def __init__(self, value: Any):
        self.value = value
        self._lock = threading.Lock()
        #: Reference counters of the shares sent and not yet settled.
        self._unsettled: List[Tuple[str, int]] = []

    def __reduce__(self):
        out = io.BytesIO()
        shares: List[Tuple[str, int]] = []
        try:
            _IpcPickler(out, shares).dump(self.value)
        finally:
            with self._lock:
                self._unsettled += shares
        return (_IpcHandles, (out.getvalue(),))

    def settle(self, delivered: bool) -> None:
        with self._lock:
            shares, self._unsettled = self._unsettled, []
        if delivered or not shares:
            return
        import torch
        for handle, offset in shares:
            torch.UntypedStorage._release_ipc_counter(handle, offset)


class _IpcHandles:
    """A received ``IpcBlob``: the pickle of its value with IPC handles,
    opened by ``import_page_blob``."""

    def __init__(self, data: bytes):
        self.data = data


def _cuda_bytes(value: Any) -> Optional[int]:
    """The bytes of the tensors on the card that ``value`` holds, or None
    when it holds none."""
    import torch

    found = []

    class _Probe(pickle.Pickler):
        def reducer_override(self, obj):
            if isinstance(obj, torch.Tensor):
                if obj.device.type == "cuda":
                    found.append(obj.numel() * obj.element_size())
                return (tuple, ((),))
            if isinstance(obj, torch.cuda.Event):
                return (tuple, ((),))
            return NotImplemented

    # Out-of-band buffers are not copied: the probe only walks the value.
    _Probe(io.BytesIO(), protocol=5,
           buffer_callback=lambda _b: None).dump(value)
    return sum(found) if found else None


# -- the store -----------------------------------------------------------------


@dataclass
class _Entry:
    kind: str
    nbytes: int
    pinned: int = 0
    segment: Optional[_Segment] = None
    value: Any = None          # "cuda_ipc": the pinned value itself


class SharedMemoryStore:
    """Sealed objects of this process, readable by any process on the host
    through their descriptor (JAX: ``SharedMemoryStore``)."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        self._capacity = int(capacity_bytes or DEFAULT_CAPACITY)
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._used = 0
        self._lock = threading.RLock()

    def put(self, object_id: str, value: Any) -> int:
        """Seal ``value`` under ``object_id``; returns its bytes.  Raises
        ``ValueError`` if the id exists, ``ObjectStoreFullError`` past the
        capacity."""
        object_id = str(object_id)
        with self._lock:
            if object_id in self._entries:
                raise ValueError(f"object {object_id} already exists")
        device_bytes = _cuda_bytes(value)
        if device_bytes is not None:
            entry = _Entry("cuda_ipc", device_bytes, value=value)
            self._admit(object_id, entry)
            with _local_lock:
                _local_values[object_id] = value
            return entry.nbytes
        meta, buffers = _serialize(value)
        nbytes, offsets = _layout(meta, buffers)
        entry = _Entry("shm", nbytes)
        self._admit(object_id, entry)
        try:
            seg = _Segment(_segment_name(object_id), create=True,
                           size=max(nbytes, 1))
            _write(seg.buf, meta, buffers, offsets)
        except BaseException:
            with self._lock:
                self._entries.pop(object_id, None)
                self._used -= nbytes
            raise
        entry.segment = seg
        return nbytes

    def _admit(self, object_id: str, entry: _Entry) -> None:
        with self._lock:
            if object_id in self._entries:
                raise ValueError(f"object {object_id} already exists")
            if self._used + entry.nbytes > self._capacity:
                raise ObjectStoreFullError(
                    f"need {entry.nbytes} bytes; {self._used}/"
                    f"{self._capacity} used and nothing evictable")
            self._entries[object_id] = entry
            self._used += entry.nbytes

    def try_pin(self, object_id: str) -> bool:
        """Pin an object (the leak sanitizer's registry counts it until
        ``try_unpin`` or ``delete``)."""
        with self._lock:
            e = self._entries.get(str(object_id))
            if e is None:
                return False
            e.pinned += 1
        from . import _sanitizer
        _sanitizer.note_pin(str(object_id))
        return True

    def try_unpin(self, object_id: str) -> bool:
        with self._lock:
            e = self._entries.get(str(object_id))
            if e is None or e.pinned <= 0:
                return False
            e.pinned -= 1
        from . import _sanitizer
        _sanitizer.note_unpin(str(object_id))
        return True

    def descriptor(self, object_id: str) -> Optional[tuple]:
        """``("shm", segment, nbytes)`` or ``("cuda_ipc", object id,
        IpcBlob, nbytes, exporting pid)``; None for an unknown id."""
        object_id = str(object_id)
        with self._lock:
            e = self._entries.get(object_id)
            if e is None:
                return None
            if e.kind == "shm":
                return ("shm", _segment_name(object_id), e.nbytes)
            return ("cuda_ipc", object_id, IpcBlob(e.value), e.nbytes,
                    os.getpid())

    def delete(self, object_id: str) -> None:
        object_id = str(object_id)
        with self._lock:
            e = self._entries.pop(object_id, None)
            if e is None:
                return
            self._used -= e.nbytes
        if e.pinned:
            from . import _sanitizer
            for _ in range(e.pinned):
                _sanitizer.note_unpin(object_id)
        if e.segment is not None:
            e.segment.close()
            e.segment.unlink()
        if e.kind == "cuda_ipc":
            with _local_lock:
                _local_values.pop(object_id, None)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            pinned = [e for e in self._entries.values() if e.pinned > 0]
            return {"num_objects": len(self._entries),
                    "used_bytes": self._used,
                    "capacity_bytes": self._capacity,
                    "num_pinned": len(pinned),
                    "pinned_bytes": sum(e.nbytes for e in pinned),
                    "num_cuda_ipc": sum(e.kind == "cuda_ipc"
                                        for e in self._entries.values())}

    def shutdown(self) -> None:
        with self._lock:
            ids = list(self._entries)
        for oid in ids:
            self.delete(oid)
        _collect_ipc()


_default: Optional[SharedMemoryStore] = None
_default_lock = threading.Lock()


def default_store() -> SharedMemoryStore:
    """This process's store for handoffs exported without one (emptied
    at exit: its segments are files under ``/dev/shm``)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = SharedMemoryStore()
            atexit.register(_default.shutdown)
        return _default


def _collect_ipc() -> None:
    """Free the exporter's blocks that every importer has let go of
    (``torch.cuda.ipc_collect``), where this process uses the card."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.ipc_collect()


# -- page blobs (the disaggregated KV handoff) ---------------------------------


def export_page_blob(store: SharedMemoryStore, object_id: str,
                     value: Any) -> Optional[tuple]:
    """Seal ``value`` as a pinned object and return its descriptor, or
    None when the store cannot hold it (the caller then hands the value
    off directly; it is never dropped).  Balance with
    :func:`release_page_blob` once the importer is done with it."""
    try:
        store.put(object_id, value)
    except ValueError:
        pass                      # already exported (idempotent republish)
    except ObjectStoreFullError:
        return None
    if not store.try_pin(object_id):
        store.delete(object_id)
        return None
    return store.descriptor(object_id)


def release_page_blob(store: SharedMemoryStore, object_id: str) -> None:
    """Unpin and delete a consumed blob (idempotent); a ``"cuda_ipc"``
    blob's blocks go back to the allocator once no importer holds them."""
    store.try_unpin(object_id)
    store.delete(object_id)
    _collect_ipc()


def settle_sends(desc: tuple, delivered: bool) -> None:
    """Close the books on the sends of a descriptor since the last
    settle (one sender at a time).  ``delivered``: the receiver answered
    the call that carried it, so it opened each share and releases it
    itself.  Not delivered (the call failed: the receiver died, or raised
    and let go of what it opened), the shares are released here, or the
    exporter's blocks would outlive the blob until it exits.  Nothing to
    settle for a ``"shm"`` descriptor."""
    if desc[0] == "cuda_ipc":
        desc[2].settle(delivered)


def import_page_blob(desc: tuple) -> Tuple[Any, Any]:
    """The value of a descriptor and a keepalive: ``"shm"`` values are
    views of the shared mapping while the keepalive is held; ``"cuda_ipc"``
    values hold the exporter's memory themselves (keepalive None)."""
    kind = desc[0]
    if kind == "shm":
        _, name, nbytes = desc
        seg = _Segment(name, create=False)
        try:
            return _read(seg.buf[:nbytes]), seg
        except BaseException:
            seg.close()
            raise
    if kind == "cuda_ipc":
        _, object_id, handles, _nbytes, pid = desc
        if pid == os.getpid():
            with _local_lock:
                value = _local_values.get(object_id)
            if value is None:
                raise KeyError(f"object {object_id} was released")
            return value, None
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a cuda_ipc handoff needs a CUDA card in the importing "
                "process; it is never copied through the host")
        return pickle.loads(handles.data), None
    raise ValueError(f"unknown page-blob descriptor kind {kind!r}")

"""Single-writer single-reader shared-memory channel for compiled graphs (a
copy of ray_tpu/dag/channel.py: it is framework-free; an attach keeps the
resource tracker's entry, see ``ShmChannel.__init__``).

Reference: python/ray/experimental/channel/shared_memory_channel.py (mutable
plasma objects with writer/reader acquire-release semantics, backed by
core_worker/experimental_mutable_object_manager.cc).  Here the channel is a
raw shm segment with a seqlock-style header — the writer publishes a new
version only after the reader acknowledged the previous one, so a channel
holds at most one in-flight message and provides natural backpressure for
pipelined execution.

Layout (64-byte header, payload after):
    [ 0: 8]  write_seq  u64   — bumped by the writer after the payload lands
    [ 8:16]  payload_len u64
    [16:17]  flag        u8   — DATA / STOP / ERR
    [24:32]  read_ack    u64  — bumped by the reader after consuming
"""

from __future__ import annotations

import struct
import time
from multiprocessing import shared_memory
from typing import Optional, Tuple

HEADER_SIZE = 64
_U64 = struct.Struct("<Q")

FLAG_DATA = 0
FLAG_STOP = 1
FLAG_ERR = 2


class ChannelTimeoutError(TimeoutError):
    pass


class ChannelClosedError(RuntimeError):
    pass


def _spin_wait(pred, timeout: Optional[float], what: str):
    deadline = None if timeout is None else time.monotonic() + timeout
    delay = 20e-6
    while not pred():
        if deadline is not None and time.monotonic() >= deadline:
            raise ChannelTimeoutError(f"timed out waiting to {what}")
        time.sleep(delay)
        delay = min(delay * 2, 1e-3)


class ShmChannel:
    """Bounded (capacity-1) message channel over a shm segment.

    Picklable: unpickling in another process attaches to the same segment.
    Exactly one process should call ``unlink`` (the creator / driver).
    """

    def __init__(self, capacity: int = 1 << 20, *, name: Optional[str] = None,
                 _create: bool = True):
        self.capacity = capacity
        if _create:
            self._shm = shared_memory.SharedMemory(
                create=True, size=HEADER_SIZE + capacity)
            self._shm.buf[:HEADER_SIZE] = b"\x00" * HEADER_SIZE
        else:
            # The port's actors are spawned children that share their
            # parent's resource tracker: this attach's registration is the
            # creator's own entry (a set), which the creator's unlink
            # removes.  Unregistering here (as JAX's workers, with trackers
            # of their own, do) would remove it first, and the tracker
            # would report a KeyError at that unlink.
            self._shm = shared_memory.SharedMemory(name=name)
        self.name = self._shm.name
        self._closed = False

    def __reduce__(self):
        return (ShmChannel._attach, (self.name, self.capacity))

    @staticmethod
    def _attach(name: str, capacity: int) -> "ShmChannel":
        return ShmChannel(capacity, name=name, _create=False)

    # -- header accessors ---------------------------------------------------

    def _read_u64(self, off: int) -> int:
        return _U64.unpack_from(self._shm.buf, off)[0]

    def _write_u64(self, off: int, value: int) -> None:
        _U64.pack_into(self._shm.buf, off, value)

    # -- writer side --------------------------------------------------------

    def writable(self) -> bool:
        """True iff the reader has consumed the last message (a write now
        would not block).  Monotonic for the writer: only the writer's own
        write can flip it back to False."""
        return self._read_u64(24) == self._read_u64(0)

    def wait_writable(self, timeout: Optional[float] = None) -> None:
        _spin_wait(self.writable, timeout,
                   "write (reader has not consumed)")

    def write(self, payload: bytes, flag: int = FLAG_DATA,
              timeout: Optional[float] = None) -> None:
        if len(payload) > self.capacity:
            raise ValueError(
                f"serialized message ({len(payload)} B) exceeds channel "
                f"buffer ({self.capacity} B); recompile with a larger "
                "buffer_size_bytes")
        _spin_wait(self.writable, timeout,
                   "write (reader has not consumed)")
        self._shm.buf[HEADER_SIZE:HEADER_SIZE + len(payload)] = payload
        self._write_u64(8, len(payload))
        self._shm.buf[16] = flag
        # Publishing the new seq is the linearization point.
        self._write_u64(0, self._read_u64(0) + 1)

    # -- reader side --------------------------------------------------------

    def read(self, timeout: Optional[float] = None) -> Tuple[int, bytes]:
        _spin_wait(lambda: self._read_u64(0) > self._read_u64(24),
                   timeout, "read")
        flag = self._shm.buf[16]
        n = self._read_u64(8)
        payload = bytes(self._shm.buf[HEADER_SIZE:HEADER_SIZE + n])
        self._write_u64(24, self._read_u64(0))
        return flag, payload

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._shm.close()
            except Exception:
                pass

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

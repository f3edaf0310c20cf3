"""Structured binary identifiers (a copy of ``ray_tpu/_private/ids.py``:
the scheduler tier keys its tables by them).

Mirrors the reference's lineage-embedding ID scheme (reference:
src/ray/common/id.h — BaseID:53, JobID:103, ActorID:124 contains JobID,
TaskID:159 contains ActorID, ObjectID:231 contains TaskID + index,
PlacementGroupID:300).  Embedding parent IDs means ownership and lineage can
be recovered from an ID alone without a directory lookup — e.g. any ObjectID
names the task that produced it, and any TaskID names the actor/job it ran
under.  This is load-bearing for lineage reconstruction and for routing.

Layout (bytes):
    JobID            : 4   random
    NodeID           : 16  random
    WorkerID         : 16  random
    ActorID          : 4(job) + 8 random                      = 12
    TaskID           : 12(actor) + 6 random                   = 18
    ObjectID         : 18(task) + 4 LE index                  = 22
    PlacementGroupID : 4(job) + 10 random                     = 14
"""

from __future__ import annotations

import os
import struct
import threading

_NIL_FILL = b"\xff"


class BaseID:
    SIZE = 0
    __slots__ = ("_bytes", "_hash", "_hex")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}")
        self._bytes = bytes(binary)
        self._hash = None
        self._hex = None

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(_NIL_FILL * cls.SIZE)

    @classmethod
    def from_hex(cls, hexstr: str) -> "BaseID":
        return cls(bytes.fromhex(hexstr))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        h = self._hex
        if h is None:
            h = self._hex = self._bytes.hex()
        return h

    def is_nil(self) -> bool:
        return self._bytes == _NIL_FILL * self.SIZE

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self) -> int:
        # Cached: IDs key every hot dict (object directory, running tasks)
        # and re-hashing 20+ bytes per lookup showed up in dispatch profiles.
        h = self._hash
        if h is None:
            h = self._hash = hash((type(self).__name__, self._bytes))
        return h

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4
    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack("<I", value))

    @classmethod
    def next(cls) -> "JobID":
        with cls._lock:
            cls._counter += 1
            return cls.from_int(cls._counter)


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = JobID.SIZE + 8

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(8))

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])


class _RandPool:
    """Buffered os.urandom: one syscall per ~680 ids instead of one per id
    (TaskID.of is on the per-call submit path)."""

    __slots__ = ("_buf", "_pos", "_lock")

    def __init__(self):
        self._buf = b""
        self._pos = 1 << 30
        self._lock = threading.Lock()

    def take(self, n: int) -> bytes:
        with self._lock:
            pos = self._pos
            if pos + n > len(self._buf):
                self._buf = os.urandom(4096)
                pos = 0
            self._pos = pos + n
            return self._buf[pos:pos + n]


_rand_pool = _RandPool()


class TaskID(BaseID):
    SIZE = ActorID.SIZE + 6

    @classmethod
    def of(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + _rand_pool.take(6))

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        """The synthetic root task a driver's objects are owned by."""
        return cls(job_id.binary() + b"\x00" * 8 + b"\x00" * 6)

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[: ActorID.SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])


class ObjectID(BaseID):
    SIZE = TaskID.SIZE + 4

    @classmethod
    def of(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack("<I", index))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])

    def index(self) -> int:
        return struct.unpack("<I", self._bytes[TaskID.SIZE:])[0]


class PlacementGroupID(BaseID):
    SIZE = JobID.SIZE + 10

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(job_id.binary() + os.urandom(10))

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])

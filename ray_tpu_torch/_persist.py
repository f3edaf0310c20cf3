"""The head's state on disk: a write-ahead log (WAL) and a snapshot of the
controller's tables (a copy of ``ray_tpu/_private/persist.py``).

The controller is the one writer, so a log of pickled mutation records,
replayed in order, rebuilds its tables exactly.  What persists: actors
(with their creation specs, which name the class by module and qualname
and hold the pickled constructor arguments), named-actor bindings,
placement groups (bundle shapes; where each bundle sits is re-planned
after a restart), jobs and the KV store.  What does not: node
registrations and the object store (objects live in the dead session's
shared memory, which the restarted head removes).

Durability: each append is flushed, not fsynced: a head process killed
with SIGKILL (the failure this protects against) loses nothing that sits
in the OS page cache.  ``head_wal_fsync`` adds an fsync per append, for a
machine that crashes.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
from typing import Any, Iterator, List, Optional

_LEN = struct.Struct("<I")

SNAPSHOT = "snapshot.bin"
WAL = "wal.bin"


class StateStore:
    """Append-only record log with snapshot compaction.

    Records are arbitrary picklable tuples; ``load()`` returns snapshot
    records then WAL records, in append order.  A torn tail (partial final
    record from a mid-write kill) is truncated silently.
    """

    def __init__(self, state_dir: str, fsync: bool = False,
                 compact_every: int = 50_000):
        self.dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        self._fsync = fsync
        self._lock = threading.Lock()
        self._wal_path = os.path.join(state_dir, WAL)
        self._snap_path = os.path.join(state_dir, SNAPSHOT)
        self._wal_count = 0
        self._compact_every = compact_every
        self._wal_f = None  # opened lazily after any replay/compaction

    # -- read side ----------------------------------------------------------

    @staticmethod
    def _read_records(path: str) -> List[Any]:
        out: List[Any] = []
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return out
        off = 0
        n = len(data)
        while off + _LEN.size <= n:
            (rec_len,) = _LEN.unpack_from(data, off)
            if off + _LEN.size + rec_len > n:
                break  # torn tail from a mid-write kill
            try:
                out.append(pickle.loads(
                    data[off + _LEN.size: off + _LEN.size + rec_len]))
            except Exception:
                break  # corrupt tail: stop at the last good record
            off += _LEN.size + rec_len
        return out

    def load(self) -> List[Any]:
        """All records in order (snapshot first, then WAL)."""
        return (self._read_records(self._snap_path)
                + self._read_records(self._wal_path))

    # -- write side ---------------------------------------------------------

    def _ensure_open(self):
        if self._wal_f is None:
            self._wal_f = open(self._wal_path, "ab")
        return self._wal_f

    def append(self, record: Any) -> None:
        blob = pickle.dumps(record, protocol=5)
        with self._lock:
            f = self._ensure_open()
            f.write(_LEN.pack(len(blob)))
            f.write(blob)
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
            self._wal_count += 1
            wal_count = self._wal_count
        # Compaction trigger reads the snapshot taken under the lock
        # (RT401): a concurrent append must not tear the threshold read.
        if wal_count >= self._compact_every and \
                self.on_compact is not None:
            try:
                self.on_compact()
            except Exception:
                pass

    # Set by the owner to a zero-arg callable that calls compact() with the
    # current full state (the store can't snapshot tables it doesn't own).
    on_compact: Optional[Any] = None

    def compact(self, records: List[Any]) -> None:
        """Replace snapshot+WAL with one snapshot of ``records``."""
        with self._lock:
            tmp = self._snap_path + ".tmp"
            with open(tmp, "wb") as f:
                for r in records:
                    blob = pickle.dumps(r, protocol=5)
                    f.write(_LEN.pack(len(blob)))
                    f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._snap_path)
            if self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None
            try:
                os.unlink(self._wal_path)
            except FileNotFoundError:
                pass
            self._wal_count = 0

    def close(self) -> None:
        with self._lock:
            if self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None

"""The train runtime's control plane: a key-value store shared by the
controller and its worker processes (counterpart of the calls the JAX
package's train code makes through ``ray_tpu/_private/api._control``:
``kv_put``, ``kv_get``, ``kv_keys``, ``kv_del`` and ``export_event``).

The controller hosts a ``torch.distributed.TCPStore`` server
(``ControlPlane.serve()``, port 0: the OS picks a free one); each worker
connects to it as a client (``ControlPlane.connect(host, port)``).  The
same store carries the workers' process group: an incarnation forms it on
``PrefixStore(f"train/{run_id}/pg/{generation}", store)``, so no ``file://``
rendezvous and no second port are needed.

``TCPStore`` has no prefix listing that every torch version offers, and its
``get`` blocks until a key exists.  So:

- ``kv_get`` reads with ``compare_set(key, MISSING, MISSING)``, which never
  blocks and changes nothing: it returns the value, or ``MISSING`` where the
  key does not exist (then ``None``, as JAX's does);
- every ``kv_put`` appends its key to the index of its *bucket* (the first
  three components of the key's directory, e.g. ``train/<run>/report/``),
  and ``kv_keys(prefix)`` reads the buckets the prefix can reach, drops keys
  that ``check`` finds deleted, and compacts the index with ``compare_set``
  (which fails, and leaves it for the next reader, if a put raced in).

A client is safe to share between threads (one lock around the socket).
``_control(verb, *args)`` calls ``verb`` on this process's current plane, as
JAX's call sites do.
"""

from __future__ import annotations

import datetime
import json
import threading
import time
from typing import Any, Dict, List, Optional

#: ``kv_get``'s "no such key" answer from ``compare_set``.
MISSING = b"\x00ray_tpu_torch.missing\x00"
_INDEX = "__index__/"
_BUCKETS = "__buckets__"
_BUCKET_SEEN = "__bucket_seen__/"
_EVENTS = "__events__"
_VERBS = frozenset(("kv_put", "kv_get", "kv_keys", "kv_del",
                    "export_event"))


def bucket_of(key: str) -> str:
    """The index bucket of ``key``: its first three directory components
    ("train/r1/report/0/a/3" -> "train/r1/report/")."""
    parts = key.split("/")[:-1][:3]
    return "/".join(parts) + "/" if parts else ""


class ControlPlane:
    """One process's handle on the store (the server's own process holds
    the master)."""

    def __init__(self, store, host: str, port: int):
        self.store = store
        self.host = host
        self.port = port
        self._lock = threading.Lock()
        self._buckets: set = set()

    @classmethod
    def serve(cls, host: str = "127.0.0.1",
              timeout_s: float = 300.0) -> "ControlPlane":
        """Start the store's server in this process on a free port."""
        from torch.distributed import TCPStore
        store = TCPStore(host, 0, None, True,
                         timeout=datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)
        return cls(store, host, store.port)

    @classmethod
    def connect(cls, host: str, port: int,
                timeout_s: float = 300.0) -> "ControlPlane":
        """A client of the server at ``host:port``."""
        from torch.distributed import TCPStore
        store = TCPStore(host, port, None, False,
                         timeout=datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)
        return cls(store, host, port)

    # -- the verbs ----------------------------------------------------------

    def kv_put(self, key: str, value: bytes) -> None:
        bucket = bucket_of(key)
        with self._lock:
            self.store.set(key, value)
            if bucket not in self._buckets:
                if self.store.add(_BUCKET_SEEN + bucket, 1) == 1:
                    self.store.append(_BUCKETS, (bucket + "\n").encode())
                self._buckets.add(bucket)
            self.store.append(_INDEX + bucket, (key + "\n").encode())

    def kv_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._get(key)

    def _get(self, key: str) -> Optional[bytes]:
        value = self.store.compare_set(key, MISSING, MISSING)
        return None if value == MISSING else bytes(value)

    def kv_del(self, key: str) -> bool:
        with self._lock:
            return bool(self.store.delete_key(key))

    def kv_keys(self, prefix: str) -> List[str]:
        """Live keys under ``prefix``, in the order they were first put."""
        comps = prefix.split("/")[:-1]
        with self._lock:
            if len(comps) >= 3:
                buckets = ["/".join(comps[:3]) + "/"]
            else:
                raw = self._get(_BUCKETS) or b""
                buckets = [b for b in raw.decode().split("\n")[:-1]
                           if b.startswith(prefix) or prefix.startswith(b)]
            out: List[str] = []
            for bucket in buckets:
                out.extend(k for k in self._live(bucket)
                           if k.startswith(prefix))
        return out

    def _live(self, bucket: str) -> List[str]:
        raw = self._get(_INDEX + bucket)
        if raw is None:
            return []
        lines = raw.decode().split("\n")[:-1]
        live = [k for k in dict.fromkeys(lines) if self.store.check([k])]
        if len(live) < len(lines):
            # Fails harmlessly when a put appended since the read.
            self.store.compare_set(
                _INDEX + bucket, raw,
                "".join(k + "\n" for k in live).encode())
        return live

    def wait(self, key: str, timeout_s: float) -> bytes:
        """Block until ``key`` exists (at most ``timeout_s``, then raise),
        and return its value."""
        self.store.wait([key], datetime.timedelta(seconds=timeout_s))
        return self.kv_get(key)

    def export_event(self, kind: str, payload: Dict[str, Any]) -> None:
        """Append one structured event record (JAX appends the same record
        to the session's ``events.jsonl``)."""
        rec = dict(payload, type=kind, time=time.time())
        with self._lock:
            self.store.append(_EVENTS, (json.dumps(rec, default=str)
                                        + "\n").encode())

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            raw = self._get(_EVENTS) or b""
        return [json.loads(line) for line in raw.decode().split("\n")
                if line]


_current: Optional[ControlPlane] = None


def set_current(plane: Optional[ControlPlane]) -> None:
    global _current
    _current = plane


def current() -> ControlPlane:
    if _current is None:
        raise RuntimeError("no control plane in this process (the train "
                           "controller and its workers set one)")
    return _current


def _control(verb: str, *args: Any) -> Any:
    """``verb(*args)`` on this process's control plane (JAX's call
    shape)."""
    if verb not in _VERBS:
        raise ValueError(f"unknown control verb {verb!r}")
    return getattr(current(), verb)(*args)

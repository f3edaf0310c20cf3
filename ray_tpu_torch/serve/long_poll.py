"""Versioned config push: the long-poll host/client pattern (a copy of
ray_tpu/serve/long_poll.py).

Reference: python/ray/serve/_private/long_poll.py (LongPollHost:318 —
routers block on a snapshot version and wake when the controller publishes
a change; config flows push-style, never per-request polling).  Here the
broker is in-process; routers and the HTTP ingress read cached snapshots
and block in ``wait_for_change`` only when they want push semantics.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple


class LongPollBroker:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._versions: Dict[str, int] = {}
        self._snapshots: Dict[str, Any] = {}

    def publish(self, key: str, snapshot: Any) -> int:
        with self._cond:
            v = self._versions.get(key, 0) + 1
            self._versions[key] = v
            self._snapshots[key] = snapshot
            self._cond.notify_all()
            return v

    def get(self, key: str) -> Tuple[int, Any]:
        with self._lock:
            return self._versions.get(key, 0), self._snapshots.get(key)

    def wait_for_change(self, key: str, seen_version: int,
                        timeout: Optional[float] = None
                        ) -> Tuple[int, Any]:
        """Block until the key's version exceeds ``seen_version``; returns
        (version, snapshot) — possibly the unchanged pair on timeout."""
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._versions.get(key, 0) <= seen_version:
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                self._cond.wait(remaining)
            return self._versions.get(key, 0), self._snapshots.get(key)

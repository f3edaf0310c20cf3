"""Distributed FIFO queue backed by an actor (a copy of ray_tpu/util/queue.py
over the port's process actors).

Reference: python/ray/util/queue.py (Queue over a _QueueActor wrapping
asyncio.Queue; Empty/Full mirror the stdlib queue exceptions).
"""

from __future__ import annotations

import queue as _stdqueue
import time
from typing import Any, List, Optional

from .. import _actor as ray_tpu


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q = _stdqueue.Queue(maxsize=maxsize)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()

    def put(self, item: Any, timeout: float) -> bool:
        """Bounded blocking put; timeout=0 means non-blocking."""
        try:
            if timeout and timeout > 0:
                self._q.put(item, block=True, timeout=timeout)
            else:
                self._q.put_nowait(item)
            return True
        except _stdqueue.Full:
            return False

    def put_nowait(self, item: Any) -> bool:
        return self.put(item, 0)

    def put_nowait_batch(self, items: List[Any]) -> bool:
        """All-or-nothing: either every item is enqueued or none are."""
        if self._q.maxsize > 0 and \
                self._q.qsize() + len(items) > self._q.maxsize:
            return False
        for item in items:
            self._q.put_nowait(item)
        return True

    def get(self, timeout: float) -> Any:
        """Bounded blocking get; timeout=0 means non-blocking."""
        try:
            if timeout and timeout > 0:
                item = self._q.get(block=True, timeout=timeout)
            else:
                item = self._q.get_nowait()
            return (True, item)
        except _stdqueue.Empty:
            return (False, None)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        out = []
        for _ in range(num_items):
            try:
                out.append(self._q.get_nowait())
            except _stdqueue.Empty:
                break
        return out


class Queue:
    """FIFO queue usable from the driver, its task workers and its actors.

    The queue lives in a dedicated actor; handles are picklable, so a Queue
    can be passed as a task/actor argument (reference: util/queue.py:14).
    """

    def __init__(self, maxsize: int = 0, *,
                 actor_options: Optional[dict] = None):
        actor_options = actor_options or {}
        self.maxsize = maxsize
        self.actor = ray_tpu.remote(_QueueActor).options(
            **actor_options).remote(maxsize)

    def __getstate__(self):
        return {"maxsize": self.maxsize, "actor": self.actor}

    def __setstate__(self, state):
        self.maxsize = state["maxsize"]
        self.actor = state["actor"]

    def qsize(self) -> int:
        return ray_tpu.get(self.actor.qsize.remote())

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        return ray_tpu.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu.get(self.actor.full.remote())

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # Bounded server-side block (like get) instead of a client-side
            # busy poll: ~5 round-trips/s per blocked producer, not ~100.
            if ray_tpu.get(self.actor.put.remote(item, 0.2)):
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full(f"batch of {len(items)} items does not fit")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu.get(self.actor.get.remote(0))
            if not ok:
                raise Empty
            return item
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # Bounded server-side block keeps the actor responsive to other
            # callers while approximating a blocking get.
            ok, item = ray_tpu.get(self.actor.get.remote(0.2))
            if ok:
                return item
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return ray_tpu.get(self.actor.get_nowait_batch.remote(num_items))

    def shutdown(self, force: bool = False) -> None:
        ray_tpu.kill(self.actor)

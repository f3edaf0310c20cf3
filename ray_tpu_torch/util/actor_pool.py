"""Fixed pool of actors with a map/submit interface (a copy of
ray_tpu/util/actor_pool.py over the port's process actors).

Reference: python/ray/util/actor_pool.py (ActorPool — submit, get_next,
get_next_unordered, map, map_unordered, push/pop idle).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List

from .. import _actor as ray_tpu


class ActorPool:
    """Round-robins work items over a fixed set of actor handles.

    Example::

        pool = ActorPool([Worker.remote() for _ in range(4)])
        results = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    """

    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool requires at least one actor")
        # in-flight: ObjectRef -> (actor, submission index)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    # -- low-level interface -------------------------------------------------

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """Schedule fn(actor, value) on an idle actor; blocks if none idle."""
        if not self._idle:
            # Wait for any in-flight task to finish, then reuse its actor.
            self._wait_for_one()
        actor = self._idle.pop()
        future = fn(actor, value)
        self._future_to_actor[future] = (actor, self._next_task_index)
        self._index_to_future[self._next_task_index] = future
        self._next_task_index += 1

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in submission order.

        Waits for readiness BEFORE mutating any bookkeeping so a timeout
        leaves the result fetchable on retry; errored tasks count as ready,
        so they still return their actor to the pool and advance the cursor.
        """
        if not self.has_next():
            raise StopIteration("no pending results")
        future = self._index_to_future[self._next_return_index]
        ready, _ = ray_tpu.wait([future], num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError(
                f"timed out waiting for result {self._next_return_index}")
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._return_actor(future)
        return ray_tpu.get(future)

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = ray_tpu.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("timed out waiting for result")
        future = ready[0]
        _, idx = self._future_to_actor[future]
        del self._index_to_future[idx]
        self._return_actor(future)
        return ray_tpu.get(future)

    def _wait_for_one(self) -> None:
        # Only wait on futures whose actor hasn't been handed back yet.
        holding = [f for f, (a, _) in self._future_to_actor.items()
                   if a is not None]
        if not holding:
            raise RuntimeError(
                "ActorPool has no idle actors and no in-flight work holding "
                "one (all actors removed via pop_idle?)")
        ready, _ = ray_tpu.wait(holding, num_returns=1)
        # Return the actor but keep the result fetchable.
        actor, idx = self._future_to_actor[ready[0]]
        self._idle.append(actor)
        self._future_to_actor[ready[0]] = (None, idx)

    def _return_actor(self, future) -> None:
        actor, _ = self._future_to_actor.pop(future)
        if actor is not None:
            self._idle.append(actor)

    # -- high-level interface ------------------------------------------------

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def push(self, actor: Any) -> None:
        """Add an idle actor to the pool."""
        self._idle.append(actor)

    def pop_idle(self) -> Any:
        """Remove and return an idle actor, or None if none idle."""
        if self._idle:
            return self._idle.pop()
        return None

    def has_free(self) -> bool:
        return bool(self._idle)

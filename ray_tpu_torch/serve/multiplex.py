"""Model multiplexing: many models per deployment, LRU-cached per replica
(a copy of ray_tpu/serve/multiplex.py).

Reference analog: python/ray/serve/multiplex.py (`@serve.multiplexed`
decorating a model-loader method; `serve.get_multiplexed_model_id()` inside
the request path; the router prefers replicas that already hold the model).

Replica side: the decorated loader becomes an LRU cache keyed by model id —
at most ``max_num_models_per_replica`` resident, least-recently-used evicted
(with an optional ``__del__``-style unload hook on the model).  Router side:
the deployment router keeps a model→replica affinity map (it is the sole
entry point, so optimistic tracking stays accurate) and routes a request
for model M to a replica that served M before, falling back to
power-of-two-choices — which is how cache locality survives scaling events.
"""

from __future__ import annotations

import contextvars
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

_current_model_id: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("serve_multiplexed_model_id", default=None)


def get_multiplexed_model_id() -> Optional[str]:
    """The model id of the in-flight request (reference:
    serve.get_multiplexed_model_id) — None outside a multiplexed request."""
    return _current_model_id.get()


def _set_current_model_id(model_id: Optional[str]):
    return _current_model_id.set(model_id)


class _MultiplexWrapper:
    """Bound-method wrapper holding the per-replica LRU of loaded models."""

    def __init__(self, fn: Callable, instance: Any, max_models: int):
        self._fn = fn
        self._instance = instance
        self._max = max_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        # One lock per model id so concurrent misses for the same model do
        # a single load (loads can take minutes on TPU) instead of racing
        # and leaking the losing duplicate.
        self._load_locks: dict = {}

    @property
    def loaded_model_ids(self):
        with self._lock:
            return list(self._models)

    @staticmethod
    def _unload(model: Any) -> None:
        unload = getattr(model, "unload", None)
        if callable(unload):
            try:
                unload()
            except Exception:  # noqa: BLE001
                pass

    def __call__(self, model_id: Optional[str] = None) -> Any:
        if model_id is None:
            model_id = get_multiplexed_model_id()
        if model_id is None:
            raise ValueError(
                "no model id: pass one explicitly or route the request "
                "with handle.options(multiplexed_model_id=...)")
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
            load_lock = self._load_locks.setdefault(model_id,
                                                   threading.Lock())
        with load_lock:
            # A concurrent loader may have finished while we waited.
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
            # Load outside self._lock: cache hits for other models proceed.
            model = self._fn(self._instance, model_id)
            evicted = None
            with self._lock:
                self._models[model_id] = model
                self._models.move_to_end(model_id)
                if len(self._models) > self._max:
                    _, evicted = self._models.popitem(last=False)
                # Load locks are kept (bounded by distinct model ids): a
                # fresh lock per miss would let an evict/reload race load
                # the same model twice and leak the overwritten copy.
        if evicted is not None:
            self._unload(evicted)
        return model


class _MultiplexedDescriptor:
    """Descriptor so `self.get_model` resolves to a per-instance wrapper."""

    def __init__(self, fn: Callable, max_models: int):
        self._fn = fn
        self._max = max_models
        self._attr = f"__multiplex_{fn.__name__}"

    def __get__(self, instance, owner=None):
        if instance is None:
            return self
        wrapper = getattr(instance, self._attr, None)
        if wrapper is None:
            wrapper = _MultiplexWrapper(self._fn, instance, self._max)
            setattr(instance, self._attr, wrapper)
        return wrapper


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator for a deployment's model-loader method (reference:
    serve/multiplex.py @serve.multiplexed).

        @serve.deployment
        class Model:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                return load_model(model_id)

            def __call__(self, x):
                model = self.get_model()   # current request's model
                return model(x)
    """
    if max_num_models_per_replica < 1:
        raise ValueError("max_num_models_per_replica must be >= 1")

    def deco(fn: Callable) -> _MultiplexedDescriptor:
        return _MultiplexedDescriptor(fn, max_num_models_per_replica)
    return deco


class RouterAffinity:
    """Router-side model→replica affinity with per-replica LRU mirroring
    the replica cache size (reference: the controller's model-id long-poll
    feed into the router; here the router is the single entry point so it
    tracks assignments directly)."""

    def __init__(self, max_models_per_replica: int = 8):
        self._max = max_models_per_replica
        # replica key -> LRU of model ids
        self._by_replica: "OrderedDict[int, OrderedDict[str, None]]" = \
            OrderedDict()
        self._lock = threading.Lock()

    def replicas_for(self, model_id: str):
        with self._lock:
            return [rk for rk, models in self._by_replica.items()
                    if model_id in models]

    def note(self, replica_key: int, model_id: str) -> None:
        with self._lock:
            models = self._by_replica.setdefault(replica_key, OrderedDict())
            if model_id in models:
                models.move_to_end(model_id)
            else:
                models[model_id] = None
                if len(models) > self._max:
                    models.popitem(last=False)

    def drop_replica(self, replica_key: int) -> None:
        with self._lock:
            self._by_replica.pop(replica_key, None)

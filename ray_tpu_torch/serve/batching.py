"""Dynamic request batching (a copy of ray_tpu/serve/batching.py;
reference: python/ray/serve/batching.py @serve.batch — accumulate calls
until max_batch_size or timeout, run the wrapped method once on the list,
scatter results).  It runs inside a replica process, whose
``max_ongoing_requests`` threads take the calls that a batch gathers."""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, List


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self._lock = threading.Lock()
        self._items: List[Any] = []
        self._events: List[threading.Event] = []
        self._enqueued: List[float] = []  # perf_counter at submit
        self._results: List[Any] = []
        self._flush_timer: threading.Timer = None  # type: ignore

    def submit(self, instance, item):
        ev = threading.Event()
        with self._lock:
            self._items.append(item)
            self._events.append(ev)
            self._enqueued.append(time.perf_counter())
            idx = len(self._items) - 1
            if len(self._items) >= self.max_batch_size:
                batch, events, enq = self._take()
                self._run(instance, batch, events, enq)
            elif self._flush_timer is None:
                t = threading.Timer(
                    self.timeout, self._flush_due, args=(instance,))
                t.daemon = True
                self._flush_timer = t
                t.start()
        ev.wait()
        return ev.result  # type: ignore[attr-defined]

    def _take(self):
        batch, self._items = self._items, []
        events, self._events = self._events, []
        enq, self._enqueued = self._enqueued, []
        if self._flush_timer is not None:
            self._flush_timer.cancel()
            self._flush_timer = None
        return batch, events, enq

    def _flush_due(self, instance):
        with self._lock:
            if not self._items:
                self._flush_timer = None
                return
            batch, events, enq = self._take()
        self._run_outside(instance, batch, events, enq)

    def _run(self, instance, batch, events, enq):
        # Called with lock held for the size-trigger path; do the work
        # outside the lock.
        from .. import _sanitizer
        _sanitizer.spawn(self._run_outside,
                         args=(instance, batch, events, enq),
                         name="serve-batch")

    def _note_batch(self, batch, enq) -> None:
        from ..util import telemetry
        tags = {"method": getattr(self.fn, "__name__", "batch")}
        now = time.perf_counter()
        for t in enq:
            telemetry.observe("ray_tpu_serve_queue_wait_seconds",
                              max(0.0, now - t), tags=tags)
        telemetry.observe("ray_tpu_serve_batch_size", len(batch),
                          tags=tags)

    def _run_outside(self, instance, batch, events, enq):
        self._note_batch(batch, enq)
        try:
            outs = (self.fn(instance, batch) if instance is not None
                    else self.fn(batch))
            if len(outs) != len(batch):
                raise ValueError(
                    f"batched fn returned {len(outs)} results for "
                    f"{len(batch)} inputs")
        except Exception as e:  # noqa: BLE001
            outs = [e] * len(batch)
        for ev, out in zip(events, outs):
            ev.result = out  # type: ignore[attr-defined]
            ev.set()


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: methods receive List[item] instead of item.

    The batcher (which holds locks/timers) is created lazily per replica
    process so decorated classes stay picklable.
    """
    def wrap(fn):
        attr = f"_ray_tpu_batcher_{fn.__name__}"

        @functools.wraps(fn)
        def method(self, item):
            batcher = getattr(self, attr, None)
            if batcher is None:
                batcher = _Batcher(fn, max_batch_size, batch_wait_timeout_s)
                try:
                    setattr(self, attr, batcher)
                except AttributeError:
                    pass
            out = batcher.submit(self, item)
            if isinstance(out, Exception):
                raise out
            return out
        return method
    if _fn is not None:
        return wrap(_fn)
    return wrap

"""Decode replica: one continuous-batching engine + prefix cache + driver
(counterpart of ray_tpu/llm/fleet/replica.py).

One fleet member.  Each replica owns its own
:class:`~ray_tpu_torch.llm.engine.InferenceEngine` (its own paged KV pool
and decode batch, on its own CUDA stream), a byte-bounded
:class:`~ray_tpu_torch.llm.fleet.prefix.PrefixCache` of recently imported
full-prompt handoffs, and a drive thread that steps the engine and reports
finishes through a callback: the fleet server never steps engines itself,
so N replicas decode concurrently and a wedged replica stalls only its own
stream.  Replicas built from one set of weights on the card share it.

Lifecycle is three states the router reads on every retry iteration:

``active``    accepting new imports
``draining``  finish in-flight work, admit nothing (scale-down)
``dead``      drive thread stopped; the fleet sheds whatever was mapped
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..._device import on_stream, resolve_device
from ..engine import InferenceEngine, SamplingParams
from .prefix import PrefixCache

STATE_ACTIVE = "active"
STATE_DRAINING = "draining"
STATE_DEAD = "dead"


class DecodeReplica:
    """One decode engine behind the fleet router."""

    def __init__(self, build_params, *, name: str,
                 engine_options: Optional[Dict[str, Any]] = None,
                 cache_capacity_bytes: int = 64 * 1024 * 1024,
                 record_token_times: bool = False,
                 on_finish: Optional[Callable[["DecodeReplica", Any],
                                              None]] = None,
                 poll_interval_s: float = 0.002):
        params, cfg = build_params() if callable(build_params) \
            else build_params
        eo = dict(engine_options or {})
        # Replicas are decode-only: prefill happens on the prefill tier and
        # arrives as a handoff, never through the chunked path.
        eo.pop("prefill_chunk", None)
        device = resolve_device(eo.get("device"))
        if device.type == "cuda" and eo.get("stream") is None:
            eo["stream"] = torch.cuda.Stream(device)
        self.name = name
        self.engine = InferenceEngine(
            params, cfg, record_token_times=record_token_times, **eo)
        self.cache = PrefixCache(
            capacity_bytes=cache_capacity_bytes,
            block=eo.get("page_size", 16))
        self.state = STATE_ACTIVE
        self._on_finish = on_finish
        self._stop = threading.Event()
        self._work = threading.Event()
        self._poll = poll_interval_s
        self._driver = threading.Thread(
            target=self._drive_loop, name=f"fleet-decode-{name}",
            daemon=True)
        self._driver.start()

    # -- intake -------------------------------------------------------------

    @property
    def accepting(self) -> bool:
        return self.state == STATE_ACTIVE

    def import_prefill(self, handoff, retain: bool = True
                       ) -> Optional[int]:
        """Join a prefilled request to this replica's batch.  None means
        backpressure OR not accepting: the dispatcher checks ``state``
        between retries and re-routes instead of spinning on a draining
        replica.  ``retain=True`` keeps this replica's own copy of the
        handoff in the prefix cache (greedy handoffs only: a cached first
        token is replayable only when it was the argmax)."""
        if not self.accepting:
            return None
        rid = self.engine.import_prefill(handoff)
        if rid is not None:
            if retain and handoff.params.temperature <= 0.0:
                self.cache.insert(self._own_copy(handoff))
            self._work.set()
        return rid

    def try_serve_cached(self, prompt_tokens: Sequence[int],
                         params: SamplingParams,
                         t_submit: float = 0.0) -> Optional[int]:
        """Full prefix hit: replay the cached handoff straight into the
        decode batch, skipping the prefill tier.  Greedy requests only (the
        cached first token is the argmax; any temperature would need a
        fresh sample from logits the cache doesn't keep).  Returns the
        engine rid, or None (miss / non-greedy / engine backpressure: the
        caller falls back to the cold path)."""
        if not self.accepting or params.temperature > 0.0:
            return None
        cached = self.cache.lookup(prompt_tokens)
        if cached is None:
            return None
        now = time.perf_counter()
        # The request's own sampling envelope rides the replay:
        # import_prefill reads max_tokens/stop ids from handoff.params.
        replay = dataclasses.replace(
            cached, params=params, t_submit=t_submit or now, t_first=now)
        rid = self.engine.import_prefill(replay)
        if rid is not None:
            self._work.set()
        return rid

    def cancel(self, rid: int) -> None:
        self.engine.cancel(rid)

    def _own_copy(self, handoff):
        """This replica's own copy of a handoff for cache retention, on
        its device (``clone()`` on the engine's stream, which already
        waited for the handoff's prefill): the handoff's tensors belong to
        the request and go when it does; the cache's bytes are the copy's
        (``PrefixCache.capacity_bytes`` counts them)."""
        def own(x):
            if isinstance(x, torch.Tensor):
                return x.to(self.engine.device).clone()
            return np.ascontiguousarray(x)
        with on_stream(self.engine.stream):
            return dataclasses.replace(
                handoff, prompt_tokens=list(handoff.prompt_tokens),
                ks=own(handoff.ks), vs=own(handoff.vs), ready=None)

    # -- drive --------------------------------------------------------------

    def _drive_loop(self) -> None:
        while not self._stop.is_set():
            if not self.engine.has_work():
                self._work.wait(0.02)
                self._work.clear()
                continue
            for req in self.engine.step():
                if self._on_finish is not None:
                    self._on_finish(self, req)

    # -- introspection ------------------------------------------------------

    def load_stats(self) -> Dict[str, Any]:
        """Router-facing load: engine occupancy/queues + cache stats."""
        stats = self.engine.load_stats()
        stats["name"] = self.name
        stats["state"] = self.state
        stats["ongoing"] = len(self.engine.running)
        stats["cache"] = self.cache.stats()
        return stats

    def summary(self) -> Dict[str, Any]:
        """Prefix-index digest for affinity scoring."""
        return self.cache.summary()

    def idle(self) -> bool:
        return not self.engine.has_work() and not self.engine.running

    # -- lifecycle ----------------------------------------------------------

    def drain(self) -> None:
        """Stop admitting; in-flight work runs to completion.  The fleet
        manager polls :meth:`idle` and then :meth:`kill`s."""
        if self.state == STATE_ACTIVE:
            self.state = STATE_DRAINING

    def kill(self, timeout_s: float = 5.0) -> List[int]:
        """Hard stop (chaos / scale-down tail): stop the drive thread and
        return the engine rids that were still in flight; the fleet sheds
        exactly those, retriably."""
        self.state = STATE_DEAD
        self._stop.set()
        self._work.set()
        self._driver.join(timeout_s)
        with self.engine._lock:
            lost = list(self.engine.running)
        return lost

    close = kill


class RemoteReplica:
    """A decode replica on another host (the JAX package's
    ``fleet/remote.py``): it needs the serve runtime over processes."""

    def __init__(self, *_args, **_kwargs):
        raise NotImplementedError(
            "RemoteReplica (a decode replica in another process or on "
            "another host) comes with ROADMAP Queue 1 item 6 (the serve "
            "deployment over processes); use the local DecodeReplica, one "
            "stream each on the card")


class ReplicaHost(RemoteReplica):
    """The actor body of a :class:`RemoteReplica`; see there."""

"""LLM serving: one engine behind a callable that many threads share
(counterpart of ray_tpu/llm/serving.py).

``LLMServer`` is the JAX package's; its drive thread starts through the
leak sanitizer's ``spawn``, as JAX's does.  ``build_llm_deployment`` wraps it in a serve deployment
(``ray_tpu_torch.serve``): each replica is a process hosting one
``LLMServer`` and its engine on the card (``engine_options["device"]``,
None: the card).  ``build_params`` travels to the replica by pickle, so it
must be a module-level function or a ``functools.partial`` of one.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .engine import InferenceEngine, SamplingParams

#: Grace past a request's own timeout before the abandon sweep reclaims it:
#: a caller that is *about* to collect its result never races the sweeper.
_ABANDON_GRACE_S = 5.0


class LLMServer:
    """Callable hosting one InferenceEngine.

    A background thread drives ``engine.step()`` whenever work exists;
    requests block on a per-request event (continuous batching means a
    request joins mid-flight instead of waiting for a batch boundary).  The
    drive thread idles on an event kicked at submit and is joined by a
    bounded :meth:`close`.  A periodic sweep cancels ABANDONED requests, so
    a caller that vanished leaves its slot, KV pages and bookkeeping
    reclaimable instead of leaked.

    ``build_params()`` returns ``(params, cfg)``; ``engine_options`` go to
    :class:`InferenceEngine` (``device`` among them).
    """

    def __init__(self, build_params: Callable[[], tuple],
                 engine_options: Optional[Dict[str, Any]] = None):
        params, cfg = build_params()
        self.engine = InferenceEngine(params, cfg,
                                      **(engine_options or {}))
        self._results: Dict[int, Any] = {}
        self._events: Dict[int, threading.Event] = {}
        # request id -> monotonic deadline after which the request counts
        # as abandoned (its submitter's own timeout + grace).
        self._deadlines: Dict[int, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._work = threading.Event()
        self._last_sweep = 0.0
        from .. import _sanitizer
        self._thread = _sanitizer.spawn(self._drive, name="llm-drive")

    def _submit(self, prompt_tokens: List[int], params: SamplingParams,
                timeout_s: float) -> tuple:
        """Register + enqueue one request; kicks the drive thread."""
        ev = threading.Event()
        with self._lock:
            rid = self.engine.add_request(list(prompt_tokens), params)
            self._events[rid] = ev
            self._deadlines[rid] = time.monotonic() + timeout_s \
                + _ABANDON_GRACE_S
        self._work.set()
        return rid, ev

    def _forget(self, rid: int) -> None:
        with self._lock:
            self._events.pop(rid, None)
            self._results.pop(rid, None)
            self._deadlines.pop(rid, None)

    def _sweep_abandoned(self) -> None:
        """Cancel requests whose submitter stopped waiting (throttled:
        deadlines carry seconds of grace)."""
        now = time.monotonic()
        if now - self._last_sweep < 0.5:
            return
        self._last_sweep = now
        with self._lock:
            stale = [rid for rid, dl in self._deadlines.items()
                     if now > dl]
            for rid in stale:
                self._deadlines.pop(rid, None)
                self._events.pop(rid, None)
                self._results.pop(rid, None)
        for rid in stale:
            self.engine.cancel(rid)

    def _drive(self) -> None:
        while not self._stop.is_set():
            if not self.engine.has_work():
                # Event-kicked idle: submit wakes us instantly; the timeout
                # bounds the abandon sweep lag.
                self._work.wait(timeout=0.5)
                self._work.clear()
                self._sweep_abandoned()
                continue
            for req in self.engine.step():
                with self._lock:
                    # The deadline entry stays until the caller collects
                    # the result: a finished-but-never-claimed result is the
                    # other abandonment shape the sweep must reclaim.
                    ev = self._events.get(req.request_id)
                    if ev is not None:
                        self._results[req.request_id] = req
                if ev is not None:
                    ev.set()
            self._sweep_abandoned()

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """{"prompt_tokens": [...], "max_tokens": N, ...} ->
        {"output_tokens": [...], "finish_reason": ...}"""
        params = SamplingParams.from_body(body)
        timeout_s = float(body.get("timeout_s", 300))
        rid, ev = self._submit(list(body["prompt_tokens"]), params,
                               timeout_s)
        if not ev.wait(timeout=timeout_s):
            # Abandon cleanly: release the engine slot/pages and drop the
            # bookkeeping so repeated timeouts can't leak.
            self._forget(rid)
            self.engine.cancel(rid)
            return {"error": "generation timed out"}
        with self._lock:
            req = self._results.pop(rid)
            self._events.pop(rid, None)
            self._deadlines.pop(rid, None)
        return {"output_tokens": req.output_tokens,
                "finish_reason": req.finish_reason}

    def stream(self, body: Dict[str, Any]):
        """Token-streaming entry point: yields tokens as the engine emits
        them, then ``{"finish_reason", "num_tokens"}``."""
        params = SamplingParams.from_body(body)
        timeout_s = float(body.get("timeout_s", 300))
        rid, ev = self._submit(list(body["prompt_tokens"]), params,
                               timeout_s)
        with self._lock:
            req = self.engine.running.get(rid)
        deadline = time.monotonic() + timeout_s
        sent = 0
        try:
            while True:
                done = ev.wait(timeout=0.01)
                toks = list(req.output_tokens) if req is not None else []
                while sent < len(toks):
                    yield {"token": int(toks[sent]), "index": sent}
                    sent += 1
                if done and sent >= len(req.output_tokens):
                    yield {"finish_reason": req.finish_reason,
                           "num_tokens": sent}
                    return
                if time.monotonic() > deadline:
                    self.engine.cancel(rid)
                    yield {"error": "generation timed out"}
                    return
        finally:
            self._forget(rid)
            # A consumer that drops the generator mid-stream must not leave
            # the slot generating to max_tokens (no-op if already finished).
            self.engine.cancel(rid)

    def generate_batch(self, prompts: List[List[int]],
                       max_tokens: int = 64) -> List[List[int]]:
        """Offline batch entry point."""
        # The caller waits the events SEQUENTIALLY (600 s each), so the
        # abandon deadline must cover the whole batch.
        evs = [self._submit(list(p), SamplingParams(max_tokens=max_tokens),
                            timeout_s=600.0 * len(prompts))
               for p in prompts]
        out = []
        for rid, ev in evs:
            finished = ev.wait(timeout=600)
            with self._lock:
                req = self._results.pop(rid, None)
                self._events.pop(rid, None)
                self._deadlines.pop(rid, None)
            if not finished:
                self.engine.cancel(rid)
            out.append(req.output_tokens if req else [])
        return out

    def close(self, timeout_s: float = 5.0) -> None:
        """Bounded teardown: stop and JOIN the drive thread."""
        self._stop.set()
        self._work.set()
        self._thread.join(timeout_s)

    shutdown = close


def build_llm_deployment(build_params: Callable[[], tuple], *,
                         name: str = "llm",
                         num_replicas: int = 1,
                         num_tpus: int = 0,
                         max_ongoing_requests: int = 64,
                         engine_options: Optional[Dict[str, Any]] = None,
                         autoscaling_config=None):
    """Wrap the engine in a serve deployment (reference: serve/llm
    build_llm_deployment)."""
    from .. import serve

    dep = serve.deployment(
        LLMServer, name=name, num_replicas=num_replicas,
        num_tpus=num_tpus, max_ongoing_requests=max_ongoing_requests,
        autoscaling_config=autoscaling_config)
    return dep.bind(build_params, engine_options)

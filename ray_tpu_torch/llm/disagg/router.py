"""SLO-aware admission control + the disaggregated serving plane
(counterpart of ray_tpu/llm/disagg/router.py, whose host logic is copied).

Separate prefill and decode tiers with KV handoff, fronted by admission
control so overload degrades into FAST RETRIABLE REJECTIONS instead of
timeout storms.

* :class:`AdmissionController`: pure decision logic: per-class token
  budgets, bounded queues, deadline feasibility, and backpressure driven by
  the decode engine's live KV-occupancy/queue load.  A shed is an
  :class:`~ray_tpu_torch.serve.OverloadError` (retriable), never a silent
  timeout.
* :class:`DisaggServer`: one serving plane: router + dispatcher + decode
  driver, on plain ``threading.Thread``s as the port's ``LLMServer``.
  ``mode="disagg"`` runs a :class:`PrefillWorker` on its own stream and
  hands the KV to the decode engine on the card; ``mode="chunked"`` is
  the disagg-off fallback (single engine, long prompts sliced across
  decode steps); ``mode="inline"`` is the stall-everything baseline, kept
  for A/B runs.
* :func:`build_disagg_deployment`: the plane as a serve deployment, which
  needs the serve runtime (ROADMAP Queue 1 item 6) and raises.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ...serve.api import OverloadError
from ...util import telemetry, tracing
from ..engine import InferenceEngine, SamplingParams
from .handoff import _ITEM_6
from .prefill import PrefillWorker


#: Seconds an early finish (see ``DisaggServer._map_or_cancel``) waits for
#: its registration before the sweep drops it.
_EARLY_TTL_S = 60.0


@dataclass
class RequestClass:
    """Admission envelope for one traffic class."""

    name: str = "default"
    #: Max in-flight tokens (prompt + max_tokens, summed over admitted
    #: but unfinished requests).  None = unbounded.
    token_budget: Optional[int] = None
    max_queue_depth: int = 64
    #: A request still queued this long after submit is shed — it would
    #: blow its TTFT SLO anyway, so fail fast and retriably.
    queue_deadline_s: float = 10.0


@dataclass
class AdmissionConfig:
    classes: Dict[str, RequestClass] = field(
        default_factory=lambda: {"default": RequestClass()})
    #: With decode KV occupancy at/above this AND work already waiting,
    #: new arrivals shed instead of joining a queue that cannot drain.
    kv_high_watermark: float = 0.97

    def class_for(self, name: str) -> RequestClass:
        rc = self.classes.get(name)
        if rc is None:
            rc = self.classes.get("default")
        return rc if rc is not None else RequestClass()


class AdmissionController:
    """Shed/admit decisions; DisaggServer feeds it live engine load."""

    def __init__(self, cfg: AdmissionConfig):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._queued: Dict[str, int] = {}
        self._inflight_tokens: Dict[str, int] = {}
        #: EWMA of observed queue wait at dequeue (deadline feasibility).
        self._wait_ewma: Optional[float] = None

    def try_admit(self, clazz: str, total_tokens: int,
                  load: Dict[str, Any]) -> Optional[str]:
        """None = admitted (queue slot + token budget charged); else the
        shed reason."""
        rc = self.cfg.class_for(clazz)
        with self._lock:
            q = self._queued.get(clazz, 0)
            if q >= rc.max_queue_depth:
                return "queue_full"
            if rc.token_budget is not None and \
                    self._inflight_tokens.get(clazz, 0) + total_tokens \
                    > rc.token_budget:
                return "class_budget"
            if load.get("kv_occupancy", 0.0) >= self.cfg.kv_high_watermark \
                    and (q or load.get("waiting", 0)):
                return "backpressure"
            # Deadline feasibility: when requests currently LEAVING the
            # queue already waited past this class's deadline and work
            # is still queued ahead, a new arrival is hopeless — it
            # would age to its deadline and shed at dequeue anyway.
            # Shed it NOW (retriable, microseconds after submit)
            # instead of parking it to die.  Guarded on a non-empty
            # queue so a stale EWMA from a past saturation burst never
            # sheds the first arrivals of a fresh one.
            if self._wait_ewma is not None \
                    and self._wait_ewma > rc.queue_deadline_s \
                    and sum(self._queued.values()) > 0:
                return "deadline_infeasible"
            self._queued[clazz] = q + 1
            self._inflight_tokens[clazz] = \
                self._inflight_tokens.get(clazz, 0) + total_tokens
        self._set_depth_gauge(clazz)
        return None

    def note_dequeued(self, clazz: str) -> None:
        with self._lock:
            self._queued[clazz] = max(0, self._queued.get(clazz, 0) - 1)
        self._set_depth_gauge(clazz)

    def note_queue_wait(self, wait_s: float) -> None:
        """Dispatcher-observed queue wait for one dequeued request —
        feeds the admission-time deadline-feasibility estimate."""
        with self._lock:
            self._wait_ewma = wait_s if self._wait_ewma is None \
                else 0.7 * self._wait_ewma + 0.3 * wait_s

    def note_finished(self, clazz: str, total_tokens: int) -> None:
        with self._lock:
            self._inflight_tokens[clazz] = max(
                0, self._inflight_tokens.get(clazz, 0) - total_tokens)

    def note_shed(self, reason: str) -> None:
        telemetry.inc("ray_tpu_llm_shed_total", tags={"reason": reason})

    def _set_depth_gauge(self, clazz: str) -> None:
        with self._lock:
            depth = self._queued.get(clazz, 0)
        telemetry.set_gauge("ray_tpu_llm_admission_queue_depth", depth,
                            tags={"class": clazz})

    def queue_depth(self) -> int:
        with self._lock:
            return sum(self._queued.values())


@dataclass
class _Pending:
    pub_id: int
    prompt: List[int]
    params: SamplingParams
    clazz: str
    total_tokens: int
    t_submit: float
    deadline: float
    #: After this (caller timeout + grace) an uncollected request counts
    #: as abandoned and is reclaimed by the drive loop's sweep.
    abandon_deadline: float = 0.0
    #: Token budget released exactly once (a caller-timeout _abandon can
    #: race the engine finishing the same request).
    released: bool = False
    #: W3C trace linkage (util/tracing): the submitter's context and the
    #: request's own root span context.  Pipeline stages complete on the
    #: dispatcher/driver threads, so the contexts ride the request
    #: instead of thread-locals — queue-wait / prefill / KV-transfer /
    #: decode-admission spans all land in ONE trace tree.
    trace_parent: Any = None
    trace_root: Any = None
    t_submit_wall: float = 0.0


class DisaggServer:
    """Admission router + (optionally disaggregated) engines, one plane.

    Two background threads (joined by :meth:`close`): the DISPATCHER moves
    admitted requests from the bounded router queue into the engine,
    running prefill and the KV handoff in disagg mode, and the DRIVER steps
    the decode engine and publishes finished results.  ``engine_options``
    go to :class:`InferenceEngine` (``device`` among them); the prefill
    worker shares the engine's weights.  ``store`` (the JAX package's
    shared-memory handoff transport) must be None: see
    :func:`~ray_tpu_torch.llm.disagg.export_handoff`.
    """

    def __init__(self, build_params, *, mode: str = "disagg",
                 admission: Optional[AdmissionConfig] = None,
                 engine_options: Optional[Dict[str, Any]] = None,
                 store=None, record_token_times: bool = False,
                 poll_interval_s: float = 0.002):
        if mode not in ("disagg", "chunked", "inline"):
            raise ValueError(f"unknown mode {mode!r}")
        if store is not None:
            raise NotImplementedError(
                f"DisaggServer(store=...): the object-store handoff "
                f"transport comes with {_ITEM_6}; in one process handoffs "
                f"pass directly (store=None)")
        params, cfg = build_params() if callable(build_params) \
            else build_params
        eo = dict(engine_options or {})
        buckets = eo.get("prefill_buckets", (64, 256, 1024))
        if mode == "chunked":
            eo.setdefault("prefill_chunk", 64)
        else:
            eo.pop("prefill_chunk", None)
        self.mode = mode
        self.engine = InferenceEngine(
            params, cfg, record_token_times=record_token_times, **eo)
        self.prefill_worker = PrefillWorker(
            self.engine.params, cfg, device=self.engine.device,
            prefill_buckets=buckets, page_size=eo.get("page_size", 16)) \
            if mode == "disagg" else None
        self.admission = AdmissionController(admission or AdmissionConfig())
        self._lock = threading.Lock()
        self._queue: "deque[_Pending]" = deque()
        self._events: Dict[int, threading.Event] = {}
        self._results: Dict[int, Dict[str, Any]] = {}
        self._meta: Dict[int, _Pending] = {}
        self._rid_to_pub: Dict[int, int] = {}
        self._pub_to_rid: Dict[int, int] = {}
        self._pub_ids = itertools.count(1)
        #: rid -> (finished request, perf_counter): finishes the drive
        #: thread reported before the dispatcher registered their rid
        #: (see _map_or_cancel).
        self._early: Dict[int, tuple] = {}
        self._stop = threading.Event()
        self._work = threading.Event()
        self._poll = poll_interval_s
        self._last_sweep = 0.0
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="disagg-dispatch", daemon=True)
        self._driver = threading.Thread(
            target=self._drive_loop, name="disagg-drive", daemon=True)
        self._dispatcher.start()
        self._driver.start()

    # -- intake -------------------------------------------------------------

    def submit(self, body: Dict[str, Any],
               clazz: Optional[str] = None) -> int:
        """Admit (or shed) one request; returns a result id to pass to
        :meth:`result`.  Sheds raise :class:`OverloadError` — the
        caller learns about overload in microseconds, not at its
        timeout."""
        if self._stop.is_set():
            raise RuntimeError("DisaggServer is closed")
        clazz = clazz or str(body.get("class", "default"))
        prompt = list(body["prompt_tokens"])
        params = SamplingParams.from_body(body)
        if self.prefill_worker is not None \
                and len(prompt) > self.prefill_worker.prefill_buckets[-1]:
            # Disagg prefill is bucketed; reject clearly at admission
            # instead of charging budget and failing at dispatch (the
            # chunked/inline modes serve any length via the chunked
            # program).
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the largest "
                f"disagg prefill bucket "
                f"({self.prefill_worker.prefill_buckets[-1]})")
        total = len(prompt) + params.max_tokens
        if clazz not in self.admission.cfg.classes:
            # Unknown class names coalesce onto "default" BEFORE any
            # counter is keyed: caller-supplied strings must not mint
            # per-name queue counters (that would void every queue
            # bound) or unbounded gauge tag cardinality.
            clazz = "default"
        reason = self.admission.try_admit(
            clazz, total, self.engine.load_stats())
        if reason is not None:
            self.admission.note_shed(reason)
            raise OverloadError(
                f"request shed ({reason}); retry with backoff")
        rc = self.admission.cfg.class_for(clazz)
        now = time.perf_counter()
        item = _Pending(next(self._pub_ids), prompt, params, clazz,
                        total, now, now + rc.queue_deadline_s,
                        abandon_deadline=now
                        + float(body.get("timeout_s", 300)) + 10.0)
        # Trace linkage: inherit the submitter's context (e.g. the serve
        # replica's execute span) so the LLM request renders as one tree.
        item.trace_parent = tracing.current()
        item.trace_root = tracing.new_child(item.trace_parent)
        item.t_submit_wall = time.time()
        ev = threading.Event()
        with self._lock:
            self._events[item.pub_id] = ev
            self._meta[item.pub_id] = item
            self._queue.append(item)
        self._work.set()
        return item.pub_id

    def result(self, pub_id: int, timeout_s: float = 300.0
               ) -> Dict[str, Any]:
        """Block for one submitted request's result.  On timeout the
        request is cancelled and its engine slot/pages freed (no
        abandoned-entry leak)."""
        now = time.perf_counter()
        with self._lock:
            ev = self._events.get(pub_id)
            item = self._meta.get(pub_id)
            if item is not None:
                # An actively-waiting caller extends the abandon window:
                # the sweep must never cancel work someone is blocked on
                # (result timeouts can exceed the submit-time default).
                item.abandon_deadline = max(item.abandon_deadline,
                                            now + timeout_s + 10.0)
        if ev is None:
            raise KeyError(f"unknown or already-collected id {pub_id}")
        if not ev.wait(timeout_s):
            self._abandon(pub_id)
            return {"error": "generation timed out",
                    "finish_reason": "timeout"}
        with self._lock:
            res = self._results.pop(pub_id, None)
            self._events.pop(pub_id, None)
            self._meta.pop(pub_id, None)
            self._pub_to_rid.pop(pub_id, None)
        if res is None:    # reclaimed between wake and collect
            return {"error": "request was cancelled",
                    "finish_reason": "cancelled"}
        return res

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Serve-replica entry point: submit + wait."""
        pub_id = self.submit(body)
        return self.result(pub_id,
                           timeout_s=float(body.get("timeout_s", 300)))

    def _trace_phase(self, item: _Pending, name: str, start_wall: float,
                     attrs: Optional[Dict[str, Any]] = None) -> None:
        """Record one pipeline-phase span under the request's root (a
        no-op when the request carries no trace context)."""
        if item.trace_root is None:
            return
        tracing.record_span(item.trace_root, name, start_wall,
                            time.time(), attrs or {})

    def _release_budget(self, item: Optional[_Pending]) -> None:
        """Return the class token budget exactly once per request (a
        caller-timeout abandon can race the engine finish)."""
        if item is None:
            return
        with self._lock:
            if item.released:
                return
            item.released = True
        self.admission.note_finished(item.clazz, item.total_tokens)

    def _abandon(self, pub_id: int) -> None:
        with self._lock:
            ev = self._events.pop(pub_id, None)
            self._results.pop(pub_id, None)
            item = self._meta.pop(pub_id, None)
            rid = self._pub_to_rid.pop(pub_id, None)
            if rid is not None:
                self._rid_to_pub.pop(rid, None)
            try:
                self._queue.remove(item)
                queued = True
            except ValueError:
                queued = False
        if item is not None:
            if queued:
                self.admission.note_dequeued(item.clazz)
            self._release_budget(item)
        if rid is not None:
            self.engine.cancel(rid)
        if ev is not None:
            # Wake any caller still blocked in result(): it reports
            # "cancelled" immediately instead of sleeping out its
            # timeout against an event nobody will ever set.
            ev.set()

    def _sweep_abandoned(self) -> None:
        """Reclaim requests whose caller stopped waiting (never called
        result()): frees the engine slot/pages and every bookkeeping
        entry — the same guarantee LLMServer's sweep gives.  Throttled:
        deadlines have 10 s granularity, so an O(pending) scan per
        decode step would be pure hot-loop overhead."""
        now = time.perf_counter()
        if now - self._last_sweep < 0.5:
            return
        self._last_sweep = now
        with self._lock:
            stale = [pub_id for pub_id, item in self._meta.items()
                     if now > item.abandon_deadline]
            # An early finish nobody registered (its request abandoned
            # mid hand-off) is dropped after a while.
            for rid, (_req, t) in list(self._early.items()):
                if now - t > _EARLY_TTL_S:
                    del self._early[rid]
        for pub_id in stale:
            self._abandon(pub_id)

    # -- dispatch (router queue -> engine) ----------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            item = None
            with self._lock:
                if self._queue:
                    item = self._queue.popleft()
            if item is None:
                self._work.wait(0.02)
                self._work.clear()
                continue
            self._trace_phase(item, "queue_wait", item.t_submit_wall,
                              {"class": item.clazz})
            now = time.perf_counter()
            self.admission.note_queue_wait(now - item.t_submit)
            if now > item.deadline:
                self._finish_shed(item, "deadline")
                continue
            try:
                if self.mode == "disagg":
                    self._dispatch_disagg(item)
                else:
                    self._dispatch_engine(item)
            except Exception as e:  # publish, never wedge the loop
                self.admission.note_dequeued(item.clazz)
                self._release_budget(item)
                self._publish(item.pub_id,
                              {"error": str(e), "finish_reason": "error"})

    def _engine_has_room(self) -> bool:
        stats = self.engine.load_stats()
        return stats["waiting"] < max(2, self.engine.max_slots)

    def _gone(self, item: _Pending) -> bool:
        """True when the request was abandoned while the dispatcher held
        it (its _meta entry is gone): dispatch must drop it instead of
        handing a dead caller's request to the engine."""
        with self._lock:
            return item.pub_id not in self._meta

    def _map_or_cancel(self, item: _Pending, rid: int) -> None:
        """Register the engine rid for a dispatched item — unless the
        caller abandoned it during the hand-off, in which case the
        engine request is cancelled immediately (a dead request must
        not hold a decode slot to max_tokens under saturation).

        The drive thread may step, and finish, the request between the
        engine taking it and this registration (at once for max_tokens=1);
        its finish then waits in ``_early`` and is published here."""
        with self._lock:
            alive = item.pub_id in self._meta
            if alive:
                self._rid_to_pub[rid] = item.pub_id
                self._pub_to_rid[item.pub_id] = rid
            early = self._early.pop(rid, None)
        if not alive:
            self.engine.cancel(rid)
        self.admission.note_dequeued(item.clazz)
        self._work.set()
        if alive and early is not None:
            self._on_engine_finish(early[0])

    def _dispatch_engine(self, item: _Pending) -> None:
        """Single-engine modes: hand to the engine once its own waiting
        list has room — until then the request stays the ROUTER's,
        where deadline shedding applies."""
        t_adm = time.time()
        while not self._stop.is_set():
            if self._gone(item):
                self.admission.note_dequeued(item.clazz)
                return
            if time.perf_counter() > item.deadline:
                self._finish_shed(item, "deadline")
                return
            if self._engine_has_room():
                break
            time.sleep(self._poll)
        if self._stop.is_set():
            self._finish_shed(item, "deadline")
            return
        rid = self.engine.add_request(item.prompt, item.params)
        self._trace_phase(item, "decode_admission", t_adm,
                          {"engine_rid": rid})
        self._map_or_cancel(item, rid)

    def _dispatch_disagg(self, item: _Pending) -> None:
        """Disagg mode: prefill on the prefill tier, hand the KV to the
        decode engine on the card, retry import under decode
        backpressure."""
        t_pf = time.time()
        handoff = self.prefill_worker.prefill(
            item.prompt, item.params, t_submit=item.t_submit)
        self._trace_phase(item, "prefill", t_pf,
                          {"prompt_tokens": len(item.prompt)})
        self._trace_phase(item, "kv_transfer", time.time(),
                          {"transport": "inline", "bytes": handoff.nbytes})
        t_adm = time.time()
        rid = None
        gone = False
        while not self._stop.is_set():
            gone = self._gone(item)
            if gone:
                break
            rid = self.engine.import_prefill(handoff)
            if rid is not None:
                break
            if time.perf_counter() > item.deadline:
                break
            time.sleep(self._poll)
        if gone:
            self.admission.note_dequeued(item.clazz)
            return
        if rid is None:
            self._finish_shed(item, "deadline")
            return
        # Admission wait INTO the decode batch (import retries under KV
        # backpressure) — distinct from the transfer itself.
        self._trace_phase(item, "decode_admission", t_adm,
                          {"engine_rid": rid})
        self._map_or_cancel(item, rid)

    def _finish_shed(self, item: _Pending, reason: str) -> None:
        self.admission.note_dequeued(item.clazz)
        self._release_budget(item)
        self.admission.note_shed(reason)
        self._publish(item.pub_id,
                      {"error": f"request shed ({reason}); retry with "
                                "backoff",
                       "reason": reason, "retriable": True,
                       "finish_reason": "shed"})

    # -- decode drive -------------------------------------------------------

    def _drive_loop(self) -> None:
        while not self._stop.is_set():
            if not self.engine.has_work():
                self._work.wait(0.02)
                self._work.clear()
                self._sweep_abandoned()
                continue
            for req in self.engine.step():
                self._on_engine_finish(req)
            self._sweep_abandoned()

    def _on_engine_finish(self, req) -> None:
        with self._lock:
            pub_id = self._rid_to_pub.pop(req.request_id, None)
            item = self._meta.get(pub_id) if pub_id is not None else None
            if pub_id is None:
                self._early[req.request_id] = (req, time.perf_counter())
                return
        self._release_budget(item)
        itl = [b - a for a, b in zip(req.token_times,
                                     req.token_times[1:])]
        self._publish(pub_id, {
            "output_tokens": list(req.output_tokens),
            "finish_reason": req.finish_reason,
            "ttft_s": (req.t_first - req.t_submit)
            if req.t_first and req.t_submit else None,
            "itl_s": itl,
        })

    def _publish(self, pub_id: int, result: Dict[str, Any]) -> None:
        with self._lock:
            ev = self._events.get(pub_id)
            item = self._meta.get(pub_id)
            if ev is None:       # abandoned while in flight: drop
                self._meta.pop(pub_id, None)
                self._pub_to_rid.pop(pub_id, None)
                return
            self._results[pub_id] = result
        if item is not None and item.trace_root is not None:
            # Close the request's root span (the phases above are its
            # children) under the submitter's context.
            tracing.record_span(
                item.trace_parent, "llm_request", item.t_submit_wall,
                time.time(),
                {"mode": self.mode, "class": item.clazz,
                 "finish_reason": result.get("finish_reason")},
                ctx=item.trace_root)
        ev.set()

    # -- introspection / lifecycle ------------------------------------------

    def load(self) -> Dict[str, Any]:
        stats = self.engine.load_stats()
        stats["router_queue"] = self.admission.queue_depth()
        stats["mode"] = self.mode
        return stats

    def close(self, timeout_s: float = 5.0) -> None:
        """Bounded shutdown: stop both loops, join them, and fail every
        still-pending request loudly (callers never hang on a closed
        server)."""
        self._stop.set()
        self._work.set()
        self._dispatcher.join(timeout_s)
        self._driver.join(timeout_s)
        with self._lock:
            for pub_id, ev in list(self._events.items()):
                if pub_id not in self._results:
                    self._results[pub_id] = {"error": "server closed",
                                             "finish_reason": "closed"}
                ev.set()

    # Serve teardown calls shutdown() on replicas that expose it.
    shutdown = close


def build_disagg_deployment(build_params, **_options):
    """The serve deployment of :class:`DisaggServer` needs the serve
    runtime over processes, which the port has not reached yet."""
    raise NotImplementedError(
        f"build_disagg_deployment needs the serve runtime, which comes with "
        f"{_ITEM_6}; use DisaggServer directly")

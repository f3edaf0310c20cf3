"""FleetServer: N decode replicas behind one admission router (counterpart
of ray_tpu/llm/fleet/server.py, whose host logic is copied).

* the SAME :class:`~ray_tpu_torch.llm.disagg.AdmissionController` the
  single-engine plane uses fronts the whole fleet (per-class budgets,
  bounded queues, deadline shedding: one SLO surface regardless of replica
  count);
* a shared prefill TIER (:class:`~ray_tpu_torch.llm.disagg.PrefillWorker`,
  on its own stream) computes prompt KV once and hands it to whichever
  replica the :class:`~ray_tpu_torch.llm.fleet.router.FleetRouter` picks;
* full prefix hits skip the prefill tier entirely: the target replica
  replays its cached handoff straight into its decode batch;
* a manager thread runs health/drain bookkeeping, executes
  :class:`~ray_tpu_torch.llm.fleet.autoscale.ServeAutoscalePolicy`
  decisions (scale up = spawn, scale down = drain-then-kill, never kill
  work), backfills replicas lost to chaos, and publishes a fleet snapshot
  to this process's control plane (``_control.py``) when it has one.

A replica loss sheds exactly the requests that were mid-flight on it
(retriable results, never a hang) and the fleet keeps serving on the
survivors.  On one card every replica, and the prefill tier, has its own
stream and shares one copy of the weights.  With ``store=`` each handoff
goes through the object store (export, import, release), as JAX's does;
a ``replica_factory`` building :class:`~ray_tpu_torch.llm.fleet.remote.
RemoteReplica` puts every replica in a process of its own.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ... import _control
from ..._device import resolve_device
from ...serve.api import OverloadError
from ...util import telemetry, tracing
from ..disagg.handoff import export_handoff, import_handoff
from ..disagg.prefill import PrefillWorker
from ..disagg.router import (_EARLY_TTL_S, AdmissionConfig,
                             AdmissionController, _Pending)
from ..engine import SamplingParams, _to_device
from .autoscale import ServeAutoscalePolicy, ServeScaleConfig
from .prefix import full_hash, prefix_chain
from .replica import DecodeReplica
from .router import FleetRouter, RoutingConfig

#: Control-plane key prefix for published fleet snapshots (CLI/dashboard).
FLEET_KV_PREFIX = "serve:fleet:"


@dataclass
class FleetConfig:
    #: Initial replica count; also the backfill target until the
    #: autoscaler moves it.
    num_replicas: int = 1
    engine_options: Dict[str, Any] = field(default_factory=dict)
    #: Per-replica prefix-cache budget (bytes of retained handoff K/V, in
    #: device memory on the card).
    cache_capacity_bytes: int = 64 * 1024 * 1024
    routing: Optional[RoutingConfig] = None
    #: None = fixed-size fleet (no autoscaler).
    autoscale: Optional[ServeScaleConfig] = None
    manager_interval_s: float = 0.25
    publish_interval_s: float = 0.5


class FleetServer:
    """Admission router + prefill tier + N decode replicas, one plane.

    Interface-compatible with
    :class:`~ray_tpu_torch.llm.disagg.DisaggServer` (``submit``/``result``/
    ``__call__``/``load``/``close``), so the open-loop loadgen drives it
    unchanged.  ``config.engine_options`` go to every replica's engine
    (``device`` among them).  ``store`` (a
    ``ray_tpu_torch._object_store.SharedMemoryStore``) routes each
    handoff through it (:func:`~ray_tpu_torch.llm.disagg.export_handoff`);
    a ``replica_factory`` ``(name, on_finish) -> replica`` replaces the
    local :class:`DecodeReplica`.
    """

    def __init__(self, build_params, *, name: str = "fleet",
                 admission: Optional[AdmissionConfig] = None,
                 config: Optional[FleetConfig] = None,
                 store=None, record_token_times: bool = False,
                 replica_factory: Optional[Callable[..., Any]] = None,
                 poll_interval_s: float = 0.002):
        self.name = name
        self._store = store
        self.config = config or FleetConfig()
        params, cfg = build_params() if callable(build_params) \
            else build_params
        eo = dict(self.config.engine_options)
        # Weights go to the card once; the prefill tier and every replica
        # use these tensors.
        device = resolve_device(eo.get("device"))
        params = _to_device(params, device)
        self._build = (params, cfg)
        buckets = eo.get("prefill_buckets", (64, 256, 1024))
        self.prefill = PrefillWorker(
            params, cfg, device=device, prefill_buckets=buckets,
            page_size=eo.get("page_size", 16))
        self.admission = AdmissionController(admission or AdmissionConfig())
        self.router = FleetRouter(self.config.routing)
        self.policy = ServeAutoscalePolicy(self.config.autoscale) \
            if self.config.autoscale is not None else None
        self._record_token_times = record_token_times
        self._block = eo.get("page_size", 16)
        self._factory = replica_factory or self._local_replica
        self._poll = poll_interval_s

        self._lock = threading.Lock()
        self._replicas: Dict[str, Any] = {}
        self._assigned: Dict[str, int] = {}
        self._draining: List[str] = []
        self._target = max(1, int(self.config.num_replicas))
        self._replica_ids = itertools.count()

        self._queue: "deque[_Pending]" = deque()
        self._events: Dict[int, threading.Event] = {}
        self._results: Dict[int, Dict[str, Any]] = {}
        self._meta: Dict[int, _Pending] = {}
        self._rid_map: Dict[tuple, int] = {}      # (replica, rid) -> pub
        self._pub_to_rid: Dict[int, tuple] = {}   # pub -> (replica, rid)
        self._outcome: Dict[int, tuple] = {}      # pub -> (outcome, replica)
        self._pub_ids = itertools.count(1)
        #: (replica, rid) -> (finished request, perf_counter): finishes a
        #: replica reported before the dispatcher registered them (_map).
        self._early: Dict[tuple, tuple] = {}

        self._n_done = 0
        self._n_shed = 0
        self._prefix_counts = {"full": 0, "partial": 0, "miss": 0}
        self._rebalances = 0
        self._scales = {"up": 0, "down": 0}
        self._itl_buf: List[float] = []
        self._manager_errors = 0
        self._last_sweep = 0.0
        self._last_publish = 0.0

        self._stop = threading.Event()
        self._work = threading.Event()
        if replica_factory is None:
            for _ in range(self._target):
                self._add_replica()
        else:
            # A factory's replicas (processes, for RemoteReplica) start
            # together.
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(self._target) as pool:
                list(pool.map(lambda _: self._add_replica(),
                              range(self._target)))
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name=f"fleet-dispatch-{name}",
            daemon=True)
        self._manager = threading.Thread(
            target=self._manage_loop, name=f"fleet-manage-{name}",
            daemon=True)
        self._dispatcher.start()
        self._manager.start()

    # -- replica set --------------------------------------------------------

    def _local_replica(self, name: str, on_finish) -> DecodeReplica:
        return DecodeReplica(
            self._build, name=name,
            engine_options=self.config.engine_options,
            cache_capacity_bytes=self.config.cache_capacity_bytes,
            record_token_times=self._record_token_times,
            on_finish=on_finish)

    def _add_replica(self) -> str:
        name = f"{self.name}-r{next(self._replica_ids)}"
        rep = self._factory(name, self._on_replica_finish)
        with self._lock:
            self._replicas[name] = rep
            self._assigned.setdefault(name, 0)
        self._set_count_gauge()
        self._work.set()
        return name

    def _set_count_gauge(self) -> None:
        with self._lock:
            n = sum(1 for r in self._replicas.values() if r.accepting)
        telemetry.set_gauge("ray_tpu_serve_replica_count", n,
                            tags={"fleet": self.name})

    def scale_up(self, reason: str = "manual") -> str:
        """Add one replica (autoscaler 'up', manual, or backfill)."""
        name = self._add_replica()
        with self._lock:
            # Count only accepting replicas: _replicas still holds any
            # draining ones, which must not inflate the fleet target.
            accepting = sum(
                1 for r in self._replicas.values() if r.accepting)
            self._target = max(self._target, accepting)
            self._scales["up"] += 1
        telemetry.inc("ray_tpu_serve_replica_scale_total",
                      tags={"direction": "up"})
        return name

    def scale_down(self, reason: str = "manual") -> Optional[str]:
        """Drain the least-loaded replica; the manager kills it once
        idle.  Never removes the last accepting replica."""
        with self._lock:
            accepting = [(n, r) for n, r in self._replicas.items()
                         if r.accepting]
            if len(accepting) <= 1:
                return None
            name, rep = min(
                accepting,
                key=lambda nr: len(nr[1].engine.running)
                + self._assigned.get(nr[0], 0))
            self._target = max(1, self._target - 1)
            self._draining.append(name)
            self._scales["down"] += 1
        rep.drain()
        telemetry.inc("ray_tpu_serve_replica_scale_total",
                      tags={"direction": "down"})
        self._set_count_gauge()
        return name

    def kill_replica(self, name: str, timeout_s: float = 5.0) -> bool:
        """Hard-kill one replica (chaos / lost node).  Its in-flight
        requests shed retriably; the manager backfills to target."""
        with self._lock:
            rep = self._replicas.pop(name, None)
            self._assigned.pop(name, None)
            if name in self._draining:
                self._draining.remove(name)
        if rep is None:
            return False
        rep.kill(timeout_s)
        # Shed EVERY request still mapped to the replica (not just what
        # kill() reported): retriable shed, never a hang until caller
        # timeout.
        with self._lock:
            lost_pubs = [(key, pub) for key, pub in self._rid_map.items()
                         if key[0] == name]
            for key, pub in lost_pubs:
                self._rid_map.pop(key, None)
                self._pub_to_rid.pop(pub, None)
            items = [self._meta.get(pub) for _k, pub in lost_pubs]
        for item in items:
            if item is not None:
                self._finish_shed(item, "replica_lost", dequeued=True)
        self._set_count_gauge()
        self._work.set()
        return True

    # -- intake (DisaggServer-compatible) -----------------------------------

    def _fleet_load(self) -> Dict[str, Any]:
        """Aggregate load for admission: the BEST accepting replica's
        view (the router places on the least loaded, so shedding keys
        off the replica a new request would actually land on)."""
        with self._lock:
            reps = [r for r in self._replicas.values() if r.accepting]
        if not reps:
            return {"kv_occupancy": 1.0, "waiting": 1}
        stats = [r.load_stats() for r in reps]
        return {"kv_occupancy": min(s["kv_occupancy"] for s in stats),
                "waiting": min(s["waiting"] for s in stats)}

    def submit(self, body: Dict[str, Any],
               clazz: Optional[str] = None) -> int:
        if self._stop.is_set():
            raise RuntimeError("FleetServer is closed")
        clazz = clazz or str(body.get("class", "default"))
        prompt = list(body["prompt_tokens"])
        params = SamplingParams.from_body(body)
        if len(prompt) > self.prefill.prefill_buckets[-1]:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the largest "
                f"prefill bucket ({self.prefill.prefill_buckets[-1]})")
        total = len(prompt) + params.max_tokens
        if clazz not in self.admission.cfg.classes:
            clazz = "default"
        reason = self.admission.try_admit(
            clazz, total, self._fleet_load())
        if reason is not None:
            self.admission.note_shed(reason)
            with self._lock:
                self._n_shed += 1
            raise OverloadError(
                f"request shed ({reason}); retry with backoff")
        rc = self.admission.cfg.class_for(clazz)
        now = time.perf_counter()
        item = _Pending(next(self._pub_ids), prompt, params, clazz,
                        total, now, now + rc.queue_deadline_s,
                        abandon_deadline=now
                        + float(body.get("timeout_s", 300)) + 10.0)
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
        now = time.perf_counter()
        with self._lock:
            ev = self._events.get(pub_id)
            item = self._meta.get(pub_id)
            if item is not None:
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
        if res is None:
            return {"error": "request was cancelled",
                    "finish_reason": "cancelled"}
        return res

    def __call__(self, body: Dict[str, Any]) -> Dict[str, Any]:
        pub_id = self.submit(body)
        return self.result(pub_id,
                           timeout_s=float(body.get("timeout_s", 300)))

    # -- bookkeeping shared with DisaggServer's shape -----------------------

    def _trace_phase(self, item: _Pending, name: str, start_wall: float,
                     attrs: Optional[Dict[str, Any]] = None) -> None:
        if item.trace_root is None:
            return
        tracing.record_span(item.trace_root, name, start_wall,
                            time.time(), attrs or {})

    def _release_budget(self, item: Optional[_Pending]) -> None:
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
            target = self._pub_to_rid.pop(pub_id, None)
            if target is not None:
                self._rid_map.pop(target, None)
            self._outcome.pop(pub_id, None)
            try:
                self._queue.remove(item)
                queued = True
            except ValueError:
                queued = False
            rep = self._replicas.get(target[0]) \
                if target is not None else None
        if item is not None:
            if queued:
                self.admission.note_dequeued(item.clazz)
            self._release_budget(item)
        if rep is not None:
            rep.cancel(target[1])
        if ev is not None:
            ev.set()

    def _sweep_abandoned(self) -> None:
        now = time.perf_counter()
        if now - self._last_sweep < 0.5:
            return
        self._last_sweep = now
        with self._lock:
            stale = [pub_id for pub_id, item in self._meta.items()
                     if now > item.abandon_deadline]
            for key, (_req, t) in list(self._early.items()):
                if now - t > _EARLY_TTL_S:
                    del self._early[key]
        for pub_id in stale:
            self._abandon(pub_id)

    def _gone(self, item: _Pending) -> bool:
        with self._lock:
            return item.pub_id not in self._meta

    def _finish_shed(self, item: _Pending, reason: str,
                     dequeued: bool = False) -> None:
        if not dequeued:
            self.admission.note_dequeued(item.clazz)
        self._release_budget(item)
        self.admission.note_shed(reason)
        with self._lock:
            self._n_shed += 1
        self._publish(item.pub_id,
                      {"error": f"request shed ({reason}); retry with "
                                "backoff",
                       "reason": reason, "retriable": True,
                       "finish_reason": "shed"})

    def _publish(self, pub_id: int, result: Dict[str, Any]) -> None:
        with self._lock:
            ev = self._events.get(pub_id)
            item = self._meta.get(pub_id)
            if ev is None:
                self._meta.pop(pub_id, None)
                self._pub_to_rid.pop(pub_id, None)
                self._outcome.pop(pub_id, None)
                return
            self._results[pub_id] = result
        if item is not None and item.trace_root is not None:
            tracing.record_span(
                item.trace_parent, "llm_request", item.t_submit_wall,
                time.time(),
                {"mode": "fleet", "class": item.clazz,
                 "finish_reason": result.get("finish_reason")},
                ctx=item.trace_root)
        ev.set()

    # -- dispatch (router queue -> a replica) -------------------------------

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
                self._dispatch(item)
            except Exception as e:  # publish, never wedge the loop
                self.admission.note_dequeued(item.clazz)
                self._release_budget(item)
                self._publish(item.pub_id,
                              {"error": str(e), "finish_reason": "error"})

    def _views(self) -> List[Dict[str, Any]]:
        """Routing snapshot: one view per ACCEPTING replica."""
        with self._lock:
            reps = [(n, r) for n, r in self._replicas.items()
                    if r.accepting]
            assigned = dict(self._assigned)
        return [{"name": n, "load": r.load_stats(),
                 "summary": r.summary(),
                 "assigned": assigned.get(n, 0)} for n, r in reps]

    def _map(self, item: _Pending, replica: str, rid: int,
             outcome: str, rep) -> None:
        """Register a dispatched request's (replica, rid) — unless the
        caller abandoned it during the hand-off, or a chaos kill landed
        between the import and this registration (the kill's shed sweep
        can't see an unregistered rid, so the request would hang until
        caller timeout — shed it here instead).

        The replica's drive thread may step, and finish, the request
        between import_prefill's return and this registration; its finish
        then waits in ``_early`` and is published here."""
        with self._lock:
            alive = item.pub_id in self._meta
            routed = self._replicas.get(replica) is rep
            if alive and routed:
                self._rid_map[(replica, rid)] = item.pub_id
                self._pub_to_rid[item.pub_id] = (replica, rid)
                self._outcome[item.pub_id] = (outcome, replica)
                self._prefix_counts[outcome] = \
                    self._prefix_counts.get(outcome, 0) + 1
            early = self._early.pop((replica, rid), None)
        if not alive:
            rep.cancel(rid)
        elif not routed:
            self._finish_shed(item, "replica_lost")
            return
        else:
            # Count only successfully mapped dispatches so the series
            # stays in lockstep with status()'s _prefix_counts.
            telemetry.inc("ray_tpu_serve_prefix_hit_total",
                          tags={"outcome": outcome})
        self.admission.note_dequeued(item.clazz)
        self._work.set()
        if alive and early is not None:
            self._on_replica_finish(rep, early[0])

    def _dispatch(self, item: _Pending) -> None:
        """Route one admitted request: score replicas, try the cache-hit
        fast path, else prefill once and import onto the chosen replica
        — re-routing (same handoff, no re-prefill) whenever the target
        stops accepting mid-retry (drain, chaos kill)."""
        params = item.params
        chain = prefix_chain(item.prompt, self._block)
        fh = full_hash(item.prompt)
        handoff = None
        rebalance_seen = False
        oid = None
        keepalive = None
        try:
            while not self._stop.is_set():
                if self._gone(item):
                    self.admission.note_dequeued(item.clazz)
                    return
                if time.perf_counter() > item.deadline:
                    self._finish_shed(item, "deadline")
                    return
                views = self._views()
                if not views:
                    time.sleep(self._poll)
                    continue
                decision = self.router.route(views, chain, fh)
                with self._lock:
                    rep = self._replicas.get(decision.replica)
                if rep is None or not rep.accepting:
                    continue
                if decision.rebalanced and not rebalance_seen:
                    rebalance_seen = True
                    with self._lock:
                        self._rebalances += 1
                    telemetry.inc("ray_tpu_serve_rebalance_total")
                if handoff is None and decision.outcome == "full" \
                        and params.temperature <= 0.0:
                    rid = rep.try_serve_cached(
                        item.prompt, params, item.t_submit)
                    if rid is not None:
                        self._trace_phase(
                            item, "prefix_replay", time.time(),
                            {"replica": decision.replica,
                             "shared_blocks": decision.shared_blocks})
                        self._map(item, decision.replica, rid, "full",
                                  rep)
                        return
                    # Cache raced away (eviction) or momentary engine
                    # backpressure: fall through to the cold path.
                if handoff is None:
                    t_pf = time.time()
                    handoff = self.prefill.prefill(
                        item.prompt, params, t_submit=item.t_submit)
                    self._trace_phase(item, "prefill", t_pf,
                                      {"prompt_tokens": len(item.prompt)})
                    if self._store is not None:
                        from ..._object_store import new_object_id
                        oid = new_object_id()
                        desc = export_handoff(self._store, oid, handoff)
                        if desc is not None:
                            handoff, keepalive = import_handoff(desc)
                        else:
                            oid = None  # store full: direct handoff
                # Bounded import retries on THIS target, then re-route:
                # a draining/killed target must not eat the deadline.
                outcome = "miss" if decision.outcome == "full" \
                    else decision.outcome
                with self._lock:
                    self._assigned[decision.replica] = \
                        self._assigned.get(decision.replica, 0) + 1
                rid = None
                retarget_at = time.perf_counter() + 0.05
                try:
                    t_adm = time.time()
                    while not self._stop.is_set():
                        if not rep.accepting or self._gone(item):
                            break
                        rid = rep.import_prefill(handoff)
                        if rid is not None:
                            break
                        if time.perf_counter() > min(item.deadline,
                                                     retarget_at):
                            break
                        time.sleep(self._poll)
                finally:
                    with self._lock:
                        if decision.replica in self._assigned:
                            self._assigned[decision.replica] = max(
                                0, self._assigned[decision.replica] - 1)
                if rid is not None:
                    self._trace_phase(item, "decode_admission", t_adm,
                                      {"replica": decision.replica,
                                       "engine_rid": rid})
                    self._map(item, decision.replica, rid, outcome, rep)
                    return
                # else: loop re-evaluates (deadline, gone, re-route).
            self._finish_shed(item, "deadline")
        finally:
            # Every import of the staged blob has run (a remote replica
            # answers once its scatter has finished on the device), so
            # it can go.
            del handoff, keepalive
            if oid is not None:
                from ..._object_store import release_page_blob
                release_page_blob(self._store, oid)

    # -- replica finish callback (runs on replica drive threads) ------------

    def _on_replica_finish(self, replica, req) -> None:
        with self._lock:
            pub_id = self._rid_map.pop((replica.name, req.request_id),
                                       None)
            item = self._meta.get(pub_id) if pub_id is not None else None
            outcome, rep_name = self._outcome.pop(
                pub_id, (None, replica.name)) if pub_id is not None \
                else (None, replica.name)
            if pub_id is None:
                self._early[(replica.name, req.request_id)] = (
                    req, time.perf_counter())
                return
        self._release_budget(item)
        itl = [b - a for a, b in zip(req.token_times,
                                     req.token_times[1:])]
        with self._lock:
            self._n_done += 1
            if itl:
                self._itl_buf.extend(itl)
                del self._itl_buf[:-4096]
        self._publish(pub_id, {
            "output_tokens": list(req.output_tokens),
            "finish_reason": req.finish_reason,
            "ttft_s": (req.t_first - req.t_submit)
            if req.t_first and req.t_submit else None,
            "itl_s": itl,
            "replica": rep_name,
            "prefix_outcome": outcome,
        })

    # -- manager (health / drain / autoscale / publish) ---------------------

    def _manage_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.config.manager_interval_s)
            if self._stop.is_set():
                return
            try:
                self._manage_tick()
            except Exception:
                # Never kill the manager: a transient spawn/publish
                # failure must not strand draining replicas forever.
                self._manager_errors += 1

    def _manage_tick(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._sweep_abandoned()
        # Reap replicas that died out from under us: shed their in-flight,
        # let backfill replace.
        with self._lock:
            dead = [n for n, r in self._replicas.items()
                    if r.state == "dead"]
        for name in dead:
            self.kill_replica(name)
        # Finish drains whose replicas went idle.
        with self._lock:
            draining = [(n, self._replicas.get(n))
                        for n in list(self._draining)]
        for name, rep in draining:
            if rep is None:
                with self._lock:
                    if name in self._draining:
                        self._draining.remove(name)
                continue
            if rep.idle():
                with self._lock:
                    if name in self._draining:
                        self._draining.remove(name)
                    self._replicas.pop(name, None)
                    self._assigned.pop(name, None)
                rep.kill()
                self._set_count_gauge()
        # Backfill chaos losses up to target (autoscaler moves target).
        with self._lock:
            active = sum(1 for r in self._replicas.values()
                         if r.accepting)
            deficit = self._target - active
            pending = len(self._draining)
        if deficit > 0 and not pending:
            self.scale_up(reason="backfill")
            active += 1
        # Autoscale.
        if self.policy is not None:
            with self._lock:
                samples = list(self._itl_buf)
                self._itl_buf.clear()
                n_shed, n_done = self._n_shed, self._n_done
                assigned_total = sum(self._assigned.values())
            self.policy.observe(
                queue_depth=self.admission.queue_depth()
                + assigned_total,
                shed_total=n_shed, completed_total=n_done,
                replicas=active, itl_samples=samples, now=now)
            decision = self.policy.decide(pending=pending, now=now)
            if decision is not None:
                if decision.direction == "up":
                    with self._lock:
                        self._target += 1
                    self.scale_up(reason=decision.reason)
                else:
                    if self.scale_down(reason=decision.reason) is None:
                        self.policy.forget_action()
        self._publish_status()

    # -- status surfaces ----------------------------------------------------

    def status(self) -> Dict[str, Any]:
        with self._lock:
            reps = list(self._replicas.items())
            assigned = dict(self._assigned)
            snap = {
                "target_replicas": self._target,
                "draining": list(self._draining),
                "completed": self._n_done,
                "shed": self._n_shed,
                "prefix": dict(self._prefix_counts),
                "rebalances": self._rebalances,
                "scales": dict(self._scales),
            }
        replicas = []
        for name, rep in reps:
            stats = rep.load_stats()
            stats["assigned"] = assigned.get(name, 0)
            replicas.append(stats)
        snap["name"] = self.name
        snap["replicas"] = replicas
        snap["router_queue"] = self.admission.queue_depth()
        snap["autoscale"] = self.policy.status() \
            if self.policy is not None else None
        return snap

    def load(self) -> Dict[str, Any]:
        stats = self._fleet_load()
        stats["router_queue"] = self.admission.queue_depth()
        stats["mode"] = "fleet"
        with self._lock:
            stats["replicas"] = len(self._replicas)
        return stats

    def _publish_status(self) -> None:
        """Throttled fleet snapshot into this process's control plane (a
        no-op when it has none, as JAX's is without a cluster)."""
        now = time.monotonic()
        if now - self._last_publish < self.config.publish_interval_s:
            return
        self._last_publish = now
        plane = _control._current
        if plane is None:
            return
        try:
            plane.kv_put(FLEET_KV_PREFIX + self.name,
                         json.dumps(self.status(), default=str).encode())
        except Exception as exc:  # best effort: never stop the manager
            telemetry.note_swallowed("fleet_publish_status", exc)

    # -- lifecycle ----------------------------------------------------------

    def close(self, timeout_s: float = 5.0) -> None:
        """Bounded shutdown: stop dispatcher/manager, kill replicas,
        fail every still-pending request loudly."""
        self._stop.set()
        self._work.set()
        self._dispatcher.join(timeout_s)
        self._manager.join(timeout_s)
        with self._lock:
            reps = list(self._replicas.values())
            self._replicas.clear()
            self._assigned.clear()
        for rep in reps:
            try:
                rep.kill(timeout_s)
            except Exception:
                pass
        plane = _control._current
        if plane is not None:
            try:
                plane.kv_del(FLEET_KV_PREFIX + self.name)
            except Exception as exc:  # best effort at teardown
                telemetry.note_swallowed("fleet_close", exc)
        with self._lock:
            for pub_id, ev in list(self._events.items()):
                if pub_id not in self._results:
                    self._results[pub_id] = {"error": "server closed",
                                             "finish_reason": "closed"}
                ev.set()

    shutdown = close

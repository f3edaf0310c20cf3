"""Decode replicas in processes of their own (counterpart of
ray_tpu/llm/fleet/remote.py).

Two classes:

* :class:`ReplicaHost`: the actor body (a process actor of
  ``ray_tpu_torch._actor``).  It owns a
  :class:`~ray_tpu_torch.llm.fleet.replica.DecodeReplica` and buffers its
  finishes for the handle to drain (callbacks cannot cross processes),
  shipping TTFT and inter-token gaps as durations, not clock readings.
* :class:`RemoteReplica`: the FleetServer-side handle, duck-typed to
  DecodeReplica's router surface (``accepting`` / ``import_prefill`` /
  ``try_serve_cached`` / ``load_stats`` / ``summary`` / ``drain`` /
  ``kill``).  A poll thread drains finishes into the fleet's
  ``on_finish`` callback and keeps a load/summary snapshot, so routing
  never waits on the replica (nor on its engine's lock); a dead actor
  turns the handle ``dead`` and the fleet manager sheds and backfills.

A handoff reaches the replica as an object-store descriptor
(:func:`~ray_tpu_torch.llm.disagg.export_handoff`), never by value: K/V on
the card cross as CUDA IPC handles and the replica's scatter reads the
prefill's memory in place; host K/V cross through shared memory.  The
replica answers ``import_prefill`` only once its scatter (and the prefix
cache's own copy) has finished on the device, so the exporter may release
the blob as soon as the answer arrives.

The actor imports its class and ``build_params`` by reference: a
module-level function or a ``functools.partial`` of one, and a
module-level ``ReplicaHost`` subclass (``host_cls``).
"""

from __future__ import annotations

import threading
import time
import weakref
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence

from ... import _actor
from ... import _object_store
from ..disagg.handoff import export_handoff, import_handoff
from .replica import (STATE_ACTIVE, STATE_DEAD, STATE_DRAINING,
                      DecodeReplica)

#: Seconds a new replica may take to build its engine (a spawned
#: interpreter importing torch, reaching the card, building the weights).
START_TIMEOUT_S = 600.0


class ReplicaHost:
    """Actor body hosting one DecodeReplica."""

    def __init__(self, build_params, name: str,
                 engine_options: Optional[Dict[str, Any]] = None,
                 cache_capacity_bytes: int = 64 * 1024 * 1024,
                 record_token_times: bool = False):
        self._lock = threading.Lock()
        self._finished: List[Dict[str, Any]] = []
        self._replica = DecodeReplica(
            build_params, name=name, engine_options=engine_options,
            cache_capacity_bytes=cache_capacity_bytes,
            record_token_times=record_token_times,
            on_finish=self._buffer)

    def ping(self) -> str:
        return "ok"

    def _buffer(self, _replica, req) -> None:
        with self._lock:
            self._finished.append({
                "rid": req.request_id,
                "output_tokens": list(req.output_tokens),
                "finish_reason": req.finish_reason,
                # perf_counter readings are process-local: ship durations.
                "ttft_s": (req.t_first - req.t_submit)
                if req.t_first and req.t_submit else None,
                "itl_s": [b - a for a, b in zip(req.token_times,
                                                req.token_times[1:])],
            })

    def import_prefill(self, desc: tuple, retain: bool = True
                       ) -> Optional[int]:
        """Open the exported handoff, join it to the batch, and return
        only once the device has read it (the scatter, and the cache's
        copy, run on the engine's stream): the exporter releases the blob
        when this answers."""
        handoff, keepalive = import_handoff(desc)
        try:
            rid = self._replica.import_prefill(handoff, retain=retain)
            stream = self._replica.engine.stream
            if stream is not None:
                import torch
                done = torch.cuda.Event()
                done.record(stream)
                done.synchronize()
        finally:
            del handoff, keepalive
        return rid

    def try_serve_cached(self, prompt_tokens, params,
                         age_s: float = 0.0) -> Optional[int]:
        """``age_s``: seconds since the caller's submit (its clock is not
        this process's), so the replay's TTFT counts the time before."""
        return self._replica.try_serve_cached(
            prompt_tokens, params, t_submit=time.perf_counter() - age_s)

    def cancel(self, rid: int) -> None:
        self._replica.cancel(rid)

    def snapshot(self) -> Dict[str, Any]:
        return {"load": self._replica.load_stats(),
                "summary": self._replica.summary(),
                "state": self._replica.state,
                "idle": self._replica.idle()}

    def drain_finished(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = self._finished
            self._finished = []
        return out

    def drain(self) -> None:
        self._replica.drain()

    def kill(self) -> List[int]:
        return self._replica.kill()


class RemoteReplica:
    """FleetServer-side handle on a :class:`ReplicaHost` actor.

    ``actor_options`` are the actor's (``_actor`` options: ``device``,
    ``env_vars``, ...).  Handoffs are exported to this process's default
    store.  The constructor returns once the replica has built its
    engine."""

    def __init__(self, build_params, *, name: str,
                 engine_options: Optional[Dict[str, Any]] = None,
                 cache_capacity_bytes: int = 64 * 1024 * 1024,
                 record_token_times: bool = False,
                 on_finish=None, num_cpus: int = 1,
                 poll_interval_s: float = 0.02,
                 host_cls: type = ReplicaHost,
                 actor_options: Optional[Dict[str, Any]] = None):
        self.name = name
        self._on_finish = on_finish
        self._store = _object_store.default_store()
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 4)
        opts.setdefault("num_cpus", num_cpus)
        #: The ReplicaHost actor (its other methods, e.g. a subclass's).
        self.actor = _actor.remote(host_cls).options(**opts).remote(
            build_params, name, engine_options, cache_capacity_bytes,
            record_token_times)
        try:
            _actor.get(self.actor.ping.remote(), timeout=START_TIMEOUT_S)
        except BaseException:
            _actor.kill(self.actor)
            raise
        self._state = STATE_ACTIVE
        self._snap: Dict[str, Any] = {"load": {}, "summary": None,
                                      "idle": False}
        self._snap_lock = threading.Lock()
        #: One export per handoff object across import retries: the
        #: dispatcher re-attempts the same object under backpressure.
        #: Keyed by a WEAK reference to the handoff (not id()): a dead
        #: weakref never compares equal to a new object, so an address
        #: reused by a later handoff cannot send a stale descriptor.
        self._put_cache: tuple = (None, None, None)  # (weakref, oid, desc)
        self._put_lock = threading.Lock()
        self._stop = threading.Event()
        self._poll = poll_interval_s
        self._poller = threading.Thread(
            target=self._poll_loop, name=f"fleet-remote-{name}",
            daemon=True)
        self._poller.start()

    # -- router surface (DecodeReplica-compatible) --------------------------

    @property
    def state(self) -> str:
        return self._state

    @property
    def accepting(self) -> bool:
        return self._state == STATE_ACTIVE

    def _handoff_desc(self, handoff) -> Optional[tuple]:
        """The cached export of ``handoff``, or a new one (releasing the
        previous handoff's); None when the store is full."""
        cached_wr, oid, desc = self._put_cache
        if cached_wr is not None and cached_wr() is handoff:
            return desc
        self._release_cached()
        oid = _object_store.new_object_id()
        desc = export_handoff(self._store, oid, handoff)
        if desc is not None:
            self._put_cache = (weakref.ref(handoff), oid, desc)
        return desc

    def _release_cached(self) -> None:
        _wr, oid, _desc = self._put_cache
        self._put_cache = (None, None, None)
        if oid is not None:
            _object_store.release_page_blob(self._store, oid)

    def import_prefill(self, handoff, retain: bool = True
                       ) -> Optional[int]:
        """None: backpressure (the replica has no room, or the store is
        full) or not accepting; the dispatcher retries or re-routes."""
        if not self.accepting:
            return None
        with self._put_lock:
            desc = self._handoff_desc(handoff)
            if desc is None:
                return None
            try:
                rid = _actor.get(self.actor.import_prefill.remote(
                    desc, retain))
            except _actor.RayTpuError:
                # The replica died (or raised) holding none of the shares
                # this call sent: release them with the blob.
                _object_store.settle_sends(desc, delivered=False)
                self._state = STATE_DEAD
                self._release_cached()
                return None
            _object_store.settle_sends(desc, delivered=True)
            if rid is not None:
                # The replica has read it on the device: release now.
                self._release_cached()
        return rid

    def try_serve_cached(self, prompt_tokens: Sequence[int], params,
                         t_submit: float = 0.0) -> Optional[int]:
        if not self.accepting or params.temperature > 0.0:
            return None
        with self._snap_lock:
            summ = self._snap.get("summary")
        if not summ:
            return None
        age = time.perf_counter() - t_submit if t_submit else 0.0
        try:
            return _actor.get(self.actor.try_serve_cached.remote(
                list(prompt_tokens), params, age))
        except _actor.RayTpuError:
            self._state = STATE_DEAD
            return None

    def cancel(self, rid: int) -> None:
        # Fire and forget: a dead actor's error lands in the unread ref.
        self.actor.cancel.remote(rid)

    def load_stats(self) -> Dict[str, Any]:
        with self._snap_lock:
            load = dict(self._snap.get("load") or {})
        load.setdefault("name", self.name)
        load.setdefault("state", self._state)
        load.setdefault("ongoing", 0)
        load.setdefault("kv_occupancy", 0.0)
        load.setdefault("waiting", 0)
        return load

    def summary(self):
        with self._snap_lock:
            return self._snap.get("summary")

    def idle(self) -> bool:
        with self._snap_lock:
            return bool(self._snap.get("idle"))

    @property
    def engine(self):
        """Depth accounting shim: ``FleetServer.scale_down`` reads
        ``len(rep.engine.running)``; the cached ongoing count, in that
        shape."""
        with self._snap_lock:
            n = int((self._snap.get("load") or {}).get("ongoing", 0))
        return SimpleNamespace(running=list(range(n)))

    # -- poll (finishes + snapshot) -----------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self._poll)
            if self._stop.is_set():
                return
            try:
                done = _actor.get(self.actor.drain_finished.remote())
                snap = _actor.get(self.actor.snapshot.remote())
            except _actor.RayTpuError:
                # The actor is gone (killed, crashed): stop polling; the
                # fleet manager reaps dead replicas and sheds in-flight.
                self._state = STATE_DEAD
                return
            with self._snap_lock:
                self._snap = snap
            if self._state != STATE_DEAD \
                    and snap.get("state") == STATE_DRAINING:
                self._state = STATE_DRAINING
            for rec in done:
                if self._on_finish is not None:
                    self._on_finish(self, _as_request(rec))

    # -- lifecycle ----------------------------------------------------------

    def drain(self) -> None:
        if self._state == STATE_ACTIVE:
            self._state = STATE_DRAINING
            self.actor.drain.remote()

    def kill(self, timeout_s: float = 5.0) -> List[int]:
        self._state = STATE_DEAD
        self._stop.set()
        if self._poller is not threading.current_thread():
            self._poller.join(timeout_s)
        lost: List[int] = []
        try:
            lost = _actor.get(self.actor.kill.remote(), timeout=timeout_s)
        except _actor.RayTpuError:
            pass
        _actor.kill(self.actor)
        with self._put_lock:
            self._release_cached()
        return lost

    close = kill


def _as_request(rec: Dict[str, Any]):
    """One drained finish record shaped like an engine Request for the
    fleet's ``on_finish``: the stamps are re-anchored on this process's
    clock (only their differences, TTFT and the gaps, are meaningful)."""
    now = time.perf_counter()
    times = [now]
    for d in rec.get("itl_s") or []:
        times.append(times[-1] + d)
    ttft = rec.get("ttft_s")
    return SimpleNamespace(
        request_id=rec["rid"],
        output_tokens=rec.get("output_tokens") or [],
        finish_reason=rec.get("finish_reason", ""),
        t_submit=now - ttft if ttft is not None else 0.0,
        t_first=now if ttft is not None else 0.0,
        token_times=times if len(times) > 1 else [])

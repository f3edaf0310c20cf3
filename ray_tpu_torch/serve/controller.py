"""Serve controller: reconciliation and autoscaling (counterpart of
ray_tpu/serve/controller.py's ``AutoscalingConfig`` and
``ServeController``).

Reference: the ServeController's update loops (deployment_state.py:2795 —
reconcile target vs running replicas, recover dead ones) and request-based
autoscaling (serve/autoscaling_policy.py + _private/autoscaling_state.py —
desired = total ongoing requests / target per replica, clamped, with up-
and downscale delays).

The controller is a thread of the process that calls ``serve.run`` (JAX
runs the same thread inside its ``SERVE_CONTROLLER`` actor); it owns the
replica actors.  Each pass it drops replicas whose process died, moves the
autoscaling target, starts or drains replicas until the running set
matches it (backfill backs off exponentially while replicas fail to
start), and publishes versioned replica-set snapshots under
``REPLICA_KV_PREFIX`` to the ``_control.py`` store, where routers in any
process that reaches the store read them.  Routers report their in-flight
counts: the one in this process is read directly, routers elsewhere write
them under ``METRICS_KV_PREFIX``.

Node-drain evacuation (JAX's ``_evacuate_draining``) needs a node table
the port does not have: it raises, naming ROADMAP item 3(c).
"""

from __future__ import annotations

import math
import pickle
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Dict, Optional

from .. import _actor

REPLICA_KV_PREFIX = "serve:replicas:"
#: + deployment + "/" + router id -> pickle((wall time, {replica: n})).
METRICS_KV_PREFIX = "serve:metrics:"
#: Seconds a router's report counts toward a replica's load.
METRICS_FRESH_S = 5.0


@dataclass
class AutoscalingConfig:
    """reference: serve/config.py AutoscalingConfig."""
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 1.0
    downscale_delay_s: float = 5.0


#: The JAX package's controller actor's name.  Here the controller is a
#: thread of the process calling ``serve.run`` (ROADMAP 6c.3), but the
#: name stays declared session-lifetime to the leak sanitizer, as JAX's.
CONTROLLER_NAME = "SERVE_CONTROLLER"
CONTROLLER_NAMESPACE = "serve"


class ServeController:
    """Reconciles deployments to their targets (self-healing +
    autoscale)."""

    def __init__(self, deployments: Dict, app_lock: threading.Lock,
                 interval_s: float = 0.25):
        self.deployments = deployments  # name -> _DeploymentState (live)
        self._app_lock = app_lock
        self.interval_s = interval_s
        self._stop = threading.Event()
        # Autoscaling decision memory: name -> (direction, since_ts)
        self._pending_scale: Dict[str, tuple] = {}
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-controller", daemon=True)
        self._thread.start()

    def _reports(self, name: str):
        """Fresh router reports ({replica actor id: in-flight}): this
        process's router, read live, and those the store holds."""
        now = time.monotonic()   # the routers' stamps (one host's clock)
        reports = {}
        plane = _actor._plane()
        prefix = f"{METRICS_KV_PREFIX}{name}/"
        for key in plane.kv_keys(prefix):
            blob = plane.kv_get(key)
            if blob is not None:
                reports[key[len(prefix):]] = pickle.loads(blob)
        from .api import _local_router_counts
        local = _local_router_counts(name)
        if local is not None:
            reports[local[0]] = (now, local[1])
        return [counts for ts, counts in reports.values()
                if now - ts < METRICS_FRESH_S]

    def _replica_loads(self, state) -> Dict[str, int]:
        """Aggregated fresh per-replica in-flight across routers."""
        loads: Dict[str, int] = {}
        for counts in self._reports(state.deployment.name):
            for rid, n in counts.items():
                loads[rid] = loads.get(rid, 0) + n
        return loads

    def _ongoing(self, state) -> int:
        """Total in-flight requests across routers' fresh reports."""
        return sum(self._replica_loads(state).values())

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    # -- control loop -------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._reconcile_all()
            except Exception:  # noqa: BLE001 - never kill the loop
                traceback.print_exc()

    def _reconcile_all(self) -> None:
        with self._app_lock:
            states = list(self.deployments.values())
        for state in states:
            if state.stopped or self._stop.is_set():
                continue
            self._health_check(state)
            self._autoscale(state)
            self._reconcile(state)

    # -- pieces -------------------------------------------------------------

    def _health_check(self, state) -> None:
        """Drop replicas whose process died (reference: deployment_state
        replica recovery); the reconcile step then backfills."""
        with state._lock:
            dead = [r for r in state.replicas if _actor.is_dead(r)]
            for r in dead:
                state.replicas.remove(r)
        if dead:
            self._publish(state)

    def _autoscale(self, state) -> None:
        cfg: Optional[AutoscalingConfig] = state.deployment.autoscaling_config
        if cfg is None:
            return
        with state._lock:
            n = len(state.replicas)
        if n == 0:
            return
        total_inflight = self._ongoing(state)
        desired = math.ceil(total_inflight / max(cfg.target_ongoing_requests,
                                                 1e-6))
        desired = max(min(desired, cfg.max_replicas), cfg.min_replicas)
        if desired == state.target_replicas:
            self._pending_scale.pop(state.deployment.name, None)
            return
        direction = "up" if desired > state.target_replicas else "down"
        delay = cfg.upscale_delay_s if direction == "up" \
            else cfg.downscale_delay_s
        key = state.deployment.name
        pending = self._pending_scale.get(key)
        now = time.monotonic()
        if pending is None or pending[0] != direction:
            self._pending_scale[key] = (direction, now)
            return
        if now - pending[1] >= delay:
            state.target_replicas = desired
            self._pending_scale.pop(key, None)

    def _reconcile(self, state) -> None:
        """Start/stop replicas until running == target (reference:
        deployment_state.py reconciliation).  Backfill waits for replica
        readiness and backs off exponentially when creation keeps failing
        (no unbounded crash loops)."""
        if state.stopped:
            return
        with state._lock:
            n = len(state.replicas)
            target = state.target_replicas
        changed = False
        now = time.monotonic()
        while n < target and now >= state.backfill_not_before:
            try:
                state.add_replica(wait_ready=True)
                state.backfill_backoff_s = 0.5
                changed = True
            except Exception:  # noqa: BLE001 - retried after the backoff
                state.backfill_not_before = now + state.backfill_backoff_s
                state.backfill_backoff_s = min(
                    state.backfill_backoff_s * 2, 30.0)
                break
            n += 1
        while n > target:
            self._downscale_one(state)
            changed = True
            n -= 1
        if changed:
            self._publish(state)

    def _downscale_one(self, state) -> None:
        """Remove the least-loaded replica WITH draining: unpublish first
        (routers stop sending), wait for its reported in-flight to reach
        zero, then kill (reference: deployment_state drains replicas
        before stopping them)."""
        loads = self._replica_loads(state)
        r = state.pop_replica(min_load=loads)
        if r is None:
            return
        self._publish(state)
        self._drain_and_kill(state, r)

    def _evacuate_draining(self, state, draining: set) -> None:
        """Moving replicas off draining nodes (preemption notices) needs
        the node table the port lacks."""
        raise NotImplementedError(
            "serve node-drain evacuation needs a node table with drain "
            "notices, which the port does not have: ROADMAP item 3(c) "
            "(drain notices)")

    def _drain_and_kill(self, state, r, settle_s: float = 30.0) -> None:
        """Unpublished replica teardown: wait (bounded) for its reported
        in-flight to settle at zero, then kill — on a background thread
        so the control loop keeps reconciling."""
        rid = r._actor_id

        def drain():
            deadline = time.monotonic() + settle_s
            while time.monotonic() < deadline:
                if self._replica_loads(state).get(rid, 0) <= 0:
                    # One extra beat: reports lag the actual completions.
                    time.sleep(0.5)
                    if self._replica_loads(state).get(rid, 0) <= 0:
                        break
                time.sleep(0.2)
            _actor.kill(r)
        from .. import _sanitizer
        _sanitizer.spawn(drain, name="serve-drain")

    def _publish(self, state) -> None:
        with state._lock:
            snapshot = list(state.replicas)
        from ..util import telemetry
        telemetry.set_gauge("ray_tpu_serve_replicas", len(snapshot),
                            tags={"deployment": state.deployment.name})
        # Cross-process push: a versioned replica-set snapshot in the
        # store, from which routers anywhere rebuild handles.  The version
        # is monotonic ACROSS redeploys (read-modify-write against the
        # stored snapshot): a fresh _DeploymentState must not restart at 1
        # or routers elsewhere would skip the new set.
        plane = _actor._plane()
        key = REPLICA_KV_PREFIX + state.deployment.name
        blob = plane.kv_get(key)
        stored = pickle.loads(blob)[0] if blob is not None else 0
        state._version = max(state._version, stored) + 1
        entries = [(r._actor_id, r._class_name,
                    state.deployment.max_ongoing_requests)
                   for r in snapshot]
        plane.kv_put(key, pickle.dumps(
            (state._version, entries, state.multiplex_cap,
             state.deployment.max_queued_requests)))

    @staticmethod
    def clear(name: str) -> None:
        """Drop a stopped deployment's snapshot and router reports."""
        from ..util import telemetry
        telemetry.set_gauge("ray_tpu_serve_replicas", 0,
                            tags={"deployment": name})
        plane = _actor._plane()
        plane.kv_del(REPLICA_KV_PREFIX + name)
        for key in plane.kv_keys(f"{METRICS_KV_PREFIX}{name}/"):
            plane.kv_del(key)

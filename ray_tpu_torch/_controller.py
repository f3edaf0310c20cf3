"""The head's tables (a copy of ``ray_tpu/_private/controller.py``, the
GCS counterpart): nodes, actors with their state machine
(``DEPENDENCIES_UNREADY -> PENDING_CREATION -> ALIVE -> RESTARTING/DEAD``,
restarts counted against ``max_restarts``), named actors per namespace,
placement groups, jobs, a namespaced key-value store with ``kv_wait``, and
pub/sub with ``pubsub_poll``.  Plain in-process tables behind one lock.

The session owns one ``Controller``: the scheduler (``_scheduler``) keeps
its node and placement-group tables here, the actor tier (``_actor``)
registers every actor with its creation spec, and the session's KV verbs
are served from it (``_cluster.serve_rpc``).  With ``init(state_dir=)``
every mutation appends a record to the WAL (``persist``, a
``_persist.StateStore``); ``restore`` replays the records and
``snapshot_records`` compacts them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ._ids import ActorID, JobID, NodeID, PlacementGroupID
from ._protocol import TaskSpec
from ._resources import ResourceSet

# Actor FSM states (reference: gcs_actor_manager.h FSM)
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"

# Placement group states
PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_REMOVED = "REMOVED"


@dataclass
class NodeInfo:
    node_id: NodeID
    hostname: str
    total_resources: ResourceSet
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    is_head: bool = False
    # Drain lifecycle (preemption/maintenance notice): a draining node is
    # unschedulable for new leases and expected to die by the deadline.
    # Monotonic stamps — only comparable inside the head process; readers
    # in other processes get a relative drain_remaining_s via ctl_nodes.
    draining: bool = False
    drain_reason: str = ""
    drain_deadline_mono: float = 0.0
    drain_started_mono: float = 0.0


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: Optional[str]
    state: str
    creation_spec: Optional[TaskSpec]
    max_restarts: int
    num_restarts: int = 0
    node_id: Optional[NodeID] = None
    death_cause: Optional[str] = None
    namespace: str = "default"
    class_name: str = ""


@dataclass
class BundleInfo:
    index: int
    resources: ResourceSet
    node_id: Optional[NodeID] = None  # committed location


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    name: Optional[str]
    strategy: str  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    bundles: List[BundleInfo]
    state: str = PG_PENDING


@dataclass
class JobInfo:
    job_id: JobID
    start_time: float = field(default_factory=time.time)
    end_time: Optional[float] = None
    entrypoint: str = ""


class Controller:
    """In-process GCS-equivalent state store."""

    def __init__(self):
        self._lock = threading.RLock()
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[tuple, ActorID] = {}  # (namespace, name)
        self.placement_groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        self.jobs: Dict[JobID, JobInfo] = {}
        self._kv: Dict[str, Dict[str, bytes]] = {}
        # Writers notify blocked kv_wait readers (no poll loops; the
        # reference's pubsub long-poll analog, reference: pubsub/publisher.h).
        self._kv_cond = threading.Condition(self._lock)
        self._subscribers: Dict[str, List[Callable[[Any], None]]] = {}
        # Long-poll pubsub rings (reference: pubsub/publisher.h buffered
        # per-channel delivery to remote subscribers).
        self._pubsub_cond = threading.Condition()
        self._pubsub_rings: Dict[str, List] = {}
        self._pubsub_seq = 0
        self._pubsub_ring_cap = 1000
        # Persisted node identities a restarted head will accept
        # same-identity re-attaches from (node_id bytes -> (hostname,
        # resources dict, num_tpus)); reference: gcs_init_data.h node
        # table driving raylet re-registration after GCS failover.
        self.revivable_nodes: Dict[bytes, tuple] = {}

    # -- nodes --------------------------------------------------------------

    # Optional sink for structured export events (reference:
    # RayEventRecorder / export_*.proto); set by the Runtime to the
    # session's JSONL writer.  Signature: (source_type, event_dict).
    event_sink: Optional[Callable[[str, Dict[str, Any]], None]] = None

    # Optional durable store (persist.StateStore); set by a Runtime started
    # with a state_dir.  Every table mutation appends a replayable record
    # (reference: GCS writing tables through its StoreClient).
    persist: Optional[Any] = None

    def _p(self, record: tuple) -> None:
        store = self.persist
        if store is not None:
            try:
                store.append(record)
            except Exception:  # noqa: BLE001 — persistence must not break
                pass

    def restore(self, records: List[tuple]) -> None:
        """Rebuild tables from a snapshot+WAL record stream (reference:
        GcsInitData::AsyncLoad rebuilding managers on GCS restart).
        Last record per key wins; node records are never persisted (nodes
        re-register), and replayed bundle placements are reset by the
        Runtime before re-planning."""
        with self._lock:
            for r in records:
                kind = r[0]
                if kind == "actor":
                    info = r[1]
                    self.actors[info.actor_id] = info
                    if info.name:
                        self.named_actors[(info.namespace, info.name)] = \
                            info.actor_id
                elif kind == "pg":
                    self.placement_groups[r[1].pg_id] = r[1]
                elif kind == "job":
                    self.jobs[r[1].job_id] = r[1]
                elif kind == "kv_put":
                    self._kv.setdefault(r[1], {})[r[2]] = r[3]
                elif kind == "kv_del":
                    self._kv.get(r[1], {}).pop(r[2], None)
                elif kind == "node_identity":
                    self.revivable_nodes[r[1]] = r[2]
                elif kind == "node_gone":
                    self.revivable_nodes.pop(r[1], None)

    def snapshot_records(self) -> List[tuple]:
        """Full table state as a compact record stream (for WAL
        compaction)."""
        with self._lock:
            out: List[tuple] = []
            for info in self.actors.values():
                out.append(("actor", info))
            for pg in self.placement_groups.values():
                out.append(("pg", pg))
            for job in self.jobs.values():
                out.append(("job", job))
            for ns, kv in self._kv.items():
                for k, v in kv.items():
                    out.append(("kv_put", ns, k, v))
            for nid, ident in self.revivable_nodes.items():
                out.append(("node_identity", nid, ident))
            return out

    def _export(self, source_type: str, event: Dict[str, Any]) -> None:
        sink = self.event_sink
        if sink is not None:
            try:
                sink(source_type, event)
            except Exception:  # noqa: BLE001 — observability must not break
                pass

    def note_revivable(self, node_id_bytes: bytes, ident: tuple) -> None:
        """Persist a node identity for post-restart re-attach (all
        mutations locked: snapshot_records iterates this table)."""
        with self._lock:
            self.revivable_nodes[node_id_bytes] = ident
        self._p(("node_identity", node_id_bytes, ident))

    def drop_revivable(self, node_id_bytes: bytes) -> None:
        with self._lock:
            self.revivable_nodes.pop(node_id_bytes, None)
        self._p(("node_gone", node_id_bytes))

    def get_revivable(self, node_id_bytes: bytes):
        with self._lock:
            return self.revivable_nodes.get(node_id_bytes)

    def register_node(self, info: NodeInfo) -> None:
        with self._lock:
            self.nodes[info.node_id] = info
        self._export("EXPORT_NODE", {"node_id": info.node_id.hex(),
                                     "state": "ALIVE",
                                     "hostname": info.hostname})
        self.publish("node_added", info)

    def heartbeat(self, node_id: NodeID) -> None:
        with self._lock:
            n = self.nodes.get(node_id)
            if n:
                n.last_heartbeat = time.monotonic()

    def drain_node(self, node_id: NodeID, deadline_s: float = 30.0,
                   reason: str = "preemption") -> bool:
        """Mark a node draining: a preemption/maintenance notice arrived
        and the node is expected to disappear within ``deadline_s``.  The
        scheduler side (making it unschedulable) is wired by the Runtime;
        this records the state and fans the event out."""
        now = time.monotonic()
        with self._lock:
            n = self.nodes.get(node_id)
            if not n or not n.alive:
                return False
            already = n.draining
            n.draining = True
            n.drain_reason = reason
            n.drain_started_mono = n.drain_started_mono if already else now
            n.drain_deadline_mono = now + max(0.0, deadline_s)
        if not already:
            self._export("EXPORT_NODE", {"node_id": node_id.hex(),
                                         "state": "DRAINING",
                                         "reason": reason,
                                         "deadline_s": deadline_s})
            self.publish("node_draining", node_id)
        return True

    def undrain_node(self, node_id: NodeID) -> bool:
        """Cancel a drain (notice withdrawn / chaos experiment over)."""
        with self._lock:
            n = self.nodes.get(node_id)
            if not n or not n.draining:
                return False
            n.draining = False
            n.drain_reason = ""
            n.drain_deadline_mono = 0.0
            n.drain_started_mono = 0.0
        self._export("EXPORT_NODE", {"node_id": node_id.hex(),
                                     "state": "ALIVE",
                                     "reason": "undrain"})
        return True

    def draining_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self.nodes.values()
                    if n.alive and n.draining]

    def mark_node_dead(self, node_id: NodeID, reason: str = "") -> None:
        drained_for: Optional[float] = None
        with self._lock:
            n = self.nodes.get(node_id)
            if not n or not n.alive:
                return
            n.alive = False
            if n.draining:
                drained_for = time.monotonic() - n.drain_started_mono
                n.draining = False
        if drained_for is not None:
            # How much of the advertised deadline the cluster actually
            # got between the notice and the node vanishing.
            from .util import telemetry
            telemetry.observe("ray_tpu_node_drain_seconds", drained_for)
        self._export("EXPORT_NODE", {"node_id": node_id.hex(),
                                     "state": "DEAD", "reason": reason})
        self.publish("node_removed", node_id)

    def alive_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self.nodes.values() if n.alive]

    # -- jobs ---------------------------------------------------------------

    def register_job(self, info: JobInfo) -> None:
        with self._lock:
            self.jobs[info.job_id] = info
        self._p(("job", info))

    def finish_job(self, job_id: JobID) -> None:
        with self._lock:
            j = self.jobs.get(job_id)
            if j:
                j.end_time = time.time()
        if j:
            self._p(("job", j))

    # -- actors -------------------------------------------------------------

    def register_actor(self, info: ActorInfo) -> None:
        with self._lock:
            self.actors[info.actor_id] = info
            if info.name:
                key = (info.namespace, info.name)
                if key in self.named_actors:
                    existing = self.actors.get(self.named_actors[key])
                    if existing and existing.state != DEAD:
                        raise ValueError(
                            f"actor name {info.name!r} already taken in "
                            f"namespace {info.namespace!r}")
                self.named_actors[key] = info.actor_id
        self._p(("actor", info))

    def set_actor_state(self, actor_id: ActorID, state: str,
                        node_id: Optional[NodeID] = None,
                        death_cause: Optional[str] = None) -> None:
        with self._lock:
            a = self.actors.get(actor_id)
            if not a:
                return
            a.state = state
            if node_id is not None:
                a.node_id = node_id
            if death_cause is not None:
                a.death_cause = death_cause
        self._p(("actor", a))
        self._export("EXPORT_ACTOR", {"actor_id": actor_id.hex(),
                                      "state": state,
                                      "death_cause": death_cause})
        self.publish("actor_state", (actor_id, state))

    def get_actor(self, actor_id: ActorID) -> Optional[ActorInfo]:
        with self._lock:
            return self.actors.get(actor_id)

    def get_named_actor(self, name: str, namespace: str = "default") -> Optional[ActorInfo]:
        with self._lock:
            aid = self.named_actors.get((namespace, name))
            return self.actors.get(aid) if aid else None

    def on_node_death_actors(self, node_id: NodeID) -> List[ActorInfo]:
        """Actors that were living on a dead node (restart candidates)."""
        with self._lock:
            return [a for a in self.actors.values()
                    if a.node_id == node_id and a.state in (ALIVE, PENDING_CREATION)]

    # -- placement groups ---------------------------------------------------

    def register_placement_group(self, info: PlacementGroupInfo) -> None:
        with self._lock:
            self.placement_groups[info.pg_id] = info
        self._p(("pg", info))

    def set_pg_state(self, pg_id: PlacementGroupID, state: str) -> None:
        with self._lock:
            pg = self.placement_groups.get(pg_id)
            if pg:
                pg.state = state
        if pg:
            self._p(("pg", pg))
        self.publish("pg_state", (pg_id, state))

    def get_placement_group(self, pg_id: PlacementGroupID) -> Optional[PlacementGroupInfo]:
        with self._lock:
            return self.placement_groups.get(pg_id)

    # -- internal KV (reference: gcs_kv_manager.h) --------------------------

    def kv_put(self, key: str, value: bytes, namespace: str = "default",
               overwrite: bool = True) -> bool:
        with self._lock:
            ns = self._kv.setdefault(namespace, {})
            if not overwrite and key in ns:
                return False
            ns[key] = value
            self._kv_cond.notify_all()
        self._p(("kv_put", namespace, key, value))
        return True

    def kv_wait(self, key: str, namespace: str = "default",
                timeout: Optional[float] = None) -> Optional[bytes]:
        """Block until ``key`` exists (or timeout); returns its value.

        Event-driven replacement for client-side poll loops (collective
        rendezvous, p2p handshakes)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._kv_cond:
            while True:
                v = self._kv.get(namespace, {}).get(key)
                if v is not None:
                    return v
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._kv_cond.wait(remaining)

    def kv_get(self, key: str, namespace: str = "default") -> Optional[bytes]:
        with self._lock:
            return self._kv.get(namespace, {}).get(key)

    def kv_del(self, key: str, namespace: str = "default") -> bool:
        with self._lock:
            existed = self._kv.get(namespace, {}).pop(key, None) is not None
        if existed:
            self._p(("kv_del", namespace, key))
        return existed

    def kv_keys(self, prefix: str = "", namespace: str = "default") -> List[str]:
        with self._lock:
            return [k for k in self._kv.get(namespace, {}) if k.startswith(prefix)]

    # -- pubsub (reference: src/ray/pubsub/publisher.h) ---------------------

    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        with self._lock:
            self._subscribers.setdefault(channel, []).append(callback)

    def publish(self, channel: str, message: Any) -> None:
        with self._lock:
            subs = list(self._subscribers.get(channel, []))
        # Long-poll ring (reference: pubsub/publisher.h:356 — per-entity
        # buffered long-poll delivery): remote subscribers (workers,
        # clients, nodes) poll with their last-seen sequence number.
        with self._pubsub_cond:
            self._pubsub_seq += 1
            ring = self._pubsub_rings.setdefault(channel, [])
            ring.append((self._pubsub_seq, message))
            if len(ring) > self._pubsub_ring_cap:
                del ring[: len(ring) - self._pubsub_ring_cap]
            self._pubsub_cond.notify_all()
        for cb in subs:
            try:
                cb(message)
            except Exception:
                pass

    def pubsub_poll(self, channel: str, after_seq: int = 0,
                    timeout: Optional[float] = None):
        """Blocking long-poll: messages on ``channel`` with seq >
        after_seq, waking on publish (no client poll loop).  Returns
        (last_seq, [messages]); ([], after_seq) on timeout.  A subscriber
        that falls more than the ring size behind silently misses the
        overwritten messages (the reference's long-poll has the same
        bounded-buffer semantics)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._pubsub_cond:
            while True:
                ring = self._pubsub_rings.get(channel, [])
                fresh = [(s, m) for s, m in ring if s > after_seq]
                if fresh:
                    return fresh[-1][0], [m for _, m in fresh]
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    # Return the GLOBAL sequence head: no message on this
                    # channel can have a seq <= it that wasn't already in
                    # the ring (checked under this lock), so resuming from
                    # here never skips — and lets "subscribe from now"
                    # learn the head with a zero-timeout poll.
                    return self._pubsub_seq, []
                self._pubsub_cond.wait(remaining)

"""The scheduler tier over the host and the nodes that join it (the
counterpart of
``ray_tpu/_private/scheduler.py``'s ``ClusterScheduler``, with
``node.py``'s card grant).  Its node and placement-group tables are the
session's ``_controller.Controller``; its specs are ``_protocol.TaskSpec``.

``ClusterScheduler`` is a copy of JAX's: tasks enter a dependency stage,
move to a ready queue bucketed by scheduling class, and a policy (hybrid
pack-then-spread, ``"SPREAD"``, ``NodeAffinitySchedulingStrategy``) picks
the node and books its resources; placement groups reserve bundles under
``PACK``, ``SPREAD``, ``STRICT_PACK`` or ``STRICT_SPREAD`` by a two-phase
commit and stay ``PENDING`` until they fit; a shape no node's total could
ever hold is parked on the infeasible list.  Every decision lands in the
``schedview`` ring, and the ``ray_tpu_sched_*`` series are JAX's.  The
node plane (``_cluster``, ``_runtime``) adds the nodes that join
(``add_node``), takes a dead one out (``remove_node``) and plans its
bundles again (``reschedule_lost_bundles``); a task with a hard affinity
to a dead node stays queued, as in JAX.  Pipelined submission
(``try_pipeline``: a plain CPU task queued ahead on a busy worker of a
node, no booking) and lease reuse (``exchange_finished``) are the head
runtime's.  Left out with the parts of JAX that call them: the drain
fence (ROADMAP Queue 1 item 13 part 3's drain notices) and the
autoscaler's demand feeds (item 14).

``Node`` is the host as the scheduler's one node.  It advertises ``CPU``
(the session's ``num_cpus``), ``memory``, ``GPU`` (its cards: ``num_tpus``
or what ``accelerators.cuda`` detects) and any custom resources, and owns
the card pool: a task or actor booked with whole cards gets exactly those
card ids, pinned by the manager's ``visibility_env`` (JAX:
``node.py:640-650``); a retried task is placed anew and gets a fresh grant.
``init()``'s session has one; with no session, ``TorchTrainer`` books its
workers on a node of its own over the host's cores and cards
(``node_for_run``), stopped when the fit ends.

The API of ``ray_tpu/_private/api.py:619-684`` comes across here:
``placement_group``, ``PlacementGroup.ready``/``bundle_locations``,
``remove_placement_group``, ``cluster_resources``,
``available_resources`` and ``nodes`` (``get_actor`` is ``_actor``'s).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import random
import socket
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ._config import Config
from ._controller import (PG_CREATED, PG_PENDING, PG_REMOVED, BundleInfo,
                          Controller, NodeInfo, PlacementGroupInfo)
from ._ids import JobID, NodeID, ObjectID, PlacementGroupID, TaskID
from ._protocol import TaskSpec
from ._resources import CPU, GPU, MEMORY, ResourceSet
from .accelerators.accelerator import all_accelerators, get_accelerator
from .schedview import decisions as _dec
from .util import telemetry

PACK = "PACK"
SPREAD = "SPREAD"
STRICT_PACK = "STRICT_PACK"
STRICT_SPREAD = "STRICT_SPREAD"


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: "NodeID"
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object  # PlacementGroup handle or PlacementGroupID
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class _PendingTask:
    spec: TaskSpec
    unresolved: Set[ObjectID]
    dispatch: Callable[[TaskSpec, NodeID], None]
    key: Any = None  # scheduling-class key (computed once at submit)
    attempts: int = 0  # failed placement rounds before this one


@dataclass
class _NodeState:
    info: NodeInfo
    available: ResourceSet
    # Per-PG-bundle reserved-and-still-free resources.
    bundle_available: Dict[Tuple[PlacementGroupID, int], ResourceSet] = field(
        default_factory=dict)


class Infeasible(Exception):
    """No alive node could ever satisfy the request."""


class ClusterScheduler:
    def __init__(self, controller: Controller,
                 object_ready: Callable[[ObjectID], bool]):
        self._controller = controller
        self._object_ready = object_ready
        self._lock = threading.RLock()
        self._nodes: Dict[NodeID, _NodeState] = {}
        # Ready tasks bucketed by scheduling class (reference: SchedulingKey
        # grouping in normal_task_submitter.h): each wake visits classes,
        # not tasks, so a full queue behind exhausted resources costs
        # O(classes) per pass instead of O(tasks).
        self._ready: "dict[Any, deque]" = {}
        self._ready_count = 0
        self._waiting: Dict[ObjectID, List[_PendingTask]] = defaultdict(list)
        self._infeasible: List[_PendingTask] = []
        # Draining nodes (preemption notice): unschedulable for NEW
        # leases/bundles.  Drain notices are not ported (ROADMAP Queue 1
        # item 13): the set stays empty, and its checks are JAX's.
        self._draining: Set[NodeID] = set()
        self._wake = threading.Condition(self._lock)
        self._running = True
        self._spread_rr = 0
        self._pending_pgs: List[PlacementGroupInfo] = []
        # Set by the node: called with (spec, exc) when dispatch blows up.
        self.on_dispatch_error: Optional[Callable] = None
        # Set by the head's runtime once nodes join: called with a spec
        # the cluster has no room for; True when it queued the task ahead
        # on a busy worker of a node (pipelined submission: no booking).
        self.try_pipeline: Optional[Callable] = None
        # Every placement decision lands in this bounded ring (schedview).
        self.ring = _dec.DecisionRing(Config.get("sched_decision_ring_size"))
        self._pg_created_mono: Dict[PlacementGroupID, float] = {}
        # Metrics publisher state (rate-limited; hot paths only bump
        # plain ints/lists, the loop flushes into telemetry off-lock).
        self._attempt_samples: List[int] = []
        self._published_counts: Dict[str, int] = {}
        self._publish_next_mono = 0.0
        self._publish_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, name="scheduler",
                                        daemon=True)
        self._thread.start()

    # -- node lifecycle -----------------------------------------------------

    def add_node(self, info: NodeInfo) -> None:
        with self._wake:
            self._nodes[info.node_id] = _NodeState(info, info.total_resources.copy())
            # Newly added capacity may unblock infeasible tasks.
            for t in self._infeasible:
                self._push_ready_locked(t)
            self._infeasible.clear()
            self._wake.notify_all()

    def remove_node(self, node_id: NodeID) -> None:
        """A node died: it takes no more placements (its bookings go with
        it; tasks pinned to it by a hard affinity fail at their next
        placement round)."""
        with self._wake:
            self._nodes.pop(node_id, None)
            self._draining.discard(node_id)
            self._wake.notify_all()

    def available_resources(self) -> Dict[str, float]:
        """Schedulable capacity: draining nodes are excluded — their
        resources are about to vanish, and counting them would make
        elastic policies / the autoscaler size work onto a doomed host."""
        with self._lock:
            total = ResourceSet()
            for ns in self._nodes.values():
                if ns.info.node_id in self._draining:
                    continue
                total = total + ns.available
            return total.to_dict()

    def total_resources(self) -> Dict[str, float]:
        with self._lock:
            total = ResourceSet()
            for ns in self._nodes.values():
                total = total + ns.info.total_resources
            return total.to_dict()

    # -- task intake --------------------------------------------------------

    def submit(self, spec: TaskSpec,
               dispatch: Callable[[TaskSpec, NodeID], None]) -> None:
        deps = {a[1] for a in spec.arg_descs if a[0] == "ref"}
        deps |= {d[1] for d in spec.kwarg_descs.values() if d[0] == "ref"}
        # Readiness must be checked under the scheduler lock: an object can
        # become ready between the check and registration, and
        # notify_object_ready (which holds the same lock) would then have
        # already fired, stranding the task in _waiting forever.
        inline_node: Optional[NodeID] = None
        pipeline_ok = False
        trace = _dec.enabled()
        info: Optional[Dict[str, Any]] = {} if trace else None
        with self._wake:
            unresolved = {d for d in deps if not self._object_ready(d)}
            if not unresolved and not self._ready_count \
                    and not self._pending_pgs:
                # Submit-time fast path: with an empty queue, place and
                # book right here and dispatch on the caller's thread.
                inline_node = self._try_place(spec, info)
                if inline_node is None and self.try_pipeline is not None \
                        and self._pipelineable(spec):
                    pipeline_ok = True      # attempted outside the lock
            if inline_node is None and not pipeline_ok:
                self._queue_task_locked(spec, dispatch, unresolved)
        if pipeline_ok:
            if not self.try_pipeline(spec):
                with self._wake:
                    self._queue_task_locked(spec, dispatch, set())
            return
        if inline_node is not None:
            if trace:
                self.ring.push(_dec.K_INLINE, spec.task_id.hex(), spec.name,
                               (spec.resources, spec.placement_group,
                                spec.bundle_index,
                                spec.scheduling_strategy),
                               info.get("candidates", 1),
                               info.get("rejected"), inline_node.hex(), 1)
            self._dispatch_safely(spec, dispatch, inline_node)

    @staticmethod
    def _pipelineable(spec: TaskSpec) -> bool:
        """Plain CPU-only tasks can queue ahead on a busy worker: execution
        stays serial per worker, so parallelism remains bounded by the
        booked capacity."""
        return (spec.placement_group is None
                and spec.scheduling_strategy is None
                and spec.runtime_env is None
                and spec.actor_id is None and spec.create_actor_id is None
                and all(k == CPU for k in spec.resources.keys()))

    def _queue_task_locked(self, spec: TaskSpec, dispatch,
                           unresolved: Set[ObjectID]) -> None:
        task = _PendingTask(spec, unresolved, dispatch,
                            self._sched_key(spec))
        if unresolved:
            for d in unresolved:
                self._waiting[d].append(task)
        else:
            self._push_ready_locked(task)
            # Wake the loop only when the task has a chance of placing
            # right now: with every worker busy, the wakeup is a pure GIL
            # handoff per submit (measured ~100us each at 2k submits/s)
            # and release() will wake the loop anyway when capacity frees.
            # Both paths hold this lock, so the check-then-notify cannot
            # miss a concurrent release.
            if self._capacity_hint(spec):
                self._wake.notify_all()

    def _dispatch_safely(self, spec: TaskSpec, dispatch, node_id: NodeID):
        try:
            dispatch(spec, node_id)
        except Exception as exc:
            # Undo the resource deduction and surface the error; silently
            # dropping would leak capacity and hang get().
            self.release(node_id, spec.resources, spec.placement_group,
                         spec.bundle_index)
            if self.on_dispatch_error is not None:
                try:
                    self.on_dispatch_error(spec, exc)
                except Exception as e:
                    telemetry.note_swallowed("scheduler.on_dispatch_error", e)

    def _capacity_hint(self, spec: TaskSpec) -> bool:
        """Cheap may-fit check (false negatives are latency-free thanks to
        release()'s notify; when unsure, say yes)."""
        need = spec.resources
        if spec.placement_group is not None:
            return True
        for ns in self._nodes.values():
            if ns.info.node_id not in self._draining and \
                    need.fits(ns.available):
                return True
        return False

    def _push_ready_locked(self, task: _PendingTask) -> None:
        if task.key is None:
            task.key = self._sched_key(task.spec)
        self._ready.setdefault(task.key, deque()).append(task)
        self._ready_count += 1

    def notify_object_ready(self, object_id: ObjectID) -> None:
        with self._wake:
            tasks = self._waiting.pop(object_id, [])
            moved = False
            for t in tasks:
                t.unresolved.discard(object_id)
                if not t.unresolved:
                    self._push_ready_locked(t)
                    moved = True
            if moved:
                self._wake.notify_all()

    def release(self, node_id: NodeID, resources: ResourceSet,
                pg: Optional[PlacementGroupID] = None,
                bundle_index: int = -1) -> None:
        with self._wake:
            ns = self._nodes.get(node_id)
            if ns is None:
                return
            if pg is not None:
                key = (pg, bundle_index) if bundle_index >= 0 else None
                if key is not None and key in ns.bundle_available:
                    ns.bundle_available[key] = ns.bundle_available[key] + resources
                else:
                    # PG was removed while the task ran: resources go back to
                    # the node's main pool.
                    ns.available = ns.available + resources
            else:
                ns.available = ns.available + resources
            self._wake.notify_all()

    # -- scheduling loop ----------------------------------------------------

    @staticmethod
    def _sched_key(spec: TaskSpec):
        """Scheduling-class key (reference: SchedulingKey in
        normal_task_submitter.h): tasks with identical resource shape,
        placement target and strategy place identically, so one failed
        placement disqualifies the whole class for this round — turning the
        O(queue) rescan per wake into O(distinct classes)."""
        res = tuple(sorted(spec.resources.to_dict().items()))
        strat = spec.scheduling_strategy
        if isinstance(strat, NodeAffinitySchedulingStrategy):
            strat = ("affinity", strat.node_id, strat.soft)
        return (res, spec.placement_group, spec.bundle_index, strat)

    def _loop(self) -> None:
        info: Dict[str, Any] = {}  # reused per placement attempt
        while True:
            # Phase 1 (locked): pick placements and deduct resources.
            # Phase 2 (unlocked): run the dispatches — arg resolution,
            # spec pickling and the worker-pipe send are the expensive
            # part, and holding the condvar through them would serialize
            # every submit/release/notify in the system behind each
            # dispatch (measured: ~770us average lock wait in the async
            # task microbenchmark before this split).
            to_dispatch = []
            with self._wake:
                while self._running and not self._ready_count:
                    self._retry_pending_pgs_locked()
                    self._wake.wait(timeout=0.5)
                if not self._running:
                    return
                self._retry_pending_pgs_locked()
                trace = _dec.enabled()
                for key in list(self._ready):
                    bucket = self._ready.get(key)
                    while bucket:
                        task = bucket[0]
                        info.clear()
                        node_id = self._try_place(task.spec, info)
                        if node_id is None:
                            task.attempts += 1
                            if trace:
                                self.ring.push(
                                    _dec.K_REJECT, task.spec.task_id.hex(),
                                    task.spec.name, key,
                                    info.get("candidates", 0),
                                    dict(info.get("rejected") or {}),
                                    None, task.attempts)
                            if info.get("infeasible"):
                                # Park the whole class: no node's TOTAL
                                # resources could ever satisfy it, so
                                # rescanning it every wake is pure
                                # overhead.  add_node revives parked
                                # tasks (new capacity may fit them).
                                if trace:
                                    self.ring.push(
                                        _dec.K_INFEASIBLE,
                                        task.spec.task_id.hex(),
                                        task.spec.name, key, 0,
                                        {_dec.R_INFEASIBLE:
                                         max(1, len(self._nodes))},
                                        None, task.attempts)
                                self._infeasible.extend(bucket)
                                self._ready_count -= len(bucket)
                                bucket.clear()
                            break  # whole class blocked this round
                        task.attempts += 1
                        bucket.popleft()
                        self._ready_count -= 1
                        to_dispatch.append((task, node_id,
                                            info.get("candidates", 1)))
                    if not bucket:
                        self._ready.pop(key, None)
                if self._ready_count and not to_dispatch:
                    # Nothing placeable right now; sleep until resources
                    # free (release/notify wake us).
                    self._wake.wait(timeout=0.05)
            # Decision records for the placed batch land OUTSIDE the
            # condvar (every submit/release/notify serializes behind it).
            if trace and to_dispatch:
                for task, node_id, cands in to_dispatch:
                    tid_hex = task.spec.task_id.hex()
                    self.ring.push(_dec.K_LOOP, tid_hex, task.spec.name,
                                   task.key, cands, None, node_id.hex(),
                                   task.attempts)
                with self._lock:
                    if len(self._attempt_samples) < 512:
                        self._attempt_samples.extend(
                            t.attempts for t, _n, _c in to_dispatch)
            for task, node_id, _cands in to_dispatch:
                self._dispatch_safely(task.spec, task.dispatch, node_id)
            self._maybe_publish_metrics()

    def stop(self) -> None:
        with self._wake:
            self._running = False
            self._wake.notify_all()
        # Join (bounded) so standalone schedulers — the control_plane
        # bench harness, unit tests — never leak their loop thread into
        # the sanitizer's shutdown diff.  Dispatches run ON the loop
        # thread, so a stop() from a dispatch callback must not join.
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=2.0)

    # -- placement ----------------------------------------------------------

    def _bundle_key(self, ns: _NodeState, pg: PlacementGroupID,
                    bundle_index: int, need: ResourceSet):
        if bundle_index >= 0:
            key = (pg, bundle_index)
            return key if key in ns.bundle_available else None
        # Wildcard bundle: first bundle on this node with room.
        for key, avail in ns.bundle_available.items():
            if key[0] == pg and need.fits(avail):
                return key
        return None

    def _try_place(self, spec: TaskSpec,
                   info: Optional[Dict[str, Any]] = None
                   ) -> Optional[NodeID]:
        """Pick + book a node for ``spec`` (None = blocked this round).

        ``info``, when given, receives the decision record the schedview
        ring keeps: candidate count, per-reason rejection tallies, the
        policy that picked, and an ``infeasible`` flag when no node's
        TOTAL resources could ever satisfy the request.  Success paths
        fill only ``candidates``/``policy`` (O(1) extra); the tally pass
        runs only on failure, which is off the placement hot path."""
        need = spec.resources
        if spec.placement_group is not None:
            for ns in self._nodes.values():
                key = self._bundle_key(ns, spec.placement_group,
                                       spec.bundle_index, need)
                if key is not None and need.fits(ns.bundle_available[key]):
                    ns.bundle_available[key] = ns.bundle_available[key] - need
                    if info is not None:
                        info["candidates"] = 1
                        info["policy"] = "pg_bundle"
                    return ns.info.node_id
            if info is not None:
                info["candidates"] = 0
                info["rejected"] = {_dec.R_BUNDLE: max(1, len(self._nodes))}
            return None

        strategy = spec.scheduling_strategy
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            ns = self._nodes.get(strategy.node_id)
            if ns is not None and need.fits(ns.available) and \
                    strategy.node_id not in self._draining:
                ns.available = ns.available - need
                if info is not None:
                    info["candidates"] = 1
                    info["policy"] = "affinity"
                return ns.info.node_id
            if not strategy.soft:
                if info is not None:
                    if ns is None:
                        why = _dec.R_AFFINITY
                    elif strategy.node_id in self._draining:
                        why = _dec.R_DRAINING
                    else:
                        why = _dec.R_INSUFFICIENT
                    info["candidates"] = 0
                    info["rejected"] = {_dec.R_AFFINITY: 1} \
                        if why == _dec.R_AFFINITY else {why: 1,
                                                        _dec.R_AFFINITY: 1}
                return None  # stays queued until that node frees up

        candidates = [ns for ns in self._nodes.values()
                      if ns.info.node_id not in self._draining
                      and need.fits(ns.available)]
        if info is not None:
            info["candidates"] = len(candidates)
        if not candidates:
            if info is not None:
                rejected: Dict[str, int] = {}
                draining_n = insufficient = 0
                for ns in self._nodes.values():
                    if ns.info.node_id in self._draining:
                        draining_n += 1
                    else:
                        insufficient += 1
                if not self._nodes:
                    rejected[_dec.R_NO_NODES] = 1
                if draining_n:
                    rejected[_dec.R_DRAINING] = draining_n
                if insufficient:
                    rejected[_dec.R_INSUFFICIENT] = insufficient
                if not any(need.fits(ns.info.total_resources)
                           for ns in self._nodes.values()):
                    # No alive node could EVER satisfy this shape.
                    info["infeasible"] = True
                    rejected[_dec.R_INFEASIBLE] = max(1, len(self._nodes))
                info["rejected"] = rejected
            return None

        if strategy == "SPREAD":
            self._spread_rr += 1
            ns = candidates[self._spread_rr % len(candidates)]
            if info is not None:
                info["policy"] = "spread"
        else:
            ns = self._hybrid_pick(candidates)
            if info is not None:
                info["policy"] = "hybrid"
        ns.available = ns.available - need
        return ns.info.node_id

    def _hybrid_pick(self, candidates: List[_NodeState]) -> _NodeState:
        """Pack onto busiest node under the threshold, else least utilized
        (reference: hybrid_scheduling_policy.cc)."""
        thresh = Config.get("scheduler_spread_threshold")

        def utilization(ns: _NodeState) -> float:
            utils = []
            for k, total in ns.info.total_resources.items():
                if total > 0:
                    utils.append(1.0 - ns.available.get(k) / total)
            return max(utils) if utils else 0.0

        under = [ns for ns in candidates if utilization(ns) < thresh]
        if under:
            return max(under, key=utilization)
        return min(candidates, key=utilization)

    # -- placement groups ---------------------------------------------------

    def create_placement_group(self, pg: PlacementGroupInfo) -> bool:
        """Two-phase reserve: compute full assignment against a snapshot,
        commit only if every bundle fits (reference:
        gcs_placement_group_scheduler.h:115 prepare/commit).  A group that
        does not fit yet stays PENDING and is retried whenever capacity
        frees up (reference: GcsPlacementGroupManager pending queue)."""
        with self._wake:
            self._pg_created_mono.setdefault(pg.pg_id, time.monotonic())
            if self._try_commit_pg(pg):
                return True
            if _dec.enabled():
                self.ring.push(
                    _dec.K_PG_REJECT, pg.pg_id.hex(),
                    pg.name or "placement_group", pg.strategy, 0,
                    {_dec.R_BUNDLE:
                     sum(1 for b in pg.bundles if b.node_id is None)},
                    None, 1)
            self._pending_pgs.append(pg)
            return False

    def _try_commit_pg(self, pg: PlacementGroupInfo) -> bool:
        """Commit every still-unplaced bundle (all of them on first create;
        just the lost ones after a node death re-plan)."""
        pending = [b for b in pg.bundles if b.node_id is None]
        if not pending:
            self._controller.set_pg_state(pg.pg_id, PG_CREATED)
            self._note_pg_committed(pg, [])
            return True
        # Draining nodes never receive NEW bundles (existing bundles on a
        # draining node stay committed; evacuation is the owner's call).
        snapshot = {nid: ns.available.copy()
                    for nid, ns in self._nodes.items()
                    if nid not in self._draining}
        used = {b.node_id for b in pg.bundles if b.node_id is not None}
        assignment = self._plan_bundles(pg, snapshot, pending, used)
        if assignment is None:
            return False
        for bundle, node_id in zip(pending, assignment):
            ns = self._nodes[node_id]
            ns.available = ns.available - bundle.resources
            ns.bundle_available[(pg.pg_id, bundle.index)] = bundle.resources.copy()
            bundle.node_id = node_id
        self._controller.set_pg_state(pg.pg_id, PG_CREATED)
        self._note_pg_committed(pg, assignment)
        self._wake.notify_all()
        return True

    def _note_pg_committed(self, pg: PlacementGroupInfo,
                           assignment: List[NodeID]) -> None:
        """Book the two-phase-commit latency + decision record for a PG
        that just reached CREATED (PG creates are rare — direct
        telemetry is fine here, unlike the per-task path)."""
        created = self._pg_created_mono.pop(pg.pg_id, None)
        if created is not None:
            # PG commits are rare (not the per-task hot path), so one
            # observe under the lock is cheaper than restructuring the
            # two-phase-commit flow to stamp outside it.
            telemetry.observe("ray_tpu_sched_pg_commit_seconds",  # ray-tpu: noqa[RT404]
                              max(0.0, time.monotonic() - created))
        if _dec.enabled():
            nodes = {b.node_id.hex()[:12] for b in pg.bundles
                     if b.node_id is not None}
            self.ring.push(_dec.K_PG_COMMIT, pg.pg_id.hex(),
                           pg.name or "placement_group", pg.strategy,
                           len(nodes), None,
                           ",".join(sorted(nodes)) or None, 1)

    def _retry_pending_pgs_locked(self) -> None:
        if not self._pending_pgs:
            return
        still_pending = []
        for pg in self._pending_pgs:
            if pg.state == PG_REMOVED:
                continue
            if not self._try_commit_pg(pg):
                still_pending.append(pg)
        self._pending_pgs = still_pending

    def _plan_bundles(self, pg: PlacementGroupInfo,
                      snapshot: Dict[NodeID, ResourceSet],
                      bundles=None,
                      used_nodes: Optional[Set[NodeID]] = None
                      ) -> Optional[List[NodeID]]:
        bundles = pg.bundles if bundles is None else bundles
        node_ids = list(snapshot.keys())
        if not node_ids:
            return None
        assignment: List[NodeID] = []
        if pg.strategy == STRICT_PACK:
            # All bundles (incl. survivors) must share one node; a partial
            # re-plan must land on the surviving bundles' node if any.
            anchor = {b.node_id for b in pg.bundles if b.node_id is not None}
            cands = list(anchor) if anchor else node_ids
            for nid in cands:
                if nid not in snapshot:
                    continue
                avail = snapshot[nid].copy()
                ok = True
                for b in bundles:
                    if not b.resources.fits(avail):
                        ok = False
                        break
                    avail = avail - b.resources
                if ok:
                    return [nid] * len(bundles)
            return None
        used_nodes = set(used_nodes or ())
        order = node_ids if pg.strategy != SPREAD else random.sample(
            node_ids, len(node_ids))
        for b in bundles:
            placed = None
            if pg.strategy == STRICT_SPREAD:
                cands = [n for n in order if n not in used_nodes
                         and b.resources.fits(snapshot[n])]
            elif pg.strategy == SPREAD:
                cands = sorted(
                    (n for n in order if b.resources.fits(snapshot[n])),
                    key=lambda n: n in used_nodes)
            else:  # PACK: prefer already-used nodes
                cands = sorted(
                    (n for n in order if b.resources.fits(snapshot[n])),
                    key=lambda n: n not in used_nodes)
            if cands:
                placed = cands[0]
            if placed is None:
                return None
            snapshot[placed] = snapshot[placed] - b.resources
            used_nodes.add(placed)
            assignment.append(placed)
        return assignment

    def reschedule_lost_bundles(self, pg: PlacementGroupInfo,
                                dead_node: NodeID) -> None:
        """Re-plan the bundles a dead node took with it; live bundles keep
        their placement (JAX: the placement-group manager's rescheduling
        on node death)."""
        with self._wake:
            if pg.state == PG_REMOVED:
                return
            lost = False
            for b in pg.bundles:
                if b.node_id == dead_node:
                    b.node_id = None
                    lost = True
            if not lost:
                return
            self._controller.set_pg_state(pg.pg_id, PG_PENDING)
            self._pg_created_mono.setdefault(pg.pg_id, time.monotonic())
            if not self._try_commit_pg(pg) and pg not in self._pending_pgs:
                self._pending_pgs.append(pg)

    def exchange_finished(self, node_id: NodeID,
                          spec: TaskSpec) -> Optional[_PendingTask]:
        """A task of ``spec``'s scheduling class just finished on
        ``node_id``: hand its booking to a queued task of the same class
        and return it for dispatch there (lease reuse), or release the
        booking and return None.  Only while that class is the only one
        queued, so a stream of one class starves no other."""
        key = self._sched_key(spec)
        with self._wake:
            bucket = self._ready.get(key)
            if bucket and self._running and len(self._ready) == 1 \
                    and not self._pending_pgs and node_id in self._nodes:
                task = bucket.popleft()
                self._ready_count -= 1
                if not bucket:
                    self._ready.pop(key, None)
                if _dec.enabled():
                    self.ring.push(_dec.K_LOOP, task.spec.task_id.hex(),
                                   task.spec.name, key, 1, None,
                                   node_id.hex(), task.attempts + 1)
                return task
        self.release(node_id, spec.resources, spec.placement_group,
                     spec.bundle_index)
        return None

    def remove_placement_group(self, pg: PlacementGroupInfo) -> None:
        with self._wake:
            for b in pg.bundles:
                if b.node_id is None:
                    continue
                ns = self._nodes.get(b.node_id)
                if ns is None:
                    continue
                remaining = ns.bundle_available.pop((pg.pg_id, b.index), None)
                if remaining is not None:
                    # Return the whole bundle; in-use slices return via release().
                    ns.available = ns.available + remaining
                b.node_id = None
            self._pg_created_mono.pop(pg.pg_id, None)
            self._controller.set_pg_state(pg.pg_id, PG_REMOVED)
            self._wake.notify_all()

    def queue_depths(self) -> Dict[str, int]:
        """Live queue depths by stage (the `ray-tpu sched` gauges)."""
        with self._lock:
            return {
                "ready": self._ready_count,
                "ready_classes": len(self._ready),
                "waiting_deps": sum(len(v)
                                    for v in self._waiting.values()),
                "infeasible": len(self._infeasible),
                "pending_pgs": len(self._pending_pgs),
            }

    def _maybe_publish_metrics(self, force: bool = False) -> None:
        """Rate-limited flush of queue depths / decision counts into the
        telemetry catalog (the hot paths only bump plain ints; this runs
        on the scheduler loop OUTSIDE the condvar, ~1/s).  A concurrent
        publisher (loop tick vs ctl_sched_stats poll) skips instead of
        double-counting the counter deltas."""
        if not self._publish_lock.acquire(blocking=False):
            return
        try:
            now = time.monotonic()
            if not force and now < self._publish_next_mono:
                return
            self._publish_next_mono = now + 1.0
            with self._lock:
                depths = {
                    "ready": self._ready_count,
                    "waiting_deps": sum(len(v)
                                        for v in self._waiting.values()),
                    "infeasible": len(self._infeasible),
                    "pending_pgs": len(self._pending_pgs),
                }
                samples, self._attempt_samples = self._attempt_samples, []
            # _publish_lock exists ONLY to serialize these publishes (it
            # single-admits publishers; schedulers never block on it) —
            # publishing under it is the lock's whole purpose, and the
            # hot scheduler lock was already dropped above.
            for queue, depth in depths.items():
                telemetry.set_gauge("ray_tpu_sched_queue_depth",  # ray-tpu: noqa[RT404]
                                    float(depth), tags={"queue": queue})
            counts = dict(self.ring.counts)
            for kind, total in counts.items():
                delta = total - self._published_counts.get(kind, 0)
                if delta > 0:
                    telemetry.inc("ray_tpu_sched_decisions_total",  # ray-tpu: noqa[RT404]
                                  float(delta), tags={"kind": kind})
            self._published_counts = counts
            telemetry.observe_many("ray_tpu_sched_placement_attempts",  # ray-tpu: noqa[RT404]
                                   [float(a) for a in samples])
        finally:
            self._publish_lock.release()


# -- the host as the scheduler's one node ---------------------------------------


def _host_memory() -> float:
    try:
        return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    except (ValueError, OSError, AttributeError):
        return 64e9


class Booking:
    """Resources held for a worker the caller starts itself (a train
    worker, an actor): ``cards`` are its card ids, ``env()`` the
    environment that pins it to them; ``release()`` returns both."""

    def __init__(self, node: "Node", spec: TaskSpec):
        self.node = node
        self.spec = spec
        self.cards: List[int] = []
        self.placed = threading.Event()
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._state = "pending"   # pending -> held -> released

    def env(self) -> Dict[str, str]:
        with self._lock:
            cards = list(self.cards)
        return self.node.card_env(cards)

    def _placed(self, spec: TaskSpec, node_id: NodeID) -> None:
        cards = self.node.take_cards(spec)
        with self._lock:
            if self._state == "released":   # cancelled while queued
                cancelled = True
            else:
                cancelled = False
                self.cards = cards
                self._state = "held"
        if cancelled:
            self.node.give_back(spec, cards)
        self.placed.set()

    def _failed(self, exc: BaseException) -> None:
        self.error = exc
        self.placed.set()

    def wait(self, timeout: Optional[float] = None) -> "Booking":
        if not self.placed.wait(timeout):
            self.release()
            raise TimeoutError(
                f"{self.spec.name}: {self.spec.resources.to_dict()} not "
                f"placed within {timeout} s (available "
                f"{self.node.available_resources()})")
        if self.error is not None:
            raise self.error
        return self

    def release(self) -> None:
        with self._lock:
            held = self._state == "held"
            self._state = "released"
            cards, self.cards = self.cards, []
        if held:
            self.node.give_back(self.spec, cards)


class CardPool:
    """A node's cards: a spec booked with whole cards gets exactly those
    card ids, pinned by the accelerator manager's ``visibility_env`` (JAX:
    ``node.py:640-650``).  The session's node and every node process
    (``_node.NodeManager``) grant through one."""

    def __init__(self, n: int):
        self._lock = threading.Lock()
        self._cards: List[int] = list(range(int(n)))

    def take(self, spec: TaskSpec) -> List[int]:
        """The card ids of a placed spec's whole cards (JAX grants
        ``int(TPU)`` chips; a fractional share is pinned to none)."""
        n = int(spec.resources.get(GPU))
        if n <= 0:
            return []
        with self._lock:
            if len(self._cards) < n:
                # The scheduler booked them, so they are held by a worker
                # that has not handed them back: a fault, not a wait.
                raise RuntimeError(
                    f"{spec.name}: {n} card(s) booked but only "
                    f"{self._cards} free")
            grant, self._cards = self._cards[:n], self._cards[n:]
        return grant

    def give_back(self, cards: List[int]) -> None:
        if cards:
            with self._lock:
                self._cards = sorted(self._cards + list(cards))

    @staticmethod
    def env(cards: List[int]) -> Dict[str, str]:
        """The environment pinning a worker to ``cards`` (empty when it
        holds none)."""
        if not cards:
            return {}
        from ._actor import _spawn_env_lock
        # The parent's own CUDA_VISIBLE_DEVICES: a spawn in flight holds
        # its child's in os.environ under this lock.
        with _spawn_env_lock:
            return get_accelerator(GPU).visibility_env(cards)


def node_resources(num_cpus: float, num_tpus: Optional[float] = None,
                   resources: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
    """A node's advertised resources: ``CPU``, ``memory``, ``GPU`` (its
    cards: ``num_tpus`` or what every registered accelerator plugin
    detects, JAX: the per-vendor manager loop of ``Runtime.__init__``)
    and ``resources``."""
    res: Dict[str, float] = {CPU: float(num_cpus), MEMORY: _host_memory()}
    if num_tpus is not None:
        res[GPU] = float(num_tpus)
    for mgr in all_accelerators():
        if mgr.resource_name in res:
            continue
        try:
            n = mgr.detect_num_chips()
        except Exception:  # noqa: BLE001 - a plugin that cannot tell
            n = 0
        if n:
            res[mgr.resource_name] = float(n)
    if resources:
        res.update(resources)
    return res


class Node:
    """The host: its tables, its scheduler and its cards (JAX: the head
    node's ``Runtime`` and ``NodeManager`` in one process).  Nodes that
    join (``_cluster.HeadServer``) are added to the same scheduler."""

    def __init__(self, num_cpus: float, num_tpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None, *,
                 controller: Optional[Controller] = None,
                 job_id: Optional[JobID] = None):
        self.job_id = job_id if job_id is not None else JobID.next()
        self.controller = controller if controller is not None \
            else Controller()
        res = node_resources(num_cpus, num_tpus, resources)
        self.node_id = NodeID.from_random()
        self.info = NodeInfo(self.node_id, socket.gethostname(),
                             ResourceSet(res), is_head=True)
        self.controller.register_node(self.info)
        self._lock = threading.Lock()
        self.cards = CardPool(int(res.get(GPU, 0)))
        self._deps: Dict[ObjectID, cf.Future] = {}
        self._on_error: Dict[TaskID, Callable[[BaseException], None]] = {}
        self.scheduler = ClusterScheduler(self.controller, self._object_ready)
        self.scheduler.on_dispatch_error = self._dispatch_failed
        self.scheduler.add_node(self.info)

    # -- dependencies --------------------------------------------------------

    def _object_ready(self, oid: ObjectID) -> bool:
        with self._lock:
            fut = self._deps.get(oid)
        return fut is None or fut.done()

    def dep(self, fut: cf.Future) -> ObjectID:
        """An ObjectID the scheduler's dependency stage waits on until
        ``fut`` is done."""
        oid = ObjectID.from_random()
        with self._lock:
            self._deps[oid] = fut
        fut.add_done_callback(
            lambda _f: self.scheduler.notify_object_ready(oid))
        return oid

    def drop_deps(self, spec: TaskSpec) -> None:
        with self._lock:
            for kind, oid in spec.arg_descs:
                if kind == "ref":
                    self._deps.pop(oid, None)

    # -- placement and cards --------------------------------------------------

    def new_spec(self, name: str, resources: ResourceSet, *,
                 deps: Tuple[ObjectID, ...] = (), strategy=None,
                 pg: Optional[PlacementGroupID] = None, bundle: int = -1,
                 runtime_env=None) -> TaskSpec:
        return TaskSpec(task_id=TaskID.from_random(), name=name,
                        fn_blob=None, method_name=None,
                        arg_descs=[("ref", d) for d in deps],
                        kwarg_descs={}, return_ids=[], resources=resources,
                        placement_group=pg, bundle_index=bundle,
                        scheduling_strategy=strategy, runtime_env=runtime_env)

    def submit(self, spec: TaskSpec,
               dispatch: Callable[[TaskSpec, NodeID], None],
               on_error: Callable[[BaseException], None]) -> None:
        """Queue ``spec``; once placed, ``dispatch(spec, node_id)`` runs
        (on the submitting thread or the scheduler's).  Where it raises,
        the scheduler undoes the booking and ``on_error(exc)`` runs."""
        with self._lock:
            self._on_error[spec.task_id] = on_error

        def run(spec: TaskSpec, node_id: NodeID) -> None:
            dispatch(spec, node_id)
            with self._lock:
                self._on_error.pop(spec.task_id, None)

        self.scheduler.submit(spec, run)

    def forget(self, spec: TaskSpec) -> None:
        """The scheduler will not dispatch ``spec``: the head's runtime
        queued it ahead on a node's worker (pipelined submission)."""
        with self._lock:
            self._on_error.pop(spec.task_id, None)
        self.drop_deps(spec)

    def _dispatch_failed(self, spec: TaskSpec, exc: BaseException) -> None:
        with self._lock:
            on_error = self._on_error.pop(spec.task_id, None)
        if on_error is not None:
            on_error(exc)

    def take_cards(self, spec: TaskSpec) -> List[int]:
        """The card ids of a placed spec's whole cards."""
        return self.cards.take(spec)

    def give_back(self, spec: TaskSpec, cards: List[int],
                  resources: Optional[ResourceSet] = None) -> None:
        """Return a spec's cards to the pool and its booking (or
        ``resources`` of it) to the scheduler."""
        self.cards.give_back(cards)
        self.scheduler.release(self.node_id,
                               spec.resources if resources is None
                               else resources,
                               spec.placement_group, spec.bundle_index)

    def card_env(self, cards: List[int]) -> Dict[str, str]:
        """The environment pinning a worker to ``cards`` (empty when it
        holds none)."""
        return CardPool.env(cards)

    def book(self, resources: Dict[str, float], name: str, *,
             pg: Optional[PlacementGroupID] = None, bundle: int = -1,
             strategy=None) -> Booking:
        """Queue a booking of ``resources`` (``Booking.wait`` blocks until
        it is placed)."""
        spec = self.new_spec(name, ResourceSet(resources), pg=pg,
                             bundle=bundle, strategy=strategy)
        booking = Booking(self, spec)
        self.submit(spec, booking._placed, booking._failed)
        return booking

    # -- placement groups and views ------------------------------------------

    def create_pg(self, bundles: List[Dict[str, float]], strategy: str,
                  name: Optional[str] = None) -> PlacementGroupID:
        pg_id = PlacementGroupID.of(self.job_id)
        info = PlacementGroupInfo(
            pg_id, name, strategy,
            [BundleInfo(i, ResourceSet(b)) for i, b in enumerate(bundles)])
        self.controller.register_placement_group(info)
        self.scheduler.create_placement_group(info)
        return pg_id

    def pg_state(self, pg_id: PlacementGroupID) -> Optional[str]:
        info = self.controller.get_placement_group(pg_id)
        return info.state if info else None

    def pg_bundle_locations(self, pg_id: PlacementGroupID):
        info = self.controller.get_placement_group(pg_id)
        if info is None:
            return None
        return [b.node_id.binary() if b.node_id else None
                for b in info.bundles]

    def remove_pg(self, pg_id: PlacementGroupID) -> None:
        info = self.controller.get_placement_group(pg_id)
        if info is not None:
            self.scheduler.remove_placement_group(info)

    def cluster_resources(self) -> Dict[str, float]:
        return self.scheduler.total_resources()

    def available_resources(self) -> Dict[str, float]:
        return self.scheduler.available_resources()

    def nodes(self) -> List[Dict[str, Any]]:
        return [{"node_id": n.node_id.hex(), "alive": n.alive,
                 "hostname": n.hostname,
                 "resources": n.total_resources.to_dict(),
                 "is_head": n.is_head, "draining": False,
                 "drain_reason": "", "drain_remaining_s": 0.0}
                for n in self.controller.nodes.values()]

    def stop(self) -> None:
        self.scheduler.stop()


def node_for_run() -> Tuple[Node, bool]:
    """(the node a run books on, whether the run owns it): the session's
    (``init()``), or with no session a node of the host's cores and cards
    that the caller stops when it is done."""
    from . import _tasks
    session = _tasks._session
    if session is not None:
        return session.node, False
    return Node(float(os.cpu_count() or 1)), True


def _session_node() -> Node:
    from . import _tasks
    return _tasks._require_session().node


# -- the API (JAX: ray_tpu/_private/api.py:619-684) ------------------------------


def normalize_strategy(options: Dict[str, Any]):
    """(strategy, placement group id, bundle index) of task or actor
    options (JAX: ``_normalize_strategy``)."""
    strategy = options.get("scheduling_strategy")
    pg, bundle = None, -1
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        pgh = strategy.placement_group
        pg = pgh.id if isinstance(pgh, PlacementGroup) else pgh
        bundle = strategy.placement_group_bundle_index
        strategy = None
    if options.get("placement_group") is not None:
        pgh = options["placement_group"]
        pg = pgh.id if isinstance(pgh, PlacementGroup) else pgh
        bundle = options.get("placement_group_bundle_index", -1)
    return strategy, pg, bundle


def _client_rt():
    from . import _client
    return _client.current()


def cluster_resources() -> Dict[str, float]:
    rt = _client_rt()
    if rt is not None:
        return rt.control("cluster_resources")
    return _session_node().cluster_resources()


def available_resources() -> Dict[str, float]:
    rt = _client_rt()
    if rt is not None:
        return rt.control("available_resources")
    return _session_node().available_resources()


def nodes() -> List[Dict[str, Any]]:
    rt = _client_rt()
    if rt is not None:
        return rt.control("nodes")
    return _session_node().nodes()


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundle_count: int = 0):
        self.id = pg_id
        self.bundle_count = bundle_count

    def ready(self, timeout: Optional[float] = 30.0) -> bool:
        rt = _client_rt()
        if rt is not None:
            return rt.control("pg_wait", self.id.binary(), timeout)
        return wait_pg(_session_node(), self.id, timeout)

    def bundle_locations(self):
        rt = _client_rt()
        if rt is not None:
            return rt.control("pg_bundle_locations", self.id.binary())
        return _session_node().pg_bundle_locations(self.id)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_count))


def wait_pg(node: Node, pg_id: PlacementGroupID,
            timeout: Optional[float]) -> bool:
    """True once the placement group is CREATED; False when it is removed,
    unknown, or ``timeout`` passes first."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        state = node.pg_state(pg_id)
        if state == PG_CREATED:
            return True
        if state in (PG_REMOVED, None):
            return False
        if deadline is not None and time.monotonic() > deadline:
            return False
        time.sleep(0.01)


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: Optional[str] = None) -> PlacementGroup:
    rt = _client_rt()
    if rt is not None:
        return PlacementGroup(PlacementGroupID(rt.control(
            "create_pg", bundles, strategy, name)), len(bundles))
    return PlacementGroup(_session_node().create_pg(bundles, strategy, name),
                          len(bundles))


def remove_placement_group(pg: PlacementGroup) -> None:
    rt = _client_rt()
    if rt is not None:
        rt.control("remove_pg", pg.id.binary())
        return
    _session_node().remove_pg(pg.id)

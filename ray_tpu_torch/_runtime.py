"""The head's cluster runtime (the cluster half of
``ray_tpu/_private/runtime.py``): what the head does for the nodes that
join it (``_cluster.HeadServer``), beside ``init()``'s session (``_tasks``:
the scheduler, the local pool) and the actor tier (``_actor``,
``_controller``).

- **Dispatch.**  A task the scheduler places on a joined node goes to it
  (``dispatch_remote``) with its packed arguments' descriptor tagged with
  the head; its booking is released when the node reports its end, or
  handed straight to a queued task of the same class on the same node
  (``ClusterScheduler.exchange_finished``, lease reuse).  An actor placed
  on a node starts there (``start_remote_actor``), watched by ``_actor``'s
  own watcher through a pipe this runtime feeds.
- **The object directory.**  A result made on a node stays in that
  node's store; the head holds its descriptor tagged with the node, and
  reads it by pulling a copy through the data plane (``localize``: the
  owner's ``DataServer``, this process's ``ObjectPuller``, a copy in the
  head's store until the last ref goes).  Results of tasks that finished
  while this head restarted reach it when their node re-attaches and
  replays them; a client asking for one of those object ids waits in
  ``directory_ref``.
- **Lineage.**  Each result made on a node records the task that made it
  (``_record_lineage``).  When its node is gone and nothing else holds a
  copy, reading it runs that task again on a surviving node
  (``_recover_object``), up to its ``max_retries``.
- **Failures.**  A worker that dies (``on_worker_died``) or a dispatch a
  node refuses (``on_dispatch_failed``) retries the task under
  ``max_retries`` or fails it.  A node that dies (``on_node_died``): its
  running tasks retry elsewhere, its actors restart on a surviving node
  under ``max_restarts`` (``_controller``'s state machine), its bundles
  are planned again, its objects are rebuilt from lineage when read.
- **Views and diagnostics.**  Each node's versioned load view
  (``on_node_view``/``ctl_node_views``, stale versions dropped), its
  workers' log lines (printed with their prefix), the task events
  (``events``, a ``TaskEventBuffer``), cluster-wide stack dumps
  (``ctl_stack_dump``: a worker that cannot answer is listed
  unresponsive).

Where each public function of JAX's ``runtime.py`` lives in the port:

| JAX ``Runtime`` | port |
| --- | --- |
| ``__init__``, ``shutdown`` | ``_tasks.init``/``shutdown`` with ``_actor._Session``; ``Runtime`` here for the node plane |
| ``submit_task``, ``_dispatch_normal``, ``_resolve`` | ``_tasks._submit``, ``_TaskSession.submit``, ``_Pool.dispatch``; ``Runtime.dispatch_remote`` |
| ``_try_pipeline``, ``_return_pipeline_credit``, ``on_pipeline_reject`` | ``Runtime.try_pipeline``/``on_pipeline_reject`` (credits a node), ``ClusterScheduler.exchange_finished`` |
| ``_record_lineage``, ``_recover_object`` | ``Runtime._record_lineage``, ``Runtime._recover_object`` |
| ``on_task_done``, ``on_dispatch_failed``, ``on_worker_died`` | ``_tasks._apply_reply``/``_Pool.worker_died`` locally; ``Runtime.on_task_done``, ``on_dispatch_failed``, ``on_worker_died`` for nodes |
| ``on_node_died``, ``on_node_view``, ``ctl_node_views`` | here |
| ``create_actor``, ``submit_actor_task``, ``kill_actor``, ``_on_actor_worker_death``, ``on_actor_state`` | ``_actor`` (``_create_actor``, ``_Channel``, ``kill``, ``_actor_exited``, ``_watch``); ``Runtime.start_remote_actor``/``on_actor_state`` for nodes |
| ``get``, ``wait``, ``put``, ``on_get_request``, ``on_wait_request``, ``on_put_from_worker`` | ``_actor.get``/``wait``/``put``, ``_tasks.put``; a worker's through ``_Pool.serve_request`` (a node's relayed by ``on_worker_request``) |
| ``ctl_kv_*``, ``ctl_get_named_actor``, ``ctl_nodes``, ``ctl_cluster_resources``, ``ctl_available_resources``, placement-group verbs | ``_cluster.serve_rpc`` over ``_controller`` and ``_scheduler`` |
| ``ctl_node_data_address`` | ``Runtime.ctl_node_data_address`` (a node's ``NodeRpc``) |
| ``ctl_stack_dump`` | ``Runtime.ctl_stack_dump`` |
| ``ctl_list_tasks``, ``ctl_timeline``, ``ctl_summarize_tasks`` | ``Runtime.events`` (``TaskEventBuffer``); the state API over it waits for ROADMAP Queue 1 item 14 (``util/state``) |
| ``ctl_drain_node``, ``ctl_profile``, ``ctl_list_logs``, ``ctl_log_tail``, the autoscaler, job and dashboard feeds | ROADMAP Queue 1 item 13 part 3 and item 14 |
| ``direct`` calls (``ctl_resolve_actor_direct``) | ``_actor``'s channels already call an actor directly; ``_direct.py`` is part 3 |
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import _sanitizer
from ._config import Config
from ._events import (FAILED, FINISHED, RUNNING, SUBMITTED_TO_NODE,
                      TaskEventBuffer)
from .exceptions import ObjectLostError, RayTpuError, WorkerCrashedError

_current: Optional["Runtime"] = None
#: How long a cluster-wide stack dump waits for the workers' answers.
STACK_DUMP_TIMEOUT_S = 5.0


def current(required: bool = True) -> Optional["Runtime"]:
    """The runtime of this process's session (the head's)."""
    rt = _current
    if rt is None and required:
        raise RayTpuError("ray_tpu_torch.init() has not been called")
    return rt


class _RemoteActor:
    """The head's stand-in for an actor process on a node, shaped as
    ``_actor``'s watcher expects of a process (``pid``, ``exitcode``,
    ``is_alive``, ``kill``, ``join``)."""

    def __init__(self, runtime: "Runtime", actor_id: str, node_id):
        self.runtime = runtime
        self.actor_id = actor_id
        self.node_id = node_id
        self.pid = 0
        self.exitcode: Optional[int] = None
        self._exited = threading.Event()
        import multiprocessing as mp
        #: ``_actor._watch`` reads ``conn``; this runtime writes ``feed``.
        self.conn, self.feed = mp.Pipe(duplex=False)

    def is_alive(self) -> bool:
        return not self._exited.is_set()

    def kill(self) -> None:
        proxy = self.runtime.proxy(self.node_id)
        if proxy is not None:
            proxy.kill_actor(self.actor_id)
        else:
            self.exited(None)

    def join(self, timeout: Optional[float] = None) -> None:
        self._exited.wait(timeout)

    def exited(self, code) -> None:
        if self._exited.is_set():
            return
        self.exitcode = code
        self._exited.set()
        try:
            self.feed.close()
        except OSError:
            pass


class _DataPlane:
    """The head's store of pulled copies, its data server (serving the
    session's segments to the nodes) and its puller."""

    def __init__(self, runtime: "Runtime"):
        from ._cluster import DataClient, DataServer, ObjectPuller
        from ._object_store import SharedMemoryStore
        token = runtime.session.head_server.token
        self.store = SharedMemoryStore(Config.get("object_store_memory"))
        self.server = DataServer(None, token)
        self.client = DataClient(token)
        self.puller = ObjectPuller(
            self.store, self.client, runtime.node_id.binary(),
            runtime.ctl_node_data_address,
            f"{runtime.session.id}_{runtime.node_id.hex()[:8]}")

    def shutdown(self) -> None:
        self.server.shutdown()
        self.client.shutdown()
        self.store.shutdown()


class Runtime:
    """The head's side of the node plane (one per ``init()`` session)."""

    def __init__(self, session):
        self.session = session
        self.node_id = session.node.node_id
        self.events = TaskEventBuffer()
        self._lock = threading.Lock()
        #: Tasks running on joined nodes, by the session's task id.
        self.running: Dict[int, Any] = {}
        #: (node, segment) of a result -> (the task that made it, index).
        self._lineage: Dict[tuple, tuple] = {}
        #: (node, segment) of a lost result -> its rebuilt descriptor.
        self._recovered: Dict[tuple, tuple] = {}
        #: Object ids whose results arrived (or are awaited) without a
        #: task of this head: replays after a restart from the WAL.
        self._directory: Dict[Any, cf.Future] = {}
        #: Nodes of the session this head's WAL replayed (they may
        #: re-attach and replay results), and those that did.
        self._boot_nodes = set(session.node.controller.revivable_nodes)
        self._wal_nodes: set = set()
        self._node_views: Dict[Any, tuple] = {}
        self._node_views_lock = threading.Lock()
        self._actors: Dict[str, _RemoteActor] = {}
        self._stack_lock = threading.Lock()
        self._stack_dumps: Dict[int, Dict[str, Any]] = {}
        self._stack_seq = 0
        self._pongs: Dict[float, threading.Event] = {}
        #: Pipelined submission: tasks queued ahead on each node, and the
        #: nodes that refused one lately (no queue room).
        self._credits: Dict[Any, int] = {}
        self._cooldown: Dict[Any, float] = {}
        #: Counters: tasks pipelined, rejects, lineage rebuilds.
        self.counts: Dict[str, int] = {"pipelined": 0, "pipeline_rejects": 0,
                                       "rebuilt": 0}
        self._session_dir: Optional[str] = None
        self._dp: Optional[_DataPlane] = None
        self._plane_lock = threading.Lock()
        self._closed = False

    # -- the data plane ---------------------------------------------------------

    @property
    def session_dir(self) -> str:
        """This head's session directory (made at first use)."""
        with self._plane_lock:
            if self._session_dir is None:
                from ._log_monitor import create_session_dir
                self._session_dir = create_session_dir()
            return self._session_dir

    def _plane(self, start: bool = True) -> Optional["_DataPlane"]:
        """The head's data plane, started when the first node joins (None
        before that unless ``start``)."""
        with self._plane_lock:
            if self._dp is None and start:
                self._dp = _DataPlane(self)
            return self._dp

    def data_address(self) -> Tuple[str, int]:
        return self._plane().server.address

    def ctl_node_data_address(self, node_id_bytes: bytes):
        """The data server of a node (the location oracle)."""
        hs = self.session.head_server
        return None if hs is None else hs.node_data_address(node_id_bytes)

    def proxy(self, node_id):
        hs = self.session.head_server
        if hs is None:
            return None
        with hs._lock:
            return hs.proxies.get(node_id)

    def localize(self, desc: tuple) -> tuple:
        """A descriptor this process can map for ``desc`` of another node:
        a copy pulled into the head's store, or, when its node is gone,
        the object rebuilt from its lineage."""
        from ._tasks import _key
        if desc[1] == self.node_id.binary():
            return desc[2]
        key = _key(desc)
        with self._lock:
            desc = self._recovered.get(key, desc)
        if desc[1] == self.node_id.binary():
            return desc[2]
        out = self._plane().puller.localize(desc)
        if out[0] != "err":
            return out
        return self.localize(self._recover_object(desc, out[1]))

    def release_remote(self, desc: tuple) -> None:
        """The last ref of a remote object went: its lineage, the head's
        pulled copy and the owner's segment go too."""
        from ._cluster import FreeObject
        from ._ids import NodeID
        from ._tasks import _key
        key = _key(desc)
        with self._lock:
            self._lineage.pop(key, None)
            rebuilt = self._recovered.pop(key, None)
        dp = self._plane(start=False)
        if dp is not None and desc[2][0] == "shm":
            local = dp.puller.forget(desc[1], desc[2][1])
            if local is not None:
                dp.store.delete(local[1])
            proxy = self.proxy(NodeID(desc[1]))
            if proxy is not None:
                proxy.send(FreeObject([desc[2][1]]))
        if rebuilt is not None:
            from ._tasks import _release
            _release(rebuilt)

    def drop_cached(self, desc: tuple) -> bool:
        """Drop the head's pulled copy of a remote object (the next read
        pulls again, or rebuilds it if its node is gone)."""
        dp = self._plane(start=False)
        if dp is None or desc[0] != "at":
            return False
        local = dp.puller.forget(desc[1], desc[2][1])
        if local is not None:
            dp.store.delete(local[1])
        return local is not None

    def _record_lineage(self, task, descs: List[tuple]) -> None:
        from ._tasks import _key
        with self._lock:
            for i, d in enumerate(descs):
                if d[0] == "at":
                    self._lineage[_key(d)] = (task, i)

    def _recover_object(self, desc: tuple, why: str) -> tuple:
        """Run the task that made ``desc`` again (its node is gone) and
        wait for the new copy; ``ObjectLostError`` without lineage or
        once its ``max_retries`` are spent."""
        from . import _tasks
        from ._ids import ObjectID
        key = _tasks._key(desc)
        with self._lock:
            entry = self._lineage.get(key)
        if entry is None:
            raise ObjectLostError(f"{why}; it has no lineage to rebuild "
                                  "it from", b"")
        task, index = entry
        with self._lock:
            done = self._recovered.get(key)
            if done is not None:
                return done
            if task.attempts >= task.opts["max_retries"]:
                raise ObjectLostError(
                    f"{why}; its task {task.name!r} has been run "
                    f"{task.attempts + 1} times (max_retries "
                    f"{task.opts['max_retries']})", b"")
            task.attempts += 1
        session = self.session
        copy = _tasks._Task(
            tid=next(session.ids), name=task.name, fn_blob=task.fn_blob,
            arg_refs=task.arg_refs, opts=task.opts, attempts=task.attempts,
            returns=[cf.Future() for _ in task.returns],
            args_desc=task.args_desc, args_ref=task.args_ref,
            cpu_released=False,
            oids=[ObjectID.from_random() for _ in task.returns])
        spec = task.spec
        copy.spec = session.node.new_spec(
            task.name, spec.resources, strategy=spec.scheduling_strategy,
            pg=spec.placement_group, bundle=spec.bundle_index,
            runtime_env=spec.runtime_env)
        _tasks._count("task_retries")
        session.submit(copy)
        new = copy.returns[index].result()
        _tasks._adopt(new)
        with self._lock:
            self._recovered[key] = new
            self.counts["rebuilt"] += 1
        return new

    # -- nodes -------------------------------------------------------------------

    def add_node(self, proxy, msg, wal_resumed: bool = False) -> None:
        node = self.session.node
        node.scheduler.try_pipeline = self.try_pipeline
        node.controller.register_node(proxy.info)
        node.controller.note_revivable(proxy.node_id.binary(),
                                       (msg.hostname, msg.os_pid))
        if wal_resumed:
            with self._lock:
                self._wal_nodes.add(proxy.node_id)
        node.scheduler.add_node(proxy.info)

    def on_node_died(self, node_id, reason: str) -> None:
        """A node is gone: its tasks retry elsewhere, its actors restart
        (or die) through ``_actor``'s watcher, its bundles are planned
        again; its objects are rebuilt from lineage when read."""
        node = self.session.node
        node.controller.mark_node_dead(node_id, reason)
        node.controller.drop_revivable(node_id.binary())
        node.scheduler.remove_node(node_id)
        with self._node_views_lock:
            self._node_views.pop(node_id, None)
        with self._lock:
            self._credits.pop(node_id, None)
            lost = [t for t in self.running.values()
                    if t.node_id == node_id]
            for t in lost:
                self.running.pop(t.tid, None)
            actors = [a for a in self._actors.values()
                      if a.node_id == node_id]
        for t in lost:
            self._retry_or_fail(t, None, f"its node died ({reason})",
                                release=False)
        for a in actors:
            a.exited(None)
        for pg in list(node.controller.placement_groups.values()):
            if any(b.node_id == node_id for b in pg.bundles):
                node.scheduler.reschedule_lost_bundles(pg, node_id)

    def on_node_view(self, node_id, version: int, view: dict) -> None:
        """A node's versioned load view; a stale version is dropped."""
        with self._node_views_lock:
            cur = self._node_views.get(node_id)
            if cur is not None and cur[0] >= version:
                return
            self._node_views[node_id] = (version, view, time.time())
        addr = view.get("data_address")
        proxy = self.proxy(node_id)
        if addr and proxy is not None:
            proxy.data_address = tuple(addr)

    def ctl_node_views(self) -> Dict[str, Dict[str, Any]]:
        """The latest view of each node; the head's own is sampled live
        (version -1)."""
        out = {}
        with self._node_views_lock:
            for nid, (version, view, ts) in self._node_views.items():
                out[nid.hex()] = dict(view, _version=version, _ts=ts)
        out[self.node_id.hex()] = dict(self._local_view(), _version=-1,
                                       _ts=time.time())
        return out

    def _local_view(self) -> Dict[str, Any]:
        from . import _cluster
        from ._scheduler import _host_memory
        pool = self.session.pool
        with pool.cv:
            workers = len(pool.workers)
            running = sum(1 for w in pool.workers if w.busy)
        return {"workers": workers, "running_tasks": running,
                "memory_total_bytes": int(_host_memory()),
                "transfer": _cluster.transfer_stats()}

    def on_log_lines(self, proxy, msg) -> None:
        from ._log_monitor import LogMonitor
        for fname, line in msg.lines:
            LogMonitor._default_emit(fname, line)

    def on_pong(self, proxy, msg) -> None:
        with self._lock:
            ev = self._pongs.pop(msg.t, None)
        if ev is not None:
            ev.set()

    def ping_node(self, node_id, timeout: float = 10.0) -> float:
        """Seconds a ping takes to come back from ``node_id`` (its reader
        answers while it starts workers and actors)."""
        from ._cluster import Ping
        proxy = self.proxy(node_id)
        if proxy is None:
            raise RayTpuError(f"node {node_id.hex()} is not joined")
        t = time.monotonic()
        ev = threading.Event()
        with self._lock:
            self._pongs[t] = ev
        proxy.send(Ping(t))
        if not ev.wait(timeout):
            with self._lock:
                self._pongs.pop(t, None)
            raise TimeoutError(f"node {node_id.hex()[:12]} did not answer "
                               f"a ping within {timeout} s")
        return time.monotonic() - t

    def serve_node_rpc(self, method: str, args: tuple):
        if method == "node_data_address":
            return self.ctl_node_data_address(*args)
        raise ValueError(f"unknown node rpc {method!r}")

    # -- tasks on nodes ------------------------------------------------------------

    def dispatch_remote(self, task, node_id) -> None:
        """The scheduler placed ``task`` on a joined node: send it there
        (its booking is held until the node reports its end)."""
        from . import _tasks
        from ._cluster import export_desc
        session = self.session
        spec = task.spec
        session.node.drop_deps(spec)
        proxy = self.proxy(node_id)
        if proxy is None:
            session.node.scheduler.release(node_id, spec.resources,
                                           spec.placement_group,
                                           spec.bundle_index)
            session.submit(task)
            return
        if task.args_desc is None and not _tasks._pack_args(task):
            session.node.scheduler.release(node_id, spec.resources,
                                           spec.placement_group,
                                           spec.bundle_index)
            return
        try:
            env, wspec = self._wire_spec(task, node_id)
        except Exception as e:  # noqa: BLE001 - the task's own error
            session.node.scheduler.release(node_id, spec.resources,
                                           spec.placement_group,
                                           spec.bundle_index)
            _tasks._fail_task(task, e)
            return
        task.booked = True
        with self._lock:
            self.running[task.tid] = task
        opts = dict(task.opts, tid=task.tid, env=env)
        proxy.dispatch_task(wspec, export_desc(task.args_desc,
                                               self.node_id.binary()), opts)
        self.events.record(spec.task_id.hex(), SUBMITTED_TO_NODE,
                           name=task.name, node_id=node_id.hex())

    def _wire_spec(self, task, node_id):
        """(the worker's environment, the spec sent to the node) of a task
        about to run on ``node_id``."""
        import pickle

        from . import _runtime_env
        from ._actor import _by_reference_rule, _device_env
        from ._protocol import TaskSpec
        spec = task.spec
        kind, *rest = pickle.loads(task.fn_blob)
        if kind == "fn" and rest[0] == "__main__":
            raise _by_reference_rule(
                f"remote function {rest[1]!r}", TypeError(
                    "defined in the driver's __main__, which a node's "
                    "workers cannot import"))
        env = dict(_device_env(task.opts["device"]))
        env.update(task.opts["env_vars"])
        rt_env = spec.runtime_env or {}
        env.update({k: str(v) for k, v in
                    (rt_env.get("env_vars") or {}).items()})
        env.update(_runtime_env.node_setup_env_vars(rt_env or None))
        task.node_id = node_id
        if task.oids is None:
            from ._ids import ObjectID
            task.oids = [ObjectID.from_random()
                         for _ in (task.returns or [None])]
        wspec = TaskSpec(
            task_id=spec.task_id, name=task.name, fn_blob=task.fn_blob,
            method_name=None, arg_descs=[], kwarg_descs={},
            return_ids=list(task.oids), resources=spec.resources,
            runtime_env=None, streaming=task.opts["streaming"])
        return env, wspec

    # -- pipelined submission ----------------------------------------------------

    def _pipeline_cap(self, proxy) -> int:
        from ._resources import CPU
        cpus = proxy.info.total_resources.get(CPU)
        from ._node import PIPELINE_DEPTH
        return PIPELINE_DEPTH * max(1, int(cpus))

    def try_pipeline(self, spec) -> bool:
        """The cluster has no room for ``spec`` (a plain CPU task): queue it
        ahead on a busy worker of the node with the most spare credit
        (``_node.PIPELINE_DEPTH`` a CPU), without a booking; the node answers
        ``UpPipelineReject`` when no worker there has queue room."""
        from . import _tasks
        from ._cluster import DispatchTask
        session = self.session
        with session.lock:
            task = session.unplaced_specs.get(spec.task_id)
        hs = session.head_server
        if task is None or hs is None:
            return False
        now = time.monotonic()
        with hs._lock:
            proxies = list(hs.proxies.values())
        with self._lock:
            best, spare = None, 0
            for p in proxies:
                if self._cooldown.get(p.node_id, 0.0) > now:
                    continue
                room = self._pipeline_cap(p) - self._credits.get(
                    p.node_id, 0)
                if room > spare:
                    best, spare = p, room
            if best is None:
                return False
            self._credits[best.node_id] = self._credits.get(
                best.node_id, 0) + 1
        session.take_unplaced(task)
        session.node.forget(spec)
        if task.args_desc is None and not _tasks._pack_args(task):
            self._return_credit(best.node_id)
            return True             # failed with its argument's error
        try:
            env, wspec = self._wire_spec(task, best.node_id)
        except Exception as e:  # noqa: BLE001 - the task's own error
            self._return_credit(best.node_id)
            _tasks._fail_task(task, e)
            return True
        task.pipelined = True
        task.booked = False
        with self._lock:
            self.running[task.tid] = task
            self.counts["pipelined"] += 1
        from ._cluster import export_desc
        best.send(DispatchTask(wspec, [export_desc(
            task.args_desc, self.node_id.binary())],
            dict(task.opts, tid=task.tid, env=env), pipelined=True))
        self.events.record(spec.task_id.hex(), SUBMITTED_TO_NODE,
                           name=task.name, node_id=best.node_id.hex())
        return True

    def credits(self) -> Dict[str, int]:
        """Tasks queued ahead on each node now (node id hex -> count)."""
        with self._lock:
            return {k.hex(): v for k, v in self._credits.items()}

    def _return_credit(self, node_id) -> None:
        with self._lock:
            if self._credits.get(node_id, 0) > 0:
                self._credits[node_id] -= 1

    def on_pipeline_reject(self, proxy, msg) -> None:
        """The node had no queue room: back to normal (booked) scheduling,
        and no pipelining to that node for a moment."""
        with self._lock:
            task = self.running.pop(msg.tid, None)
            self._cooldown[proxy.node_id] = time.monotonic() + 0.5
            self.counts["pipeline_rejects"] += 1
        if task is None:
            return
        self._return_credit(proxy.node_id)
        task.pipelined = False
        self.session.submit(task)

    def _release_booking(self, task) -> Optional[Any]:
        """Give ``task``'s booking back on its node (less the CPU it gave
        up while blocked in ``get``), or hand it to a queued task of the
        same class there (returned, to be dispatched)."""
        from ._resources import CPU, ResourceSet
        with self.session.pool.req_lock:
            if not task.booked:
                return None
            task.booked = False
            released, task.cpu_released = task.cpu_released, False
        spec = task.spec
        sched = self.session.node.scheduler
        if released:
            sched.release(task.node_id, ResourceSet(
                {k: v for k, v in spec.resources.items() if k != CPU}),
                spec.placement_group, spec.bundle_index)
            return None
        plain = spec.placement_group is None and not spec.runtime_env \
            and not spec.resources.get("GPU")
        if plain:
            return sched.exchange_finished(task.node_id, spec)
        sched.release(task.node_id, spec.resources, spec.placement_group,
                      spec.bundle_index)
        return None

    def on_task_running(self, proxy, msg) -> None:
        with self._lock:
            task = self.running.get(msg.tid)
        if task is not None:
            self.events.record(task.spec.task_id.hex(), RUNNING,
                               node_id=proxy.node_id.hex(),
                               worker_id=msg.worker_id.hex())

    def on_task_done(self, proxy, msg) -> None:
        """A task of a node ended (or streamed an item)."""
        from . import _tasks
        from ._cluster import import_desc
        local = self.node_id.binary()
        reply = msg.reply
        kind, tid = reply[0], reply[1]
        if kind == "item":
            reply = (kind, tid, import_desc(reply[2], local),
                     [import_desc(d, local) for d in reply[3]])
            with self._lock:
                task = self.running.get(tid)
            if task is not None:
                _tasks._apply_reply(task, reply)
            return
        if kind == "ok":
            reply = (kind, tid, [import_desc(d, local) for d in reply[2]],
                     [[import_desc(d, local) for d in inner]
                      for inner in reply[3]]) + tuple(reply[4:])
        with self._lock:
            task = self.running.pop(tid, None)
        if task is None:
            self._replay(msg, reply)
            return
        if task.pipelined:
            task.pipelined = False
            self._return_credit(proxy.node_id)
        nxt = self._release_booking(task)
        if kind == "ok" and task.opts["max_retries"] > 0:
            self._record_lineage(task, reply[2])
        else:
            # No lineage holds the task's arguments: they go now.
            task.arg_refs = None
            task.args_ref = None
        _tasks._apply_reply(task, reply)
        self.events.record(task.spec.task_id.hex(),
                           FINISHED if kind in ("ok", "end") else FAILED,
                           node_id=proxy.node_id.hex())
        if nxt is not None:
            nxt.dispatch(nxt.spec, proxy.node_id)

    def _replay(self, msg, reply) -> None:
        """A result of a task this head does not know: a node re-attached
        after this head restarted.  Its object ids resolve in the
        directory."""
        from . import _tasks
        from ._ids import ObjectID
        if reply[0] != "ok":
            return
        for oid_b, desc in zip(msg.return_ids, reply[2]):
            oid = ObjectID(oid_b)
            _tasks._adopt(desc)
            with self._lock:
                fut = self._directory.get(oid)
                if fut is None:
                    fut = self._directory[oid] = cf.Future()
            if not fut.done():
                fut.set_result(desc)

    def directory_ref(self, oid):
        """A ref of an object id this head knows from a replay (or, when
        its WAL named nodes that may re-attach, one still to be replayed);
        None otherwise."""
        from . import _tasks
        from ._actor import ObjectRef
        with self._lock:
            fut = self._directory.get(oid)
            if fut is None:
                if not (self._wal_nodes or self._boot_nodes):
                    return None
                fut = self._directory[oid] = cf.Future()
        ref = ObjectRef(cf.Future(), "replayed", store=True, owned=True)

        def settle(f):
            desc = f.result()
            _tasks._adopt(desc)
            ref._fut.set_result(desc)
        fut.add_done_callback(settle)
        return ref

    def on_worker_request(self, proxy, msg) -> None:
        """A nested request of a task on the node: answered as the local
        pool answers its workers' (those that may wait, from a thread)."""
        from ._tasks import _BLOCKING_REQUESTS
        if msg.req[0] in _BLOCKING_REQUESTS:
            _sanitizer.spawn(self._answer, args=(proxy, msg),
                             name="head-node-request")
        else:
            self._answer(proxy, msg)

    def _answer(self, proxy, msg) -> None:
        from . import _tasks
        from ._cluster import export_desc
        kind, rid = msg.req[0], msg.req[1]
        with self._lock:
            task = self.running.get(msg.tid)
        try:
            if task is None:
                raise RayTpuError("the task that asked has ended")
            out = self.session.pool.serve_request(
                task, (kind,) + tuple(msg.req[2:]))
        except Exception as e:  # noqa: BLE001 - raised in the worker
            out = ("error", _tasks._error_blob(e))
        if out[0] == "value" and isinstance(out[1], tuple):
            out = ("value", export_desc(out[1], self.node_id.binary()))
        proxy.send_to_worker(msg.worker_id, ("reply", rid, out))

    def _retry_or_fail(self, task, code, why: str,
                       release: bool = True) -> None:
        from . import _tasks
        if task.pipelined:
            task.pipelined = False
            self._return_credit(task.node_id)
        if release:
            nxt = self._release_booking(task)
            if nxt is not None:
                nxt.dispatch(nxt.spec, task.node_id)
        else:
            with self.session.pool.req_lock:
                task.booked = False
        if self._closed:
            _tasks._fail_task(task, RayTpuError("the session was shut "
                                                "down"))
            return
        retries = task.opts["max_retries"]
        if task.attempts < retries:
            task.attempts += 1
            _tasks._count("task_retries")
            self.session.submit(task)
            return
        self.events.record(task.spec.task_id.hex(), FAILED,
                           error_message=why)
        _tasks._fail_task(task, WorkerCrashedError(
            f"the worker process of task {task.name!r} exited with code "
            f"{code}: {why} (attempts {task.attempts + 1}, max_retries "
            f"{retries})"))

    def on_worker_died(self, proxy, msg) -> None:
        for tid in msg.running:
            with self._lock:
                task = self.running.pop(tid, None)
            if task is not None:
                self._retry_or_fail(task, msg.exit_code,
                                    "its worker died on node "
                                    f"{proxy.node_id.hex()[:12]}")

    def on_dispatch_failed(self, proxy, msg) -> None:
        with self._lock:
            task = self.running.pop(msg.tid, None)
        if task is not None:
            self._retry_or_fail(task, None, f"the node refused it: "
                                f"{msg.reason}")

    # -- actors on nodes -------------------------------------------------------------

    def start_remote_actor(self, session, aid, qualname: str,
                           spec: Dict[str, Any], env: Dict[str, str],
                           tspec, node_id) -> None:
        """Start an actor the scheduler placed on a joined node; ``_actor``'s
        watcher follows it through a pipe this runtime feeds with its
        state and its exit."""
        from ._actor import _watch
        from ._cluster import StartActor
        actor_id = aid.hex()
        proxy = self.proxy(node_id)
        if proxy is None:
            raise RayTpuError(f"node {node_id.hex()[:12]} is gone")
        rproc = _RemoteActor(self, actor_id, node_id)
        sched = self.session.node.scheduler
        with self._lock:
            self._actors[actor_id] = rproc
        with session.lock:
            session.procs[actor_id] = rproc
            exited = session.exits[actor_id] = threading.Event()

        def on_exit() -> None:
            with self._lock:
                if self._actors.get(actor_id) is rproc:
                    self._actors.pop(actor_id, None)
            sched.release(node_id, tspec.resources, tspec.placement_group,
                          tspec.bundle_index)

        t = _sanitizer.spawn(_watch, args=(session, aid, rproc, rproc.conn,
                                           exited, on_exit),
                             name=f"actor-watch-{actor_id[:8]}")
        with session.lock:
            session.watchers = [w for w in session.watchers
                                if w.is_alive()] + [t]
        session.controller.get_actor(aid).node_id = node_id
        # The node fills in the head's endpoint: the token in it stays off
        # the wire.
        proxy.send(StartActor(actor_id, qualname, dict(spec, head=None),
                              env, tspec))

    def on_actor_state(self, proxy, msg) -> None:
        from ._ids import ActorID
        from ._protocol import ActorStateMsg
        with self._lock:
            rproc = self._actors.get(msg.actor_id)
        if rproc is None:
            return
        if msg.state == "exit":
            rproc.exited(msg.detail if isinstance(msg.detail, int)
                         else None)
            return
        rproc.pid = msg.pid
        try:
            rproc.feed.send(ActorStateMsg(ActorID.from_hex(msg.actor_id),
                                          msg.state, msg.detail))
        except (OSError, BrokenPipeError):
            pass

    # -- diagnostics ----------------------------------------------------------------

    def on_stack_msg(self, proxy, msg) -> None:
        from ._cluster import UpStackReply
        with self._stack_lock:
            entry = self._stack_dumps.get(msg.dump_id)
            if entry is None:
                return
            if isinstance(msg, UpStackReply):
                rec = dict(msg.record, node_id=proxy.node_id.hex())
                entry["replies"][rec["worker_id"]] = rec
            else:
                entry["want"].update(msg.worker_ids)
                entry["expects_pending"] -= 1
        entry["event"].set()

    def ctl_stack_dump(self, timeout_s: float = STACK_DUMP_TIMEOUT_S
                       ) -> Dict[str, Any]:
        """Every node's workers' stacks and the driver's own: ``{"time",
        "stacks", "unresponsive"}``; a worker that does not answer within
        the timeout is listed by id."""
        from ._diagnostics import capture_process_stacks
        hs = self.session.head_server
        with hs._lock:
            proxies = list(hs.proxies.values())
        with self._stack_lock:
            self._stack_seq += 1
            dump_id = self._stack_seq
            entry = {"replies": {}, "want": set(),
                     "expects_pending": len(proxies),
                     "event": threading.Event()}
            self._stack_dumps[dump_id] = entry
        for p in proxies:
            p.broadcast_stack_dump(dump_id)
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            with self._stack_lock:
                done = entry["expects_pending"] <= 0 and \
                    entry["want"] <= set(entry["replies"])
            if done:
                break
            entry["event"].wait(0.05)
            entry["event"].clear()
        with self._stack_lock:
            self._stack_dumps.pop(dump_id, None)
            replies = dict(entry["replies"])
            want = set(entry["want"])
        driver = capture_process_stacks("driver", is_driver=True)
        driver["node_id"] = self.node_id.hex()
        stacks = [driver] + [replies[k] for k in sorted(replies)]
        return {"time": time.time(), "stacks": stacks,
                "unresponsive": sorted(want - set(replies))}

    @property
    def scheduler(self):
        return self.session.node.scheduler

    @property
    def log_monitor(self):
        """The head's log directory (the bundle's events tail)."""
        from ._log_monitor import LogMonitor
        return LogMonitor(os.path.join(self.session_dir, "logs"))

    def write_debug_bundle(self, reason: str, **kw) -> str:
        """A debug bundle of this head under ``<session>/debug/``
        (``_diagnostics``): every node's stacks, the task events, the
        scheduler's decisions, metrics, lock and leak findings."""
        from ._diagnostics import write_debug_bundle
        return write_debug_bundle(self, reason, **kw)

    # -- shutdown --------------------------------------------------------------------

    def shutdown(self) -> None:
        """Stop the data plane, drop the pulled copies and the spill
        directories of dead nodes; the session's segments (``rtt_<id>_*``,
        those of its nodes too) go with the session."""
        from ._object_store import sweep_orphan_spills
        self._closed = True
        with self._lock:
            actors = list(self._actors.values())
            self._actors.clear()
            running, self.running = list(self.running.values()), {}
        for a in actors:
            a.exited(None)
        from . import _tasks
        for t in running:
            _tasks._fail_task(t, RayTpuError("the session was shut down"))
        with self._plane_lock:
            dp, session_dir = self._dp, self._session_dir
        if dp is not None:
            dp.shutdown()
        if session_dir is not None:
            spill = Config.get("object_spill_dir") or os.path.join(
                session_dir, "spill")
            sweep_orphan_spills(spill)
            shutil.rmtree(session_dir, ignore_errors=True)
            from ._log_monitor import sweep_dead_sessions
            sweep_dead_sessions(os.path.dirname(session_dir))


def _install(rt: Optional[Runtime]) -> None:
    global _current
    _current = rt


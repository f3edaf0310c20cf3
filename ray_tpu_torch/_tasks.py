"""Remote functions (tasks): the task half of ``ray_tpu/_private/api.py``
(``RemoteFunction``, ``init``, ``is_initialized``, ``shutdown``) and the
task execution of ``ray_tpu/_private/worker.py``.

``init(num_cpus=..., num_tpus=..., resources=...)`` starts the session:
the host as one node of the scheduler tier (``_scheduler``: ``CPU`` is
``num_cpus``, default ``os.cpu_count()``; ``GPU`` its cards) and a pool of
spawned worker processes that run the functions ``remote`` wraps.  Every
task is booked through the node's scheduler with JAX's options and
semantics (``num_cpus``, default 1; ``num_tpus``, the cards; ``memory``;
``resources``; ``placement_group`` with ``placement_group_bundle_index``;
``scheduling_strategy``; ``runtime_env``): it waits in the dependency
stage for its argument refs, then in the ready queue until it fits, and
runs once placed; a shape the node could never hold is parked as
infeasible.  A task holding cards sees exactly its granted cards
(``CUDA_VISIBLE_DEVICES``) and its worker exits after it (JAX does not
pool chip-holding workers).  Other workers are kept per env signature
(``env_vars``, ``device``, the runtime env, fixed when the process
starts) and reused; the default signature's workers start at ``init``.  A
worker imports this package, numpy and the function's module, and nothing
of torch unless that module does.

A task may submit tasks: its ``.remote()`` goes to the driver's scheduler
over the worker's pipe, and while it waits in ``get`` its CPU goes back to
the scheduler.  The session's memory monitor (``_memory_monitor``, off
unless ``memory_monitor_refresh_ms`` is set) kills a worker when host
memory runs over ``memory_usage_threshold``: idle workers first, then the
retriable task started last; the task retries under ``max_retries`` or
fails with ``OutOfMemoryError``.  Isolation (``_cgroup``) is off unless
``enable_resource_isolation`` is set.

Values travel as descriptors:

- ``("inline", bytes)``: a pickle of at most ``INLINE_MAX`` bytes, carried
  in the descriptor itself;
- ``("shm", segment, nbytes)``: a POSIX shared-memory segment
  (``/dev/shm/rtt_<session>_<id>``) in the layout of ``_object_store``: the
  value pickled with protocol 5, its array and tensor buffers out of band,
  each aligned to 64 bytes.  Any process on the host maps it by name and
  reads the arrays in place.

A task's return value is sealed by the worker that made it; the caller's
``ObjectRef`` holds the descriptor.  Passed to another task, as a top-level
argument or inside a container, only the descriptor crosses, and the
worker maps the segment (a top-level ref argument is replaced by its value,
as JAX's worker does; a nested one stays a ref for the function to
``get``).  ``get`` in the driver maps it too.  A store-backed ref pickles
as its descriptor.  The driver owns every segment of the session: a
segment is unlinked when the last ref of it in the driver is collected
(refs in a pending task's arguments are held until the task ends), and
every segment of the session at ``shutdown()``.

Functions and arguments pickle by reference, as the actor tier's do (the
port has no cloudpickle): a function must be defined at the top level of a
module; a lambda or a nested function raises ``ValueError`` at
``.remote()``.  A task that raises comes back as ``TaskError`` (its
``cause`` the exception) and is not retried; a task whose worker process
dies is placed again, and runs on a fresh worker, up to ``max_retries``
times (default 3, JAX's ``task_max_retries_default``), then fails with
``WorkerCrashedError``.  A task whose argument failed fails with a
``TaskError`` whose cause is that argument's error.

Not ported: the cluster arguments of ``init`` (each raises
``NotImplementedError`` naming ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures as cf
import functools
import glob
import importlib
import io
import itertools
import math
import os
import pickle
import queue
import sys
import threading
import time
import traceback
import types
import uuid
import weakref
from typing import Any, Deque, Dict, List, Optional, Tuple

from . import _cgroup, _memory_monitor, _runtime_env, _scheduler
from ._actor import (ObjectRef, ObjectRefGenerator, RayTpuError, TaskError,
                     _by_reference_rule, _child_environment, _device_env)
from ._object_store import (SHM_DIR, _HostPickler, _layout, _read_parts,
                            _Segment, _write)
from ._resources import CPU, ResourceSet, task_resources

#: Values whose pickle is at most this many bytes travel inside their
#: descriptor (JAX: ``max_inline_object_size``).
INLINE_MAX = 100 * 1024
#: JAX's ``task_max_retries_default``.
DEFAULT_MAX_RETRIES = 3
_KNOWN_OPTIONS = frozenset((
    "num_returns", "max_retries", "name", "num_cpus", "device", "env_vars",
    "num_tpus", "resources", "memory", "placement_group",
    "placement_group_bundle_index", "scheduling_strategy", "runtime_env"))
CLUSTER = 'ROADMAP Queue 1 item 13, "multi-node cluster"'


class WorkerCrashedError(RayTpuError):
    """The worker process died mid-task (JAX: ``WorkerCrashedError``)."""


class OutOfMemoryError(WorkerCrashedError):
    """The memory monitor killed the task's worker (JAX:
    ``OutOfMemoryError``); its message says "OOM-killed"."""


class RuntimeEnvSetupError(RayTpuError):
    """A runtime env could not be set up (JAX: ``RuntimeEnvSetupError``)."""


def _not_ported(what: str, entry: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: see {entry}")


# -- descriptors ---------------------------------------------------------------

#: In a task worker: its session id and options; None elsewhere.
_in_worker: Optional[Dict[str, Any]] = None
#: Counters of this process (``stats()``).
_stats = collections.Counter()
_stats_lock = threading.Lock()


def _count(key: str, n: int = 1) -> None:
    with _stats_lock:
        _stats[key] += n


def stats() -> Dict[str, int]:
    """This process's counters: ``tasks_submitted``, ``tasks_run`` (ended,
    with a result or an error), ``task_retries``, ``mapped_bytes``
    (payload bytes of segments this process mapped to read)."""
    with _stats_lock:
        return dict(_stats)


class _RefPickler(_HostPickler):
    """Protocol 5 with buffers out of band; every ObjectRef becomes a
    persistent id, the index of its descriptor."""

    def __init__(self, file, buffers: list, refs: list):
        super().__init__(file, protocol=5, buffer_callback=buffers.append)
        self.refs = refs

    def persistent_id(self, obj):
        if isinstance(obj, ObjectRef):
            self.refs.append(obj)
            return len(self.refs) - 1
        return None


class _RefUnpickler(pickle.Unpickler):
    def __init__(self, file, buffers, descs):
        super().__init__(file, buffers=buffers)
        self.descs = descs

    def persistent_load(self, pid):
        return _ref_from_desc(self.descs[pid])


def _pack(value: Any, what: str) -> Tuple[bytes, List[pickle.PickleBuffer],
                                          List[ObjectRef]]:
    """(metadata, out-of-band buffers, refs inside) of ``value``."""
    out = io.BytesIO()
    buffers: List[pickle.PickleBuffer] = []
    refs: List[ObjectRef] = []
    try:
        _RefPickler(out, buffers, refs).dump(value)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise _by_reference_rule(what, e) from e
    return out.getvalue(), buffers, refs


def _segment_name() -> str:
    session = (_in_worker or {}).get("session") or (
        _session.id if _session is not None else "local")
    return f"rtt_{session}_{uuid.uuid4().hex}"


def _seal(value: Any, what: str = "a task's value",
          inner: Optional[list] = None) -> tuple:
    """A descriptor of ``value`` (the refs inside it must be ready); the
    descriptors of those refs are added to ``inner`` when given."""
    meta, buffers, refs = _pack(value, what)
    descs = [_desc_of(r) for r in refs]
    if inner is not None:
        inner.extend(descs)
    return _encode(meta, buffers, descs)


def _encode(meta: bytes, buffers: List[pickle.PickleBuffer],
            descs: list) -> tuple:
    """Inline when the pickle is at most ``INLINE_MAX`` bytes, else a new
    segment."""
    raw = [b.raw() for b in buffers]
    size = len(meta) + sum(r.nbytes for r in raw)
    if size <= INLINE_MAX:
        return ("inline", pickle.dumps(
            (descs, meta, [bytes(r) for r in raw]), protocol=5))
    env = pickle.dumps((descs, meta), protocol=5)
    nbytes, offsets = _layout(env, raw)
    name = _segment_name()
    seg = _Segment(name, create=True, size=max(nbytes, 1))
    try:
        _write(seg.buf, env, raw, offsets)
    finally:
        seg.close()
    return ("shm", name, nbytes)


def _load(desc: tuple) -> Any:
    """The value of a descriptor (arrays of a segment are views of its
    mapping, valid for as long as they live)."""
    kind = desc[0]
    if kind == "inline":
        descs, meta, bufs = pickle.loads(desc[1])
        return _RefUnpickler(io.BytesIO(meta), bufs, descs).load()
    if kind != "shm":
        raise ValueError(f"unknown descriptor kind {kind!r}")
    _, name, nbytes = desc
    try:
        seg = _Segment(name, create=False)
    except FileNotFoundError:
        raise RayTpuError(f"object {name} was freed (its last ref in the "
                          "driver was collected, or the session ended)"
                          ) from None
    bufs = None
    try:
        env, bufs = _read_parts(seg.buf[:nbytes])
        descs, meta = pickle.loads(env)
        value = _RefUnpickler(io.BytesIO(meta), bufs, descs).load()
    finally:
        # Unmaps now unless the value holds views of the mapping; then
        # the mapping goes with the last of them.
        del bufs
        seg.close()
    _count("mapped_bytes", int(nbytes))
    return value


def desc_nbytes(desc: Optional[tuple]) -> int:
    """Bytes of a descriptor's payload (0 for None)."""
    if not desc:
        return 0
    if desc[0] == "inline":
        return len(desc[1])
    if desc[0] == "shm":
        return int(desc[2])
    return 0


# -- ownership of segments (in the driver) ---------------------------------------

#: segment -> refs of it alive in this process (the driver's).
_owned: Dict[str, int] = {}
_owned_lock = threading.RLock()
#: A task result's key (its segment, or an inline result's bytes) -> the
#: descriptors of the refs inside it, each adopted once per entry: a ref
#: returned inside a result lives as long as that result, not as long as
#: the task that made it.
_contains: Dict[Any, List[list]] = {}


def _adopt(desc: tuple) -> None:
    if desc[0] == "shm":
        with _owned_lock:
            _owned[desc[1]] = _owned.get(desc[1], 0) + 1


def _release(desc: tuple) -> None:
    if desc[0] != "shm":
        if desc[0] == "inline":
            _release_inner(desc[1])
        return
    name = desc[1]
    with _owned_lock:
        n = _owned.get(name)
        if n is None:
            return
        if n > 1:
            _owned[name] = n - 1
            return
        del _owned[name]
    try:
        os.unlink(os.path.join(SHM_DIR, name))
    except FileNotFoundError:
        pass
    _release_inner(name)


def _hold_inner(desc: tuple, inner: list) -> None:
    """A result ``desc`` arrived holding refs of ``inner``: keep their
    segments until the result itself is released."""
    if not inner or desc[0] not in ("shm", "inline"):
        return
    for d in inner:
        _adopt(d)
    with _owned_lock:
        _contains.setdefault(desc[1], []).append(list(inner))


def _release_inner(key: Any) -> None:
    with _owned_lock:
        held = _contains.get(key)
        if not held:
            return
        inner = held.pop()
        if not held:
            del _contains[key]
    for d in inner:
        _release(d)


def _release_done(fut: cf.Future) -> None:
    if not fut.cancelled() and fut.exception() is None:
        _release(fut.result())


def _release_when_done(fut: cf.Future) -> None:
    """``ObjectRef.__del__`` of an owned ref: release its segment once
    its descriptor is known (now, if it is)."""
    fut.add_done_callback(_release_done)


def _store_ref(desc: tuple, name: str = "", owned: bool = False
               ) -> ObjectRef:
    fut: cf.Future = cf.Future()
    fut.set_result(desc)
    return ObjectRef(fut, name, store=True, owned=owned)


def _ref_from_desc(desc: tuple, name: str = "") -> ObjectRef:
    """A ref unpickled in this process: owned where this process owns its
    segment (the driver), borrowed elsewhere."""
    if desc[0] == "shm" and _in_worker is None:
        with _owned_lock:
            if desc[1] in _owned:
                _owned[desc[1]] += 1
                return _store_ref(desc, name, owned=True)
    return _store_ref(desc, name)


def _desc_of(ref: ObjectRef, keep: Optional[list] = None) -> tuple:
    """A ready ref's descriptor; a value-backed ref (an actor's result) is
    sealed here, and in the driver a ref of the new segment goes into
    ``keep``.  Raises the ref's error."""
    value = ref._fut.result()
    if ref._store:
        return value
    desc = _seal(value, f"the value of {ref._name or 'a ref'}")
    if keep is not None and _in_worker is None:
        _adopt(desc)
        keep.append(_store_ref(desc, ref._name, owned=True))
    return desc


def put(value: Any) -> ObjectRef:
    """A store-backed ref holding ``value`` (the session's ``put``)."""
    desc = _seal(value, "a put value")
    owned = _in_worker is None
    if owned:
        _adopt(desc)
    return _store_ref(desc, "put", owned=owned)


# -- the session: the node's scheduler and a worker pool -------------------------


class _Task:
    """One submitted task: its function and packed arguments, the refs
    those hold (kept until it ends), its return futures or its stream, its
    scheduling spec and, once placed, its cards."""

    __slots__ = ("tid", "name", "fn_blob", "arg_refs", "opts", "env_key",
                 "attempts", "returns", "gen", "args_desc", "args_ref",
                 "spec", "cards", "booked", "cpu_released", "nested",
                 "started")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class _WorkerHandle:
    """The driver's side of one worker process: a thread that takes the
    tasks of its env signature, one at a time."""

    def __init__(self, pool: "_Pool", env_key: tuple):
        self.pool = pool
        self.env_key = env_key
        self.busy = False
        self.retire = False
        self.proc = None
        self.conn = None
        #: The task it runs, and why its process was killed (the OOM
        #: monitor's reason).
        self.task: Optional[_Task] = None
        self.death_reason: Optional[str] = None
        #: Held while sending on ``conn``: the task, and the answers to
        #: its requests, which blocking ones send from threads of their
        #: own.
        self.send_lock = threading.Lock()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="task-worker")

    def start_process(self) -> None:
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        parent, child = ctx.Pipe(duplex=True)
        with _child_environment(dict(self.env_key)):
            proc = ctx.Process(
                target=_worker_main,
                args=(child, self.pool.session_id, os.getpid()),
                daemon=True, name="task-worker")
            proc.start()
        child.close()
        self.pool.cgroup.add_process(proc.pid)
        self.proc, self.conn = proc, parent
        self.death_reason = None
        # Take no task before the process is up: a task handed to a
        # worker still starting waits out its start-up while others idle.
        try:
            parent.recv_bytes()
        except (EOFError, OSError):
            proc.join(timeout=5)
            raise RayTpuError(f"the task worker exited while starting "
                              f"(code {proc.exitcode})") from None

    def _loop(self) -> None:
        pool = self.pool
        try:
            self.start_process()
        except Exception as e:  # noqa: BLE001 - fails the queue's tasks
            pool.worker_failed_to_start(self, e)
            return
        while True:
            task = pool.next_task(self)
            if task is None:
                break
            died, requeued = self._run(task)
            pool.task_finished(self, task, requeued)
            if died and not pool.closed and not self.retire:
                try:
                    self.start_process()
                except Exception as e:  # noqa: BLE001 - as above
                    pool.worker_failed_to_start(self, e)
                    return
        self.stop()

    def _run(self, task: _Task) -> Tuple[bool, bool]:
        """Run one task: (the worker process died, the task was placed
        again).  While it runs, the worker's requests (a nested task's
        submit, get, poll or next item) are answered: those that block
        (a get, a next item) from a thread each, so one thread of the
        task waiting holds up none of its others."""
        msg = pickle.dumps(("task", task.tid, task.name, task.fn_blob,
                            task.args_desc, task.opts),
                           protocol=pickle.HIGHEST_PROTOCOL)
        try:
            with self.send_lock:
                self.conn.send_bytes(msg)
            while True:
                reply = pickle.loads(self.conn.recv_bytes())
                if reply[0] in _REQUESTS:
                    if reply[0] in _BLOCKING_REQUESTS:
                        from . import _sanitizer
                        _sanitizer.spawn(self._answer, args=(task, reply),
                                         name="task-request")
                    else:
                        self._answer(task, reply)
                    continue
                if _apply_reply(task, reply):
                    return False, False
        except (EOFError, OSError, BrokenPipeError):
            pass
        self.conn.close()
        self.proc.join(timeout=5)
        return True, self.pool.worker_died(self, task, self.proc.exitcode)

    def _answer(self, task: _Task, req: tuple) -> None:
        """Answer one request ``(kind, request id, ...)`` of ``task``'s
        worker.  An answer that comes after the task ended finds no
        caller and is dropped there."""
        kind, rid = req[0], req[1]
        try:
            out = self.pool.serve_request(task, (kind,) + tuple(req[2:]))
        except Exception as e:  # noqa: BLE001 - raised in the worker
            out = ("error", _error_blob(e))
        data = pickle.dumps(("reply", rid, out), protocol=5)
        with self.send_lock:
            try:
                self.conn.send_bytes(data)
            except (OSError, EOFError, BrokenPipeError):
                pass            # the worker is gone: nobody to answer

    def stop(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
        if self.proc is not None and self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=10)


#: What a worker asks the driver while its task runs, and of those, what
#: may wait (answered from a thread each).
_REQUESTS = frozenset(("submit", "get", "poll", "next", "plane"))
_BLOCKING_REQUESTS = frozenset(("get", "next"))


def _apply_reply(task: _Task, reply: tuple) -> bool:
    """Resolve ``task``'s refs from one message of its worker; True once
    the task has ended."""
    kind = reply[0]
    if kind == "item":
        gen = task.gen() if task.gen is not None else None
        desc = reply[2]
        _adopt(desc)
        _hold_inner(desc, reply[3])
        if gen is None or not gen._put("desc", desc):
            _release(desc)
        return False
    _merge_worker_side(reply[-2], reply[-1])
    _count("tasks_run")
    if kind == "end":
        gen = task.gen() if task.gen is not None else None
        if gen is not None:
            gen._put("end")
    elif kind == "ok":
        for fut, desc, inner in zip(task.returns, reply[2], reply[3]):
            _adopt(desc)
            _hold_inner(desc, inner)
            fut.set_result(desc)
    else:
        try:
            err = pickle.loads(reply[2])
        except Exception as e:  # noqa: BLE001 - its class is not here
            err = RayTpuError(f"task {task.name!r} failed and its error "
                              f"could not be loaded here: {e!r}")
        _fail_task(task, err)
    return True


def _merge_worker_side(pid: int, snap: Optional[tuple]) -> None:
    """What a worker sends with a task's end: its telemetry, its user
    metrics and its finished spans."""
    if not snap:
        return
    tel, user, spans = snap
    if tel:
        from .util import telemetry
        telemetry.merge_remote(f"task-worker-{pid}", tel)
    if user:
        from .util import metrics
        metrics.merge_remote(f"task-worker-{pid}", user)
    if spans:
        from .util import tracing
        tracing._record_many(spans)


def _fail_task(task: _Task, exc: BaseException) -> None:
    if task.gen is not None:
        gen = task.gen()
        if gen is not None:
            gen._put("err", exc)
        return
    for fut in task.returns:
        if not fut.done():
            fut.set_exception(exc)


def _error_blob(exc: BaseException) -> bytes:
    try:
        return pickle.dumps(exc)
    except Exception:  # noqa: BLE001 - its cause won't pickle
        return pickle.dumps(RayTpuError(repr(exc)))


class _Pool:
    """The session's worker processes.  The scheduler decides what runs
    (``dispatch`` once a task is placed); the pool finds it a worker of
    its env signature, starting one where none is idle, and gives the
    booking back when the task ends."""

    def __init__(self, session: "_TaskSession"):
        self.session = session
        self.node = session.node
        self.max_workers = max(1, int(math.ceil(session.num_cpus)))
        self.session_id = session.id
        self.cv = threading.Condition()
        #: Guards a running task's booking flags and its nested refs,
        #: which its requests' threads touch at once.
        self.req_lock = threading.Lock()
        self.queues: Dict[tuple, Deque[_Task]] = {}
        self.workers: List[_WorkerHandle] = []
        self.closed = False
        self.cgroup = _cgroup.CgroupManager(root=_cgroup.CGROUP_ROOT)
        self.memory_monitor = _memory_monitor.MemoryMonitor(self)

    @property
    def capacity(self) -> float:
        """The node's CPUs."""
        return self.node.info.total_resources.get(CPU)

    @property
    def free(self) -> float:
        """The node's CPUs not booked now."""
        return self.node.available_resources().get(CPU, 0.0)

    # -- called with the condition held -------------------------------------

    def _spawn_for(self, env_key: tuple) -> None:
        """Start workers until the queued tasks of ``env_key`` have a free
        worker each (retiring idle workers of other signatures while the
        pool is at ``max_workers``; a placed task gets a worker even
        past it)."""
        queued = len(self.queues.get(env_key, ()))
        free_here = sum(1 for w in self.workers
                        if w.env_key == env_key and not w.busy
                        and not w.retire)
        while free_here < queued:
            if len(self.workers) >= self.max_workers:
                idle = [w for w in self.workers if w.env_key != env_key
                        and not w.busy and not w.retire]
                if idle:
                    idle[0].retire = True
                    self.workers.remove(idle[0])
                    self.cv.notify_all()
            self._add_worker(env_key)
            free_here += 1

    def _add_worker(self, env_key: tuple) -> None:
        w = _WorkerHandle(self, env_key)
        self.workers.append(w)
        w.thread.start()

    # -- the API ---------------------------------------------------------------

    def prestart(self, env_key: tuple, n: int) -> None:
        with self.cv:
            for _ in range(min(n, self.max_workers) - len(self.workers)):
                self._add_worker(env_key)

    def dispatch(self, task: _Task) -> None:
        """The scheduler placed ``task`` (its booking is held): pack its
        arguments, take its cards, and queue it for a worker."""
        spec = task.spec
        self.node.drop_deps(spec)
        if task.args_desc is None and not _pack_args(task):
            self.node.give_back(spec, [])
            return
        task.cards = self.node.take_cards(spec)
        task.booked = True
        env = dict(_device_env(task.opts["device"]))
        env.update(task.opts["env_vars"])
        rt_env = spec.runtime_env or {}
        env.update({k: str(v) for k, v in
                    (rt_env.get("env_vars") or {}).items()})
        env.update(self.node.card_env(task.cards))
        env.update(self.cgroup.spawn_env())
        if rt_env and not _runtime_env.pip_env_ready(rt_env):
            # A venv is built once per signature, off the scheduler's
            # thread (minutes, for a cold one).
            from . import _sanitizer
            _sanitizer.spawn(self._setup_then_queue,
                             args=(task, env, rt_env),
                             name="runtime-env-setup")
            return
        self._setup_then_queue(task, env, rt_env)

    def _setup_then_queue(self, task: _Task, env: Dict[str, str],
                          rt_env: Dict[str, Any]) -> None:
        try:
            env.update(_runtime_env.node_setup_env_vars(rt_env or None))
        except Exception as e:  # noqa: BLE001 - the task's own error
            self._give_back(task)
            _fail_task(task, e if isinstance(e, RayTpuError)
                       else RuntimeEnvSetupError(f"{type(e).__name__}: {e}"))
            return
        task.env_key = tuple(sorted(env.items()))
        with self.cv:
            if self.closed:
                _fail_task(task, RayTpuError("the session was shut down"))
                return
            self.queues.setdefault(task.env_key, collections.deque()
                                   ).append(task)
            self._spawn_for(task.env_key)
            self.cv.notify_all()

    def next_task(self, w: _WorkerHandle) -> Optional[_Task]:
        with self.cv:
            while True:
                if self.closed or w.retire:
                    return None
                q = self.queues.get(w.env_key)
                if q:
                    task = q.popleft()
                    task.started = time.monotonic()
                    w.busy = True
                    w.task = task
                    return task
                self.cv.wait()

    def task_finished(self, w: _WorkerHandle, task: _Task,
                      requeued: bool) -> None:
        held_cards = bool(task.cards)
        if not requeued:
            self._give_back(task)
            # The arguments' refs go; their segments with the last ref.
            task.arg_refs = None
            task.args_ref = None
            with self.req_lock:
                task.nested = None
        with self.cv:
            w.busy = False
            w.task = None
            if held_cards:
                # A worker that held cards is not pooled (JAX: its process
                # must exit before the cards are reusable; here its CUDA
                # context and cached blocks go with it).
                w.retire = True
                if w in self.workers:
                    self.workers.remove(w)
            # A task of another signature that came while the pool was
            # full of busy workers has none of its own: this worker, idle
            # now, may make room for it.
            for key, q in list(self.queues.items()):
                if q and key != w.env_key:
                    self._spawn_for(key)
            self.cv.notify_all()

    def _give_back(self, task: _Task) -> None:
        """Return ``task``'s booking (less the CPU it gave up while blocked
        in ``get``) and its cards, once."""
        with self.req_lock:
            if not task.booked:
                return
            task.booked = False
            released, task.cpu_released = task.cpu_released, False
            cards, task.cards = task.cards, None
        spec = task.spec
        rest = None
        if released:
            rest = ResourceSet({k: v for k, v in spec.resources.items()
                                if k != CPU})
        self.node.give_back(spec, cards or [], rest)

    def blocked(self, task: _Task) -> None:
        """``task``'s worker waits in ``get``: its CPU goes back to the
        scheduler until the task ends (the tail after the wait runs
        unbooked, as a worker that unblocks does in JAX's reference).
        Once a task: its threads may wait at the same time."""
        with self.req_lock:
            if not task.booked or task.cpu_released or \
                    not task.spec.resources.get(CPU) > 0:
                return
            task.cpu_released = True
        self.node.scheduler.release(
            self.node.node_id,
            ResourceSet({CPU: task.spec.resources.get(CPU)}),
            task.spec.placement_group, task.spec.bundle_index)

    def worker_died(self, w: _WorkerHandle, task: _Task, code) -> bool:
        """True when ``task`` is placed again (a fresh worker, and fresh
        cards, take it), False when it failed."""
        with self.cv:
            closed = self.closed
        if closed:
            _fail_task(task, RayTpuError("the session was shut down"))
            return False
        self._give_back(task)
        retries = task.opts["max_retries"]
        if task.attempts < retries:
            task.attempts += 1
            _count("task_retries")
            self.session.submit(task)
            return True
        why = w.death_reason
        cls = OutOfMemoryError if why else WorkerCrashedError
        _fail_task(task, cls(
            f"the worker process of task {task.name!r} exited with code "
            f"{code} (attempts {task.attempts + 1}, max_retries "
            f"{retries})" + (f": {why}" if why else "")))
        return False

    def worker_failed_to_start(self, w: _WorkerHandle,
                               e: BaseException) -> None:
        with self.cv:
            if w in self.workers:
                self.workers.remove(w)
            q = self.queues.pop(w.env_key, collections.deque())
        err = RayTpuError(f"a task worker failed to start: "
                          f"{type(e).__name__}: {e}")
        for task in q:
            self._give_back(task)
            _fail_task(task, err)

    # -- the OOM monitor's hooks (JAX: NodeManager.select_oom_victim) --------

    def select_oom_victim(self) -> Optional[_WorkerHandle]:
        """Idle workers first (killing them fails nothing), then busy ones
        by the retriable-LIFO policy."""
        with self.cv:
            for w in self.workers:
                if not w.busy and not w.retire and w.proc is not None:
                    return w
            candidates = [(w, w.task.attempts < w.task.opts["max_retries"],
                           w.task.started)
                          for w in self.workers
                          if w.busy and w.task is not None]
        return _memory_monitor.select_victim(candidates)

    def oom_kill_worker(self, w: _WorkerHandle, reason: str) -> None:
        w.death_reason = f"OOM-killed: {reason}"
        with self.cv:
            if not w.busy:
                w.retire = True
                if w in self.workers:
                    self.workers.remove(w)
                self.cv.notify_all()
        if w.proc is not None and w.proc.is_alive():
            w.proc.kill()

    # -- nested tasks: what a worker asks while its task runs -----------------

    def serve_request(self, task: _Task, req: tuple) -> tuple:
        kind = req[0]
        if kind == "submit":
            _, fn_blob, name, opts, args_desc = req
            try:
                out = _submit(self.session, fn_blob, name, opts,
                              args_desc=args_desc)
            except Exception as e:  # noqa: BLE001 - raised in the worker
                return ("error", _error_blob(e))
            refs = out if isinstance(out, list) else [out]
            with self.req_lock:
                if task.nested is None:
                    task.nested = []
                first = len(task.nested)
                task.nested.extend(refs)
            return ("submitted", list(range(first, first + len(refs))))
        if kind == "plane":
            from . import _actor
            plane = _actor._plane()
            return ("plane", plane.host, plane.port)
        if kind == "next":
            # A nested stream's next item: the driver's ref of it stays
            # with the task, so its segment outlives the worker's read.
            self.blocked(task)
            with self.req_lock:
                gen = task.nested[req[1]]
            try:
                ref = next(gen)
            except StopIteration:
                return ("end",)
            with self.req_lock:
                task.nested.append(ref)
            try:
                return ("value", ref._fut.result())
            except BaseException as e:  # noqa: BLE001 - the task's error
                return ("error", _error_blob(e))
        with self.req_lock:
            ref = task.nested[req[1]]
        if kind == "poll":
            if not ref._fut.done():
                return ("pending",)
        else:
            self.blocked(task)
        try:
            return ("value", ref._fut.result(timeout=req[2] if kind == "get"
                                             else 0))
        except cf.TimeoutError:
            return ("timeout",)
        except BaseException as e:  # noqa: BLE001 - the task's error
            return ("error", _error_blob(e))

    def close(self) -> None:
        with self.cv:
            self.closed = True
            workers = list(self.workers)
            self.workers.clear()
            queued = [t for q in self.queues.values() for t in q]
            self.queues.clear()
            self.cv.notify_all()
        self.memory_monitor.stop()
        for t in queued:
            _fail_task(t, RayTpuError("the session was shut down"))
        for w in workers:
            if w.proc is not None and w.proc.is_alive():
                w.proc.kill()
        for w in workers:
            w.thread.join(timeout=30)
            w.stop()
        self.cgroup.cleanup()


class _TaskSession:
    """``init``'s session: its id, its node (the scheduler and the cards)
    and its pool."""

    def __init__(self, num_cpus: float, namespace: str,
                 num_tpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None):
        self.id = uuid.uuid4().hex[:12]
        self.num_cpus = float(num_cpus)
        self.namespace = namespace
        self.node = _scheduler.Node(num_cpus, num_tpus, resources)
        self.pool = _Pool(self)
        self.ids = itertools.count()
        #: Tasks with the scheduler, not placed yet (failed at shutdown).
        self.unplaced: Dict[int, _Task] = {}
        self.lock = threading.Lock()

    def submit(self, task: _Task) -> None:
        """Queue ``task`` with the scheduler; the pool runs it once it is
        placed."""
        with self.lock:
            self.unplaced[task.tid] = task

        def placed(_spec, _node_id) -> None:
            with self.lock:
                self.unplaced.pop(task.tid, None)
            self.pool.dispatch(task)

        def failed(exc: BaseException) -> None:
            with self.lock:
                self.unplaced.pop(task.tid, None)
            _fail_task(task, exc)

        self.node.submit(task.spec, placed, failed)

    def close(self) -> None:
        """Stop the pool and the scheduler; fail what never ran."""
        self.pool.close()
        self.node.stop()
        with self.lock:
            left, self.unplaced = list(self.unplaced.values()), {}
        for task in left:
            _fail_task(task, RayTpuError("the session was shut down"))

    def __repr__(self):
        return (f"TaskSession({self.id}, num_cpus={self.num_cpus:g}, "
                f"namespace={self.namespace!r})")


_session: Optional[_TaskSession] = None
_session_lock = threading.Lock()


def init(num_cpus: Optional[float] = None, namespace: str = "default",
         ignore_reinit_error: bool = True, *,
         num_tpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         head_port: Optional[int] = None, address: Optional[str] = None,
         cluster_token: Optional[bytes] = None,
         state_dir: Optional[str] = None, **_compat: Any) -> _TaskSession:
    """Start the session in this process (JAX: ``ray_tpu.init``): the
    host as one node with ``num_cpus`` CPUs (default ``os.cpu_count()``),
    ``num_tpus`` cards (default: those detected) and ``resources``, its
    scheduler, and the task pool, the default signature's workers started
    now."""
    for arg, value in (("head_port", head_port), ("address", address),
                       ("cluster_token", cluster_token),
                       ("state_dir", state_dir)):
        if value is not None:
            raise _not_ported(f"init({arg}=...)", CLUSTER)
    global _session
    with _session_lock:
        if _session is not None:
            if ignore_reinit_error:
                return _session
            raise RuntimeError("ray_tpu_torch.init() already called")
        n = float(os.cpu_count() or 1) if num_cpus is None else float(
            num_cpus)
        if n <= 0:
            raise ValueError(f"num_cpus={num_cpus!r}: give at least 1")
        from . import _sanitizer
        _sanitizer.snapshot()
        _session = _TaskSession(n, namespace, num_tpus, resources)
        _session.pool.prestart((), _session.pool.max_workers)
        _session.pool.memory_monitor.start()
        return _session


def is_initialized() -> bool:
    """True in the process that called ``init()``, until ``shutdown()``."""
    return _session is not None


def shutdown() -> None:
    """End the session: stop its workers and its scheduler, fail its
    pending tasks, and unlink every segment of the session."""
    global _session
    with _session_lock:
        session, _session = _session, None
    if session is None:
        return
    session.close()
    with _owned_lock:
        _owned.clear()
        _contains.clear()
    for path in glob.glob(os.path.join(SHM_DIR, f"rtt_{session.id}_*")):
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


atexit.register(shutdown)


def session_segments(session: Optional[_TaskSession] = None) -> List[str]:
    """The session's segments now in ``/dev/shm`` (the current one's by
    default)."""
    session = session or _session
    if session is None:
        return []
    return sorted(glob.glob(os.path.join(SHM_DIR, f"rtt_{session.id}_*")))


def _require_session() -> _TaskSession:
    session = _session
    if session is None:
        raise RayTpuError("ray_tpu_torch.init() has not been called")
    return session


# -- remote functions ------------------------------------------------------------


def _fn_blob(fn) -> bytes:
    """``fn`` pickled by reference: a function as (module, qualname), which
    the worker imports (unwrapping a ``RemoteFunction``); any other
    callable (``functools.partial``, an instance) by ``pickle``."""
    if isinstance(fn, types.FunctionType):
        qual = fn.__qualname__
        if "<locals>" in qual or fn.__name__ == "<lambda>":
            raise _by_reference_rule(
                f"remote function {qual!r}",
                TypeError("a lambda or a function defined inside a "
                          "function"))
        return pickle.dumps(("fn", fn.__module__, qual))
    try:
        return pickle.dumps(("obj", pickle.dumps(
            fn, protocol=pickle.HIGHEST_PROTOCOL)))
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise _by_reference_rule(f"remote function {fn!r}", e) from e


@functools.lru_cache(maxsize=256)
def _resolve_fn(blob: bytes):
    kind, *rest = pickle.loads(blob)
    if kind == "obj":
        return pickle.loads(rest[0])
    module, qual = rest
    obj: Any = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj._fn if isinstance(obj, RemoteFunction) else obj


def _fn_name(fn) -> str:
    inner = fn.func if isinstance(fn, functools.partial) else fn
    return getattr(inner, "__name__", type(inner).__name__)


class RemoteFunction:
    """A function run as tasks (JAX: ``RemoteFunction``)."""

    def __init__(self, fn, **default_options):
        _check_options(default_options)
        self._fn = fn
        self._options = default_options
        self._blob: Optional[bytes] = None
        try:
            functools.update_wrapper(self, fn)
        except AttributeError:
            pass

    def options(self, **options) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(options)
        rf = RemoteFunction(self._fn, **merged)
        rf._blob = self._blob
        return rf

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {_fn_name(self._fn)!r} cannot be called "
            "directly; use .remote()")

    def remote(self, *args, **kwargs):
        if self._blob is None:
            self._blob = _fn_blob(self._fn)
        name = self._options.get("name") or _fn_name(self._fn)
        if _in_worker is not None:
            return _submit_from_worker(self._blob, name, self._options,
                                       args, kwargs)
        session = _require_session()
        return _submit(session, self._blob, name, self._options,
                       packed=_pack((args, kwargs),
                                    f"the arguments of {name}"))


def _submit(session: _TaskSession, fn_blob: bytes, name: str,
            opts: Dict[str, Any], packed=None, args_desc=None):
    """Submit one task of the session (from the driver, or on behalf of a
    worker with its arguments already sealed in ``args_desc``)."""
    num_returns = opts.get("num_returns", 1)
    streaming = num_returns == "streaming"
    if not streaming and (not isinstance(num_returns, int)
                          or num_returns < 1):
        raise ValueError(f"num_returns={num_returns!r}: a positive int "
                         "or 'streaming'")
    strategy, pg, bundle = _scheduler.normalize_strategy(opts)
    resources = task_resources(opts.get("num_cpus"), opts.get("num_tpus"),
                               opts.get("memory"), opts.get("resources"),
                               default_num_cpus=1.0)
    runtime_env = _runtime_env.prepare_runtime_env(opts.get("runtime_env"))
    refs: List[ObjectRef] = []
    tid = next(session.ids)
    if args_desc is not None:
        trace = opts.get("_trace")     # the worker recorded its submit
    else:
        from .util import tracing
        trace = tracing.submit_span(name, f"{tid:x}")
    task = _Task(
        tid=tid, name=name, fn_blob=fn_blob,
        opts={"num_returns": 1 if streaming else num_returns,
              "trace": trace,
              "streaming": streaming,
              "max_retries": 0 if streaming else int(opts.get(
                  "max_retries", DEFAULT_MAX_RETRIES)),
              "device": opts.get("device"),
              "env_vars": {k: str(v) for k, v in
                           (opts.get("env_vars") or {}).items()}},
        attempts=0, cpu_released=False,
        returns=[] if streaming else [cf.Future()
                                      for _ in range(num_returns)])
    if args_desc is not None:
        task.args_desc = args_desc
        if args_desc[0] == "shm":
            _adopt(args_desc)
            task.args_ref = _store_ref(args_desc, "args", owned=True)
        task.arg_refs = []
    else:
        meta, buffers, refs = packed
        task.arg_refs = (meta, buffers, refs)
    pending = [r for r in refs if not r._fut.done()]
    task.spec = session.node.new_spec(
        name, resources, deps=tuple(session.node.dep(r._fut)
                                    for r in pending),
        strategy=strategy, pg=pg, bundle=bundle, runtime_env=runtime_env)
    _count("tasks_submitted")
    out: Any
    if streaming:
        gen = ObjectRefGenerator(name)
        task.gen = weakref.ref(gen)
        out = gen
    else:
        refs_out = [ObjectRef(f, name, store=True, owned=True)
                    for f in task.returns]
        out = refs_out[0] if num_returns == 1 else refs_out
    session.submit(task)
    return out


def _pack_args(task: _Task) -> bool:
    """Seal ``task``'s arguments with the descriptors of the refs inside
    (every one resolved now); False when one failed (the task failed with
    its error)."""
    meta, buffers, refs = task.arg_refs
    try:
        keep: list = []
        descs = [_desc_of(r, keep) for r in refs]
        task.arg_refs = refs + keep
    except Exception as e:  # noqa: BLE001 - an argument's own error
        # As JAX's worker wraps the error it meets resolving the argument.
        task.arg_refs = None
        _fail_task(task, TaskError(e, task.name, "".join(
            traceback.format_exception(e))))
        return False
    task.args_desc = _encode(meta, buffers, descs)
    if task.args_desc[0] == "shm":
        _adopt(task.args_desc)
        # Held by the task until it ends; then collected and unlinked.
        task.args_ref = _store_ref(task.args_desc, "args", owned=True)
    return True


def _check_options(opts: Dict[str, Any]) -> None:
    unknown = set(opts) - _KNOWN_OPTIONS
    if unknown:
        raise ValueError(f"unknown task options {sorted(unknown)}")


# -- nested tasks (in a worker) ----------------------------------------------------


class _DriverLink:
    """A worker's side of its task pipe: a reader thread hands each task
    to the worker's loop (``next_task``) and each answer to the request
    waiting for it, so several threads of a task may ask the driver at
    once (each request carries an id; the driver answers one that waits
    from a thread of its own)."""

    def __init__(self, conn):
        self.conn = conn
        self.send_lock = threading.Lock()
        self.ids = itertools.count(1)
        #: Request id -> [answered, answer]; the answer None once the
        #: pipe is gone.
        self.waiting: Dict[int, list] = {}
        self.waiting_lock = threading.Lock()
        self.tasks: "queue.Queue" = queue.Queue()
        from . import _sanitizer
        _sanitizer.spawn(self._read, name="task-worker-link")

    def _read(self) -> None:
        while True:
            try:
                msg = pickle.loads(self.conn.recv_bytes())
            except (EOFError, OSError):
                break
            if msg[0] != "reply":
                self.tasks.put(msg)
                continue
            with self.waiting_lock:
                slot = self.waiting.pop(msg[1], None)
            if slot is not None:
                slot[1] = msg[2]
                slot[0].set()
        self.tasks.put(None)
        with self.waiting_lock:
            slots, self.waiting = list(self.waiting.values()), {}
        for slot in slots:
            slot[0].set()

    def next_task(self) -> Optional[tuple]:
        """The next task's message, or None once the pipe is gone."""
        return self.tasks.get()

    def send(self, msg: tuple) -> None:
        data = pickle.dumps(msg, protocol=5)
        with self.send_lock:
            self.conn.send_bytes(data)

    def request(self, msg: tuple) -> tuple:
        """Send ``(kind, *args)`` as ``(kind, id, *args)`` and wait for its
        answer."""
        rid = next(self.ids)
        slot = [threading.Event(), None]
        with self.waiting_lock:
            self.waiting[rid] = slot
        self.send((msg[0], rid) + tuple(msg[1:]))
        slot[0].wait()
        if slot[1] is None:
            raise RayTpuError("the driver's end of the task pipe closed")
        return slot[1]


class _NestedFuture(cf.Future):
    """The future of a nested task's ref in the worker that submitted it:
    ``result`` asks the driver (which gives up the task's CPU while it
    waits), ``done`` polls it."""

    def __init__(self, link: _DriverLink, key: int):
        super().__init__()
        self._link = link
        self._key = key

    def _settle(self, reply: tuple) -> bool:
        if reply[0] == "value":
            self.set_result(reply[1])
        elif reply[0] == "error":
            self.set_exception(pickle.loads(reply[1]))
        else:
            return False
        return True

    def done(self) -> bool:
        return super().done() or self._settle(
            self._link.request(("poll", self._key)))

    def result(self, timeout=None):
        if not super().done() and not self._settle(
                self._link.request(("get", self._key, timeout))):
            raise cf.TimeoutError()
        return super().result(0)


def _submit_from_worker(fn_blob: bytes, name: str, opts: Dict[str, Any],
                        args: tuple, kwargs: dict):
    """``.remote()`` inside a task: the driver's scheduler places it (JAX:
    a worker submits through its node to the same scheduler)."""
    link = _in_worker.get("link")
    if link is None:
        raise RayTpuError("a task is submitted from a task worker only "
                          "while one of its tasks runs")
    meta, buffers, refs = _pack((args, kwargs), f"the arguments of {name}")
    args_desc = _encode(meta, buffers, [_desc_of(r) for r in refs])
    from .util import tracing
    opts = dict(opts, _trace=tracing.submit_span(name, "nested"))
    reply = link.request(("submit", fn_blob, name, opts, args_desc))
    if reply[0] == "error":
        raise pickle.loads(reply[1])
    if opts.get("num_returns") == "streaming":
        return _NestedGenerator(link, reply[1][0], name)
    out = [ObjectRef(_NestedFuture(link, k), name, store=True)
           for k in reply[1]]
    return out[0] if len(out) == 1 else out


def _driver_plane():
    """The driver's actor store, as a client (a task worker calling an
    actor: a ``Queue``, a handle passed as an argument)."""
    plane = _in_worker.get("plane")
    if plane is None:
        link = _in_worker.get("link")
        if link is None:
            raise RayTpuError("an actor is called from a task worker only "
                              "while one of its tasks runs")
        _kind, host, port = link.request(("plane",))
        from ._control import ControlPlane
        plane = _in_worker["plane"] = ControlPlane.connect(host, port)
    return plane


class _NestedGenerator(ObjectRefGenerator):
    """A streaming task's items in the worker that submitted it: each
    ``next`` asks the driver for the stream's next item (the driver
    gives up the task's CPU while it waits), so items arrive while the
    producer still runs.  The driver keeps the items' refs with the
    task."""

    def __init__(self, link: _DriverLink, key: int, name: str):
        self._link = link
        self._key = key
        self._name = name
        self._done = False

    def __del__(self):
        pass

    def __next__(self) -> ObjectRef:
        if self._done:
            raise StopIteration
        reply = self._link.request(("next", self._key))
        if reply[0] == "end":
            self._done = True
            raise StopIteration
        if reply[0] == "error":
            self._done = True
            return _resolved(exc=pickle.loads(reply[1]), name=self._name)
        return _store_ref(reply[1], self._name)


# -- the worker process ----------------------------------------------------------


def _watch_parent(parent: int) -> None:
    while True:
        if os.getppid() != parent:
            os._exit(0)
        time.sleep(0.5)


def _boot_worker_env() -> None:
    """Isolation and runtime env of a worker, applied before any task:
    the rlimit tier, ``working_dir``/``py_modules``, and a pip env's venv
    site directory ahead of the parent's paths (spawn gives the child the
    parent's ``sys.path``)."""
    _cgroup.apply_worker_rlimits()
    _runtime_env.apply_worker_env()
    if os.environ.get("RAY_TPU_PYTHON"):
        import site
        import sysconfig
        purelib = sysconfig.get_paths()["purelib"]
        if purelib in sys.path:
            sys.path.remove(purelib)
        sys.path.insert(0, purelib)
        site.addsitedir(purelib)


def _worker_main(conn, session_id: str, parent: int) -> None:
    """Entry point of a spawned task worker."""
    global _in_worker
    _in_worker = {"session": session_id, "link": None}
    from . import _sanitizer
    _sanitizer.spawn(_watch_parent, args=(parent,),
                     name="task-worker-watch-parent")
    _boot_worker_env()
    pid = os.getpid()
    last_snap = None
    from .util import tracing
    conn.send_bytes(pickle.dumps(("ready", pid)))
    link = _DriverLink(conn)
    while True:
        msg = link.next_task()
        if msg is None:
            return
        _kind, tid, name, fn_blob, args_desc, opts = msg

        def snap():
            """(telemetry if it changed, user metrics if recorded since
            the last task, finished spans), or None when all are empty."""
            nonlocal last_snap
            tel_snap = user = None
            tel = sys.modules.get("ray_tpu_torch.util.telemetry")
            if tel is not None:
                s = tel.snapshot()
                if s and s != last_snap:
                    tel_snap = last_snap = s
            metrics = sys.modules.get("ray_tpu_torch.util.metrics")
            if metrics is not None:
                user = metrics.take_dirty_snapshots()
            tracing = sys.modules.get("ray_tpu_torch.util.tracing")
            spans = tracing._drain() if tracing is not None else None
            if not (tel_snap or user or spans):
                return None
            return tel_snap, user, spans

        _in_worker["link"] = link
        try:
            fn = _resolve_fn(fn_blob)
            args, kwargs = _load(args_desc)
            # Top-level refs become their values (JAX's worker resolves
            # them); refs nested in containers stay refs.
            args = [_load(a._fut.result()) if isinstance(a, ObjectRef)
                    else a for a in args]
            kwargs = {k: _load(v._fut.result()) if isinstance(v, ObjectRef)
                      else v for k, v in kwargs.items()}
            with tracing.task_span(opts.get("trace"), name, f"{tid:x}"):
                result = fn(*args, **kwargs)
                if opts["streaming"]:
                    for item in result:
                        inner: list = []
                        desc = _seal(item, f"an item of {name}", inner)
                        link.send(("item", tid, desc, inner))
            if opts["streaming"]:
                _in_worker["link"] = None
                link.send(("end", tid, pid, snap()))
                continue
            n = opts["num_returns"]
            values = [result] if n == 1 else list(result)
            if len(values) != n:
                raise ValueError(f"task {name!r} returned {len(values)} "
                                 f"values; num_returns={n}")
            inners: List[list] = [[] for _ in values]
            descs = [_seal(v, f"the result of {name}", i)
                     for v, i in zip(values, inners)]
            _in_worker["link"] = None
            link.send(("ok", tid, descs, inners, pid, snap()))
        except BaseException as e:  # noqa: BLE001 - back to the caller
            _in_worker["link"] = None
            err = e if isinstance(e, TaskError) else TaskError(
                e, name, traceback.format_exc())
            try:
                blob = pickle.dumps(err)
            except Exception:  # noqa: BLE001 - the cause won't pickle
                blob = pickle.dumps(TaskError(RuntimeError(repr(e)), name,
                                              traceback.format_exc()))
            link.send(("err", tid, blob, pid, snap()))

"""Remote functions (tasks): the task half of ``ray_tpu/_private/api.py``
(``RemoteFunction``, ``init``, ``is_initialized``, ``shutdown``) and the
task execution of ``ray_tpu/_private/worker.py``.

``init(num_cpus=...)`` starts the session: a pool of spawned worker
processes (``num_cpus`` of them at most, default ``os.cpu_count()``)
that run the functions ``remote`` wraps.  Workers are kept per env
signature (``env_vars`` and ``device``, fixed when the process starts) and
reused; the default signature's workers start at ``init``.  A task takes
``num_cpus`` (default 1) of the session's ``num_cpus`` slots while it
runs; nothing else is reserved.  A worker imports this package, numpy and
the function's module, and nothing of torch unless that module does.

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
dies runs again on a fresh worker up to ``max_retries`` times (default 3,
JAX's ``task_max_retries_default``), then fails with
``WorkerCrashedError``.  A task whose argument failed fails with a
``TaskError`` whose cause is that argument's error.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP
entry): the scheduler's options (``num_tpus``, ``resources``, ``memory``,
``placement_group``, ``scheduling_strategy``, ``runtime_env``), the
cluster arguments of ``init``, and a task submitting tasks.
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
import sys
import threading
import time
import traceback
import types
import uuid
import weakref
from typing import Any, Deque, Dict, List, Optional, Tuple

from ._actor import (ObjectRef, ObjectRefGenerator, RayTpuError, TaskError,
                     _by_reference_rule, _device_env, _spawn_env_lock)
from ._object_store import (SHM_DIR, _HostPickler, _layout, _read_parts,
                            _Segment, _write)

#: Values whose pickle is at most this many bytes travel inside their
#: descriptor (JAX: ``max_inline_object_size``).
INLINE_MAX = 100 * 1024
#: JAX's ``task_max_retries_default``.
DEFAULT_MAX_RETRIES = 3
_KNOWN_OPTIONS = frozenset(("num_returns", "max_retries", "name", "num_cpus",
                            "device", "env_vars"))
SCHEDULER = 'ROADMAP Queue 1 item 12, "scheduler tier"'
CLUSTER = 'ROADMAP Queue 1 item 13, "multi-node cluster"'
NESTED = 'ROADMAP Queue 1 item 12, "nested tasks"'
_SCHEDULER_OPTIONS = ("num_tpus", "resources", "memory", "placement_group",
                      "placement_group_bundle_index", "scheduling_strategy",
                      "runtime_env")


class WorkerCrashedError(RayTpuError):
    """The worker process died mid-task (JAX: ``WorkerCrashedError``)."""


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


def _seal(value: Any, what: str = "a task's value") -> tuple:
    """A descriptor of ``value`` (the refs inside it must be ready)."""
    meta, buffers, refs = _pack(value, what)
    return _encode(meta, buffers, [_desc_of(r) for r in refs])


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


def _adopt(desc: tuple) -> None:
    if desc[0] == "shm":
        with _owned_lock:
            _owned[desc[1]] = _owned.get(desc[1], 0) + 1


def _release(desc: tuple) -> None:
    if desc[0] != "shm":
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


# -- the session: a worker pool --------------------------------------------------


class _Task:
    """One submitted task: its function and packed arguments, the refs
    those hold (kept until it ends), its return futures or its stream."""

    __slots__ = ("tid", "name", "fn_blob", "arg_refs", "opts", "env_key",
                 "cpus", "attempts", "returns", "gen", "waiting", "lock",
                 "args_desc", "args_ref")

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
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="task-worker")

    def start_process(self) -> None:
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        parent, child = ctx.Pipe(duplex=True)
        env = dict(self.env_key)
        with _spawn_env_lock:
            # The child inherits the environment from its first
            # instruction (the same trick as the actors').
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                proc = ctx.Process(
                    target=_worker_main,
                    args=(child, self.pool.session_id, os.getpid()),
                    daemon=True, name="task-worker")
                proc.start()
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        child.close()
        self.proc, self.conn = proc, parent
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
        """Run one task: (the worker process died, the task was queued
        again)."""
        msg = pickle.dumps(("task", task.tid, task.name, task.fn_blob,
                            task.args_desc, task.opts),
                           protocol=pickle.HIGHEST_PROTOCOL)
        try:
            self.conn.send_bytes(msg)
            while True:
                reply = pickle.loads(self.conn.recv_bytes())
                if _apply_reply(task, reply):
                    return False, False
        except (EOFError, OSError, BrokenPipeError):
            pass
        self.conn.close()
        self.proc.join(timeout=5)
        return True, self.pool.worker_died(self, task, self.proc.exitcode)

    def stop(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
        if self.proc is not None and self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=10)


def _apply_reply(task: _Task, reply: tuple) -> bool:
    """Resolve ``task``'s refs from one message of its worker; True once
    the task has ended."""
    kind = reply[0]
    if kind == "item":
        gen = task.gen() if task.gen is not None else None
        desc = reply[2]
        _adopt(desc)
        if gen is None or not gen._put("desc", desc):
            _release(desc)
        return False
    snap = reply[-1]
    if snap:
        from .util import telemetry
        telemetry.merge_remote(f"task-worker-{reply[-2]}", snap)
    _count("tasks_run")
    if kind == "end":
        gen = task.gen() if task.gen is not None else None
        if gen is not None:
            gen._put("end")
    elif kind == "ok":
        for fut, desc in zip(task.returns, reply[2]):
            _adopt(desc)
            fut.set_result(desc)
    else:
        try:
            err = pickle.loads(reply[2])
        except Exception as e:  # noqa: BLE001 - its class is not here
            err = RayTpuError(f"task {task.name!r} failed and its error "
                              f"could not be loaded here: {e!r}")
        _fail_task(task, err)
    return True


def _fail_task(task: _Task, exc: BaseException) -> None:
    if task.gen is not None:
        gen = task.gen()
        if gen is not None:
            gen._put("err", exc)
        return
    for fut in task.returns:
        if not fut.done():
            fut.set_exception(exc)


class _Pool:
    def __init__(self, num_cpus: float, session_id: str):
        self.capacity = float(num_cpus)
        self.free = float(num_cpus)
        self.max_workers = max(1, int(math.ceil(num_cpus)))
        self.session_id = session_id
        self.cv = threading.Condition()
        self.queues: Dict[tuple, Deque[_Task]] = {}
        self.workers: List[_WorkerHandle] = []
        self.closed = False

    # -- called with the condition held -------------------------------------

    def _spawn_for(self, env_key: tuple) -> None:
        """Start workers until the queued tasks of ``env_key`` have a free
        worker each, within ``max_workers`` (retiring idle workers of
        other signatures to make room)."""
        queued = len(self.queues.get(env_key, ()))
        free_here = sum(1 for w in self.workers
                        if w.env_key == env_key and not w.busy
                        and not w.retire)
        while free_here < queued:
            if len(self.workers) >= self.max_workers:
                idle = [w for w in self.workers if w.env_key != env_key
                        and not w.busy and not w.retire]
                if not idle:
                    return
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

    def submit(self, task: _Task) -> None:
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
                if q and self.free >= q[0].cpus:
                    task = q.popleft()
                    self.free -= task.cpus
                    w.busy = True
                    return task
                self.cv.wait()

    def task_finished(self, w: _WorkerHandle, task: _Task,
                      requeued: bool) -> None:
        if not requeued:
            # The arguments' refs go; their segments with the last ref.
            task.arg_refs = None
            task.args_ref = None
        with self.cv:
            self.free += task.cpus
            w.busy = False
            # A task of another signature that came while the pool was
            # full of busy workers has none of its own: this worker, idle
            # now, may make room for it.
            for key, q in list(self.queues.items()):
                if q and key != w.env_key:
                    self._spawn_for(key)
            self.cv.notify_all()

    def worker_died(self, w: _WorkerHandle, task: _Task, code) -> bool:
        """True when ``task`` goes back to the front of its queue (a fresh
        worker takes it), False when it failed."""
        if self.closed:
            _fail_task(task, RayTpuError("the session was shut down"))
            return False
        retries = task.opts["max_retries"]
        if task.attempts < retries:
            task.attempts += 1
            _count("task_retries")
            with self.cv:
                self.queues.setdefault(task.env_key, collections.deque()
                                       ).appendleft(task)
                self.cv.notify_all()
            return True
        _fail_task(task, WorkerCrashedError(
            f"the worker process of task {task.name!r} exited with code "
            f"{code} (attempts {task.attempts + 1}, max_retries "
            f"{retries})"))
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
            _fail_task(task, err)

    def close(self) -> None:
        with self.cv:
            self.closed = True
            workers = list(self.workers)
            self.workers.clear()
            queued = [t for q in self.queues.values() for t in q]
            self.queues.clear()
            self.cv.notify_all()
        for t in queued:
            _fail_task(t, RayTpuError("the session was shut down"))
        for w in workers:
            if w.proc is not None and w.proc.is_alive():
                w.proc.kill()
        for w in workers:
            w.thread.join(timeout=30)
            w.stop()


class _TaskSession:
    """``init``'s session: its id, slots and pool."""

    def __init__(self, num_cpus: float, namespace: str):
        self.id = uuid.uuid4().hex[:12]
        self.num_cpus = float(num_cpus)
        self.namespace = namespace
        self.pool = _Pool(num_cpus, self.id)
        self.ids = itertools.count()

    def __repr__(self):
        return (f"TaskSession({self.id}, num_cpus={self.num_cpus:g}, "
                f"namespace={self.namespace!r})")


_session: Optional[_TaskSession] = None
_session_lock = threading.Lock()


def init(num_cpus: Optional[float] = None, namespace: str = "default",
         ignore_reinit_error: bool = True, *,
         num_tpus: Optional[int] = None, resources: Optional[dict] = None,
         head_port: Optional[int] = None, address: Optional[str] = None,
         cluster_token: Optional[bytes] = None,
         state_dir: Optional[str] = None, **_compat: Any) -> _TaskSession:
    """Start the session in this process (JAX: ``ray_tpu.init``): the
    task pool, ``num_cpus`` slots and workers (default ``os.cpu_count()``),
    the default signature's workers started now."""
    for arg, value in (("num_tpus", num_tpus), ("resources", resources)):
        if value is not None:
            raise _not_ported(f"init({arg}=...)", SCHEDULER)
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
        _session = _TaskSession(n, namespace)
        _session.pool.prestart(_env_key(None, None),
                               _session.pool.max_workers)
        return _session


def is_initialized() -> bool:
    """True in the process that called ``init()``, until ``shutdown()``."""
    return _session is not None


def shutdown() -> None:
    """End the session: stop its workers, fail its pending tasks, and
    unlink every segment of the session."""
    global _session
    with _session_lock:
        session, _session = _session, None
    if session is None:
        return
    session.pool.close()
    with _owned_lock:
        _owned.clear()
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
    if _in_worker is not None:
        raise _not_ported("submitting a task from inside a task", NESTED)
    session = _session
    if session is None:
        raise RayTpuError("ray_tpu_torch.init() has not been called")
    return session


def _env_key(device, env_vars) -> tuple:
    env = dict(_device_env(device),
               **{k: str(v) for k, v in (env_vars or {}).items()})
    return tuple(sorted(env.items()))


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
        session = _require_session()
        opts = self._options
        name = opts.get("name") or _fn_name(self._fn)
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns == "streaming"
        if not streaming and (not isinstance(num_returns, int)
                              or num_returns < 1):
            raise ValueError(f"num_returns={num_returns!r}: a positive int "
                             "or 'streaming'")
        cpus = float(opts.get("num_cpus", 1) or 0)
        if cpus > session.num_cpus:
            raise ValueError(
                f"task {name!r} asks num_cpus={cpus:g}, more than the "
                f"session's {session.num_cpus:g}")
        meta, buffers, refs = _pack((args, kwargs),
                                    f"the arguments of {name}")
        task = _Task(
            tid=next(session.ids), name=name, fn_blob=self._blob,
            opts={"num_returns": 1 if streaming else num_returns,
                  "streaming": streaming,
                  "max_retries": 0 if streaming else int(opts.get(
                      "max_retries", DEFAULT_MAX_RETRIES))},
            env_key=_env_key(opts.get("device"), opts.get("env_vars")),
            cpus=cpus, attempts=0, arg_refs=refs, lock=threading.Lock(),
            returns=[] if streaming else [cf.Future()
                                          for _ in range(num_returns)])
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
        pending = [r for r in refs if not r._fut.done()]
        task.waiting = len(pending) + 1
        packed = (meta, buffers)
        for r in pending:
            r._fut.add_done_callback(
                lambda _f, t=task: _dep_ready(session, t, packed))
        _dep_ready(session, task, packed)
        return out


def _dep_ready(session: _TaskSession, task: _Task, packed) -> None:
    """One dependency of ``task`` resolved (or the submit itself): once all
    have, pack the arguments with their descriptors and queue it."""
    with task.lock:
        task.waiting -= 1
        if task.waiting:
            return
    try:
        keep: list = []
        descs = [_desc_of(r, keep) for r in task.arg_refs]
        task.arg_refs = task.arg_refs + keep
    except Exception as e:  # noqa: BLE001 - an argument's own error
        # As JAX's worker wraps the error it meets resolving the argument.
        task.arg_refs = None
        _fail_task(task, TaskError(e, task.name, "".join(
            traceback.format_exception(e))))
        return
    task.args_desc = _encode(*packed, descs)
    if task.args_desc[0] == "shm":
        _adopt(task.args_desc)
        # Held by the task until it ends; then collected and unlinked.
        task.args_ref = _store_ref(task.args_desc, "args", owned=True)
    session.pool.submit(task)


def _check_options(opts: Dict[str, Any]) -> None:
    for k in opts:
        if k in _SCHEDULER_OPTIONS:
            raise _not_ported(f"the task option {k!r}", SCHEDULER)
    unknown = set(opts) - _KNOWN_OPTIONS
    if unknown:
        raise ValueError(f"unknown task options {sorted(unknown)}")


# -- the worker process ----------------------------------------------------------


def _watch_parent(parent: int) -> None:
    while True:
        if os.getppid() != parent:
            os._exit(0)
        time.sleep(0.5)


def _worker_main(conn, session_id: str, parent: int) -> None:
    """Entry point of a spawned task worker."""
    global _in_worker
    _in_worker = {"session": session_id}
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True,
                     name="task-worker-watch-parent").start()
    pid = os.getpid()
    last_snap = None
    conn.send_bytes(pickle.dumps(("ready", pid)))
    while True:
        try:
            msg = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            return
        _kind, tid, name, fn_blob, args_desc, opts = msg

        def send(reply):
            conn.send_bytes(pickle.dumps(reply, protocol=5))

        def snap():
            nonlocal last_snap
            tel = sys.modules.get("ray_tpu_torch.util.telemetry")
            if tel is None:
                return None
            s = tel.snapshot()
            if not s or s == last_snap:
                return None
            last_snap = s
            return s

        try:
            fn = _resolve_fn(fn_blob)
            args, kwargs = _load(args_desc)
            # Top-level refs become their values (JAX's worker resolves
            # them); refs nested in containers stay refs.
            args = [_load(a._fut.result()) if isinstance(a, ObjectRef)
                    else a for a in args]
            kwargs = {k: _load(v._fut.result()) if isinstance(v, ObjectRef)
                      else v for k, v in kwargs.items()}
            result = fn(*args, **kwargs)
            if opts["streaming"]:
                for item in result:
                    send(("item", tid, _seal(item, f"an item of {name}")))
                send(("end", tid, pid, snap()))
                continue
            n = opts["num_returns"]
            values = [result] if n == 1 else list(result)
            if len(values) != n:
                raise ValueError(f"task {name!r} returned {len(values)} "
                                 f"values; num_returns={n}")
            descs = [_seal(v, f"the result of {name}") for v in values]
            send(("ok", tid, descs, pid, snap()))
        except BaseException as e:  # noqa: BLE001 - back to the caller
            err = e if isinstance(e, TaskError) else TaskError(
                e, name, traceback.format_exc())
            try:
                blob = pickle.dumps(err)
            except Exception:  # noqa: BLE001 - the cause won't pickle
                blob = pickle.dumps(TaskError(RuntimeError(repr(e)), name,
                                              traceback.format_exc()))
            send(("err", tid, blob, pid, snap()))

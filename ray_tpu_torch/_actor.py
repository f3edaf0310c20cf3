"""Process actors: the part of ``ray_tpu/_private/api.py`` that the port's
process tier calls (``remote``, ``ActorClass.options(...).remote``,
``ActorHandle`` and ``ActorMethod.remote``, ``ObjectRef``,
``ObjectRefGenerator``, ``get``, ``wait``, ``put``, ``kill``).  ``remote``
on a function, the refs of tasks and ``put`` after ``init()`` are the task
tier's (``_tasks``): such a ref holds a shared-memory descriptor, pickles
as it, and is read at ``get``.

An actor is a process started with ``torch.multiprocessing``'s ``spawn``
context (CUDA forbids ``fork`` once the caller holds a context).  The first
``.remote()`` of a process starts this process's ``_control.py`` store
server; each actor connects to it as a client, listens on a local socket
and publishes its address there (``actor/<id>/addr``).  A caller opens one
connection per actor (``multiprocessing.connection``, authenticated with
the session's key, which spawned children inherit), so a handle works from
the main process and from other actors alike.  Calls and results travel
over that connection as pickles:

- calls from one caller reach the actor in order; the actor runs them one
  at a time, in arrival order, unless ``max_concurrency > 1``, when that
  many threads take them;
- ``ActorMethod.options(num_returns="streaming")`` runs a generator method:
  each yielded item comes back as it is made, and the caller iterates an
  ``ObjectRefGenerator`` of refs;
- an exception raised by a method comes back as ``TaskError`` (its
  ``cause`` the exception); a dead actor fails every call in flight and
  every later one with ``ActorError``.

Classes, functions and arguments pickle by reference, as ``TorchTrainer``'s
train fn does: the port has no ``cloudpickle``, so an actor class, and every
function an argument holds, must be defined at the top level of a module.
A lambda or a nested function raises ``ValueError`` at ``.remote()``.  A
class decorated with ``@remote`` pickles through its module's name (the
module attribute is the ``ActorClass``; the actor unwraps it).

Actors are daemon processes; each also watches its parent's pid and exits
when it is gone, and ``shutdown()`` (also run at exit) kills every actor
this process started.  An ``ObjectRef`` passed as a top-level argument is
resolved to its value before the call is sent (a pending one waits); a
task's ref may also sit inside an argument (it crosses as its
descriptor), an actor call's may not.

``handle.__ray_call__.remote(fn, *args)`` runs ``fn(instance, *args)`` in
the actor as an ordinary call (in its turn, on a call thread), as the JAX
worker applies it; a compiled DAG's resident loop runs so.
``side_call(handle, fn, *args)`` runs ``fn(instance, *args)`` on the actor's
main thread, which takes no other calls, so it answers while every call
thread is busy (a profile capture runs there: ``torch.profiler`` traces
the card only when its first use in a process is on the thread that
imported torch).

Options: ``max_concurrency`` (threads taking calls, default 1),
``device``, ``num_cpus`` (torch's intra-op threads in the actor) and
``env_vars`` (set before the actor's interpreter starts).  ``device``
``"cuda:<i>"`` makes card ``i`` (of the caller's) the actor's only visible
card, its ``"cuda"`` in every thread (CUDA's current device is a
per-thread setting, so ``set_device`` would not reach the threads that run
the calls); ``"cpu"`` hides the cards; None leaves the caller's.
``name``/``namespace`` register the actor for ``get_actor`` (and
``get_if_exists`` returns the registered one).

With ``init()``'s session up, an actor is booked through the session's
scheduler as JAX's are (``num_cpus``, default 0; ``num_tpus``, its cards;
``memory``; ``resources``; ``placement_group``; ``scheduling_strategy``;
``runtime_env``): its process starts once it is placed, pinned to its
granted cards, and the booking goes back when the process exits.  Without
a session nothing is reserved, and those options raise.
"""

from __future__ import annotations

import atexit
import concurrent.futures as cf
import contextlib
import itertools
import os
import pickle
import queue
import sys
import threading
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: Seconds a caller waits for a new actor to publish its address (a spawned
#: interpreter imports torch and the actor's module first).
CONNECT_TIMEOUT_S = 300.0
_KNOWN_OPTIONS = frozenset((
    "max_concurrency", "device", "num_cpus", "env_vars", "name", "namespace",
    "get_if_exists", "num_tpus", "resources", "memory", "placement_group",
    "placement_group_bundle_index", "scheduling_strategy", "runtime_env"))
#: The options that need the scheduler (``init()``'s session).
_SCHEDULED_OPTIONS = ("num_tpus", "resources", "memory", "placement_group",
                      "scheduling_strategy", "runtime_env")
#: The method name that runs ``fn(instance, *args)`` (``__ray_call__``).
_RAY_CALL = "__ray_call__"


class RayTpuError(Exception):
    """Base of the actor runtime's errors (JAX: ``RayTpuError``)."""


class TaskError(RayTpuError):
    """An actor method raised; re-raised at ``get`` with the remote
    traceback (JAX: ``TaskError``)."""

    def __init__(self, cause: BaseException, task_name: str = "",
                 remote_traceback: str = ""):
        self.cause = cause
        self.task_name = task_name
        self.remote_traceback = remote_traceback
        super().__init__(
            f"task {task_name!r} failed: {type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{remote_traceback}")

    def __reduce__(self):
        return (TaskError, (self.cause, self.task_name,
                            self.remote_traceback))


class ActorError(RayTpuError):
    """The actor died before or while running the method (JAX:
    ``ActorError``)."""

    def __init__(self, actor_id: Any = None, cause: Optional[str] = None):
        self.actor_id = actor_id
        self.reason = cause
        super().__init__(
            f"actor {actor_id} is dead: {cause or 'unknown cause'}")

    def __reduce__(self):
        return (ActorError, (self.actor_id, self.reason))


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` ran out of time (JAX: ``GetTimeoutError``)."""


# -- pickling by reference ----------------------------------------------------


def _by_reference_rule(what: str, e: BaseException) -> ValueError:
    return ValueError(
        f"{what} must pickle by reference: actors and task workers "
        f"import classes and functions by module and name (no "
        f"cloudpickle), so define them at the top level of a module; "
        f"lambdas and nested functions cannot be sent "
        f"({type(e).__name__}: {e})")


def _dumps(obj: Any, what: str) -> bytes:
    try:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise _by_reference_rule(what, e) from e


def _class_ref(cls: type) -> Tuple[str, str]:
    qualname = cls.__qualname__
    if "<locals>" in qualname:
        raise _by_reference_rule(f"actor class {qualname!r}",
                                 TypeError("defined inside a function"))
    return cls.__module__, qualname


def _resolve_class(module: str, qualname: str) -> type:
    import importlib
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj._cls if isinstance(obj, ActorClass) else obj


# -- the session (one per process) --------------------------------------------


class _Session:
    """This process's store server (started at the first actor it creates)
    and the actors it started."""

    def __init__(self):
        from . import _sanitizer
        from ._control import ControlPlane, current, set_current
        _sanitizer.snapshot(first=True)
        self.plane = ControlPlane.serve()
        try:
            current()
        except RuntimeError:
            set_current(self.plane)
        self.procs: Dict[str, Any] = {}
        #: The threads that give a booked actor's resources back once its
        #: process exits (joined at shutdown).
        self.watchers: List[threading.Thread] = []
        self.lock = threading.Lock()


_session: Optional[_Session] = None
_session_lock = threading.Lock()
#: Held while ``os.environ`` carries a child's environment for a spawn
#: (actors here, task workers in ``_tasks``).
_spawn_env_lock = threading.Lock()
#: In an actor process: its store client and options.
_in_actor: Optional[Dict[str, Any]] = None


def _plane():
    """The store this process reaches actors through: the session's, or in
    an actor, the client it was started with."""
    global _session
    if _in_actor is not None:
        return _in_actor["plane"]
    from . import _tasks
    if _tasks._in_worker is not None:
        return _tasks._driver_plane()
    with _session_lock:
        if _session is None:
            _session = _Session()
        return _session.plane


# -- object refs --------------------------------------------------------------


class ObjectRef:
    """A result that may still be coming (JAX: ``ObjectRef``).

    Two kinds: an actor call's or a ``put`` before ``init()`` holds its
    value in the future (``store`` False); a task's or a ``put`` after
    ``init()`` holds a store descriptor there (``_tasks``), read at
    ``get``.  ``owned``: this process owns the descriptor's segment, which
    goes when the last owned ref of it is collected."""

    __slots__ = ("_fut", "_name", "_store", "_owned")

    def __init__(self, fut: cf.Future, name: str = "", store: bool = False,
                 owned: bool = False):
        self._fut = fut
        self._name = name
        self._store = store
        self._owned = owned

    def future(self) -> cf.Future:
        return self._fut

    def __reduce__(self):
        if self._store:
            # Its descriptor, once ready (a failed task's error raises).
            from ._tasks import _ref_from_desc
            return (_ref_from_desc, (self._fut.result(), self._name))
        raise TypeError("an ObjectRef cannot be pickled into a value: pass "
                        "it as a top-level argument (resolved before the "
                        "call) or get() it first")

    def __del__(self):
        # At interpreter teardown the session's segments go with
        # ``shutdown`` (atexit); nothing is left to release one by one.
        if getattr(self, "_owned", False) and not sys.is_finalizing():
            from ._tasks import _release_when_done
            _release_when_done(self._fut)

    def __repr__(self):
        return f"ObjectRef({self._name}, done={self._fut.done()})"


def _resolved(value: Any = None, exc: Optional[BaseException] = None,
              name: str = "") -> ObjectRef:
    fut: cf.Future = cf.Future()
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(value)
    return ObjectRef(fut, name)


class ObjectRefGenerator:
    """Iterator over a streaming call's items (JAX:
    ``ObjectRefGenerator``): each ``next`` blocks for the next item and
    returns a ref holding it; an error ends the stream as its last ref."""

    def __init__(self, name: str):
        self._name = name
        self._items: "queue.Queue" = queue.Queue()
        self._done = False
        self._closed = False
        self._lock = threading.Lock()

    def _put(self, kind: str, value: Any = None) -> bool:
        """Queue one item; False once the generator was collected (the
        caller then frees a store item itself)."""
        with self._lock:
            if self._closed:
                return False
            self._items.put((kind, value))
            return True

    def __del__(self):
        # Store items (a task's stream) not consumed: their segments go
        # (at interpreter teardown, with ``shutdown``).
        if sys.is_finalizing():
            return
        with self._lock:
            self._closed = True
        from ._tasks import _release
        while True:
            try:
                kind, value = self._items.get_nowait()
            except queue.Empty:
                return
            if kind == "desc":
                _release(value)

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        if self._done:
            raise StopIteration
        kind, value = self._items.get()
        if kind == "end":
            self._done = True
            raise StopIteration
        if kind == "err":
            self._done = True
            return _resolved(exc=value, name=self._name)
        if kind == "desc":
            # The queue's count on the segment passes to the ref.
            from ._tasks import _store_ref
            return _store_ref(value, self._name, owned=True)
        return _resolved(value, name=self._name)

    def __repr__(self):
        return f"ObjectRefGenerator({self._name})"


# -- the caller's side of one actor -------------------------------------------


class _Channel:
    """One caller process's connection to one actor: a reader thread
    resolves the futures and streams of the calls in flight."""

    def __init__(self, actor_id: str):
        self.actor_id = actor_id
        self.lock = threading.Lock()
        self.conn = None
        self.dead: Optional[str] = None
        self.pending: Dict[int, Any] = {}
        self.ids = itertools.count()
        self.reader: Optional[threading.Thread] = None

    def _connect(self) -> None:
        """Connect once the actor has published its address (or fail with
        what it published instead, or its death)."""
        from multiprocessing.connection import Client
        plane = _plane()
        proc = _started_proc(self.actor_id)
        deadline = time.monotonic() + CONNECT_TIMEOUT_S
        while True:
            err = plane.kv_get(f"actor/{self.actor_id}/error")
            if err is not None:
                raise ActorError(self.actor_id, err.decode())
            addr = plane.kv_get(f"actor/{self.actor_id}/addr")
            if addr is not None:
                break
            if proc is not None and proc.exitcode is not None:
                raise ActorError(self.actor_id, f"process exited with code "
                                 f"{proc.exitcode} before it started")
            if time.monotonic() > deadline:
                raise ActorError(self.actor_id, "did not start within "
                                 f"{CONNECT_TIMEOUT_S} s")
            time.sleep(0.01)
        host, port, _pid = addr.decode().split(":")
        import multiprocessing as mp
        self.conn = Client((host, int(port)),
                           authkey=mp.current_process().authkey)
        from . import _sanitizer
        self.reader = _sanitizer.spawn(
            self._read, args=(self.conn,),
            name=f"actor-reader-{self.actor_id[:8]}")

    def submit(self, method: str, blob: bytes, streaming: bool, name: str,
               kind: str = "call", trace: Optional[str] = None):
        with self.lock:
            if self.dead is None and self.conn is None:
                try:
                    self._connect()
                except ActorError as e:
                    self.dead = e.reason
                except OSError as e:
                    self.dead = f"connecting failed: {e!r}"
            if self.dead is not None:
                err = ActorError(self.actor_id, self.dead)
                if streaming:
                    gen = ObjectRefGenerator(name)
                    gen._put("err", err)
                    return gen
                return _resolved(exc=err, name=name)
            call_id = next(self.ids)
            out = ObjectRefGenerator(name) if streaming else ObjectRef(
                cf.Future(), name)
            self.pending[call_id] = out
            try:
                self.conn.send_bytes(pickle.dumps(
                    (kind, call_id, method, blob, streaming, trace)))
            except (OSError, EOFError, BrokenPipeError) as e:
                self.pending.pop(call_id, None)
                self._fail_all(f"connection lost: {e!r}")
                err = ActorError(self.actor_id, self.dead)
                if streaming:
                    out._put("err", err)
                    return out
                return _resolved(exc=err, name=name)
        return out

    def _read(self, conn) -> None:
        while True:
            try:
                msg = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                with self.lock:
                    self._fail_all("the actor process exited")
                return
            except Exception as e:  # noqa: BLE001 - a result this process
                # cannot load (its class is not importable here): the
                # channel cannot tell whose it was, so every call fails.
                with self.lock:
                    self._fail_all(f"a result could not be loaded: {e!r}")
                conn.close()
                return
            kind, call_id = msg[0], msg[1]
            if kind == "spans":
                from .util import tracing
                tracing._record_many(msg[2])
                continue
            with self.lock:
                out = self.pending.get(call_id)
                if kind in ("ok", "err", "end"):
                    self.pending.pop(call_id, None)
            if out is None:
                continue
            if kind == "ok":
                out._fut.set_result(msg[2])
            elif kind == "err":
                _fail(out, msg[2])
            elif kind == "item":
                out._put("item", msg[2])
            elif kind == "end":
                out._put("end")

    def _fail_all(self, why: str) -> None:
        """Under ``self.lock``."""
        if self.dead is None:
            self.dead = why
        for out in self.pending.values():
            _fail(out, ActorError(self.actor_id, why))
        self.pending.clear()

    def close(self) -> None:
        """Close the connection, fail what is in flight, and wait (5 s at
        most) for the reader thread to end: the callers have killed the
        actor's process, and its end closes the reader's connection."""
        with self.lock:
            if self.conn is not None:
                try:
                    self.conn.close()
                except OSError:
                    pass
            self._fail_all("killed")
            reader = self.reader
        if reader is not None and reader is not threading.current_thread():
            reader.join(5.0)


def _fail(out, exc: BaseException) -> None:
    if isinstance(out, ObjectRefGenerator):
        out._put("err", exc)
    elif not out._fut.done():
        out._fut.set_exception(exc)


_channels: Dict[str, _Channel] = {}
_channels_lock = threading.Lock()


def _channel(actor_id: str) -> _Channel:
    with _channels_lock:
        ch = _channels.get(actor_id)
        if ch is None:
            ch = _channels[actor_id] = _Channel(actor_id)
        return ch


def _started_proc(actor_id: str):
    if _session is None:
        return None
    with _session.lock:
        return _session.procs.get(actor_id)


# -- handles ------------------------------------------------------------------


def _resolve_args(args: tuple, kwargs: dict) -> Tuple[tuple, dict]:
    """Top-level ObjectRef arguments -> their values (waiting for pending
    ones), as the JAX runtime resolves them on the actor's node."""
    if any(isinstance(a, ObjectRef) for a in args):
        args = tuple(get(a) if isinstance(a, ObjectRef) else a
                     for a in args)
    if any(isinstance(v, ObjectRef) for v in kwargs.values()):
        kwargs = {k: get(v) if isinstance(v, ObjectRef) else v
                  for k, v in kwargs.items()}
    return args, kwargs


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: Any = 1, kind: str = "call"):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        #: "call" (queued for the call threads) or "main" (the actor's main
        #: thread: ``side_call``).
        self._kind = kind

    def options(self, **opts) -> "ActorMethod":
        return ActorMethod(self._handle, self._name,
                           opts.get("num_returns", self._num_returns))

    def bind(self, *args, **kwargs):
        """A DAG node of this call (``ray_tpu_torch.dag``)."""
        from .dag import ClassMethodNode
        return ClassMethodNode(self._handle, self._name, args, kwargs)

    def remote(self, *args, **kwargs):
        n = self._num_returns
        if n != "streaming" and (not isinstance(n, int) or n < 1):
            raise ValueError(f"num_returns={n!r}: a positive int or "
                             "'streaming'")
        qual = f"{self._handle._class_name}.{self._name}"
        args, kwargs = _resolve_args(args, kwargs)
        blob = _dumps((args, kwargs), f"the arguments of {qual}")
        from .util import tracing
        trace = tracing.submit_span(qual, self._handle._actor_id[:16])
        out = _channel(self._handle._actor_id).submit(
            self._name, blob, n == "streaming", qual, self._kind, trace)
        return out if n in (1, "streaming") else _split(out, n, qual)


def _split(ref: ObjectRef, n: int, name: str) -> List[ObjectRef]:
    """N refs over one call's result, a sequence of N values (JAX: the
    N return ids of an actor task)."""
    futs = [cf.Future() for _ in range(n)]

    def done(fut: cf.Future) -> None:
        try:
            values = list(fut.result())
            if len(values) != n:
                raise ValueError(f"{name} returned {len(values)} values; "
                                 f"num_returns={n}")
        except BaseException as e:  # noqa: BLE001 - each ref raises it
            for f in futs:
                f.set_exception(e)
            return
        for f, v in zip(futs, values):
            f.set_result(v)

    ref._fut.add_done_callback(done)
    return [ObjectRef(f, name) for f in futs]


class ActorHandle:
    """A handle on one actor; it pickles, and works in any process of the
    session (JAX: ``ActorHandle``)."""

    def __init__(self, actor_id: str, class_name: str = "",
                 max_concurrency: int = 1):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_concurrency = max_concurrency

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        m = ActorMethod(self, name)
        self.__dict__[name] = m
        return m

    @property
    def __ray_call__(self) -> ActorMethod:
        """``__ray_call__.remote(fn, *args)``: ``fn(instance, *args)`` run
        in the actor as an ordinary call (JAX: the worker's
        ``__ray_call__``); ``fn`` pickles by reference."""
        return ActorMethod(self, _RAY_CALL)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name,
                              self._max_concurrency))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id})"


class ActorClass:
    def __init__(self, cls: type, **default_options):
        unknown = set(default_options) - _KNOWN_OPTIONS
        if unknown:
            raise ValueError(f"unknown actor options {sorted(unknown)}")
        self._cls = cls
        self._options = default_options

    def options(self, **options) -> "ActorClass":
        return ActorClass(self._cls, **dict(self._options, **options))

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__!r} cannot be instantiated "
            "directly; use .remote()")

    def remote(self, *args, **kwargs) -> ActorHandle:
        if _in_actor is not None:
            raise RuntimeError(
                "an actor cannot start actors: actors are daemon processes, "
                "which have no children; start them from the main process")
        opts = dict(self._options)
        name = opts.get("name")
        namespace = opts.get("namespace") or "default"
        if name and opts.get("get_if_exists"):
            try:
                return get_actor(name, namespace)
            except ValueError:
                pass
        module, qualname = _class_ref(self._cls)
        args, kwargs = _resolve_args(args, kwargs)
        init = _dumps((args, kwargs),
                      f"the constructor arguments of {qualname}")
        actor_id = uuid.uuid4().hex
        plane = _plane()
        spec = {"actor_id": actor_id, "cls": (module, qualname),
                "init": init, "host": plane.host, "port": plane.port,
                "parent": os.getpid(),
                "options": {k: v for k, v in opts.items()
                            if k != "env_vars"}}
        env = dict(_device_env(opts.get("device")),
                   **{k: str(v) for k, v in
                      (opts.get("env_vars") or {}).items()})
        max_conc = int(opts.get("max_concurrency") or 1)
        if name:
            plane.kv_put(_name_key(namespace, name),
                         f"{actor_id}:{self._cls.__name__}:{max_conc}"
                         .encode())
        from . import _tasks
        session = _tasks._session
        if session is None:
            given = [k for k in _SCHEDULED_OPTIONS if opts.get(k)]
            if given:
                raise RayTpuError(
                    f"actor options {given} book through the scheduler: "
                    "call ray_tpu_torch.init() first")
            _spawn_actor(actor_id, qualname, spec, env)
        else:
            _schedule_actor(session.node, actor_id, qualname, spec, env,
                            opts)
        return ActorHandle(actor_id, self._cls.__name__, max_conc)


@contextlib.contextmanager
def _child_environment(env: Dict[str, str]):
    """``env`` in force while a child process spawns (a spawned
    interpreter inherits the environment from its first instruction), and
    a pip runtime env's interpreter (``RAY_TPU_PYTHON``) as the one it
    runs.  Actors and task workers spawn under it."""
    from multiprocessing import spawn
    with _spawn_env_lock:
        old = {k: os.environ.get(k) for k in env}
        old_exe = spawn.get_executable()
        os.environ.update(env)
        if env.get("RAY_TPU_PYTHON"):
            spawn.set_executable(env["RAY_TPU_PYTHON"])
        try:
            yield
        finally:
            spawn.set_executable(old_exe)
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def _spawn_actor(actor_id: str, qualname: str, spec: Dict[str, Any],
                 env: Dict[str, str]):
    import torch.multiprocessing as mp
    with _session.lock, _child_environment(env):
        proc = mp.get_context("spawn").Process(
            target=_actor_main, args=(spec,), daemon=True,
            name=f"actor-{qualname}")
        proc.start()
        _session.procs[actor_id] = proc
    return proc


#: Actors killed before their placement came (their process never starts).
_killed_pending: set = set()


def _schedule_actor(node, actor_id: str, qualname: str,
                    spec: Dict[str, Any], env: Dict[str, str],
                    opts: Dict[str, Any]) -> None:
    """Book the actor (JAX: its creation task) and start its process once
    placed; the booking and its cards go back when the process exits."""
    from . import _runtime_env, _scheduler
    from ._resources import task_resources
    strategy, pg, bundle = _scheduler.normalize_strategy(opts)
    rt_env = _runtime_env.prepare_runtime_env(opts.get("runtime_env"))
    resources = task_resources(opts.get("num_cpus"), opts.get("num_tpus"),
                               opts.get("memory"), opts.get("resources"),
                               default_num_cpus=0.0)
    tspec = node.new_spec(f"{qualname}.__init__", resources,
                          strategy=strategy, pg=pg, bundle=bundle,
                          runtime_env=rt_env)

    def placed(_spec, _node_id) -> None:
        cards = node.take_cards(tspec)
        if actor_id in _killed_pending:
            node.give_back(tspec, cards)
            return
        full = dict(env)
        full.update({k: str(v) for k, v in
                     ((rt_env or {}).get("env_vars") or {}).items()})
        full.update(node.card_env(cards))
        try:
            full.update(_runtime_env.node_setup_env_vars(rt_env))
            proc = _spawn_actor(actor_id, qualname, spec, full)
        except BaseException:
            node.give_back(tspec, cards)
            raise

        def watch() -> None:
            proc.join()
            node.give_back(tspec, cards)

        from . import _sanitizer
        t = _sanitizer.spawn(watch, name=f"actor-booking-{actor_id[:8]}")
        with _session.lock:
            _session.watchers = [w for w in _session.watchers
                                 if w.is_alive()] + [t]

    def failed(exc: BaseException) -> None:
        _plane().kv_put(f"actor/{actor_id}/error",
                        f"{type(exc).__name__}: {exc}".encode())

    node.submit(tspec, placed, failed)


def _name_key(namespace: str, name: str) -> str:
    return f"actor/name/{namespace}/{name}"


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    """The actor registered under ``name`` (JAX: ``ray_tpu.get_actor``);
    ValueError when there is none or it has died."""
    raw = _plane().kv_get(_name_key(namespace or "default", name))
    if raw is None:
        raise ValueError(f"no actor named {name!r}")
    actor_id, cls_name, max_conc = raw.decode().split(":")
    handle = ActorHandle(actor_id, cls_name, int(max_conc))
    if is_dead(handle):
        raise ValueError(f"no actor named {name!r} (it has died)")
    return handle


def side_call(actor: ActorHandle, fn, *args, **kwargs) -> ObjectRef:
    """``fn(instance, *args, **kwargs)`` on the actor's main thread, beside
    its call threads: it runs even while every call thread is busy (a long
    call, a compiled DAG's loop); side calls run one at a time."""
    return ActorMethod(actor, _RAY_CALL, kind="main").remote(fn, *args,
                                                             **kwargs)


def live_actors() -> List[ActorHandle]:
    """Handles on the actors this process started that are still alive."""
    if _session is None:
        return []
    with _session.lock:
        procs = list(_session.procs.items())
    out = []
    for aid, p in procs:
        if p.is_alive():
            out.append(ActorHandle(aid, p.name[len("actor-"):]))
    return out


def _device_env(device) -> Dict[str, str]:
    """The environment that gives an actor its ``device`` option."""
    if device is None:
        return {}
    kind, _, index = str(device).partition(":")
    if kind == "cpu":
        return {"CUDA_VISIBLE_DEVICES": ""}
    if kind != "cuda":
        raise ValueError(f"actor device {device!r}: use 'cuda[:i]' or 'cpu'")
    if not index:
        return {}
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else None
    return {"CUDA_VISIBLE_DEVICES": cards[int(index)] if cards else index}


def remote(*args, **options):
    """``@remote`` / ``@remote(**options)`` (JAX: ``remote``): a class
    becomes an ``ActorClass``, a function a ``_tasks.RemoteFunction``."""
    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, **options)
        from ._tasks import RemoteFunction
        return RemoteFunction(target, **options)
    if len(args) == 1 and not options and callable(args[0]):
        return wrap(args[0])
    if args:
        raise TypeError("remote() takes keyword options only")
    return wrap


# -- module-level API ---------------------------------------------------------


def get(refs, timeout: Optional[float] = None):
    """The value of a ref, or of each ref of a list, waiting at most
    ``timeout`` seconds in all (then ``GetTimeoutError``)."""
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef, got "
                            f"{type(r).__name__}")
    deadline = None if timeout is None else time.monotonic() + timeout
    values = []
    for r in ref_list:
        left = None if deadline is None else max(0.0,
                                                 deadline - time.monotonic())
        try:
            value = r._fut.result(timeout=left)
        except cf.TimeoutError:
            raise GetTimeoutError(f"get timed out after {timeout} s "
                                  f"({r._name})") from None
        if r._store:
            from ._tasks import _load
            value = _load(value)
        values.append(value)
    return values[0] if single else values


def put(value: Any) -> ObjectRef:
    """A ref holding ``value``: after ``init()`` (and in a task) sealed in
    the session's store, so it crosses to tasks as a descriptor; before,
    a ref sent by value wherever it is passed."""
    from . import _tasks
    if _tasks.is_initialized() or _tasks._in_worker is not None:
        return _tasks.put(value)
    return _resolved(value, name="put")


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    """(ready, pending): the first ``num_returns`` refs to finish (in the
    order given), once that many have or ``timeout`` passes."""
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError(f"num_returns={num_returns} exceeds the "
                         f"{len(refs)} refs given")
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        done = [r for r in refs if r._fut.done()]
        if len(done) >= num_returns:
            break
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            break
        futs = [r._fut for r in refs if not r._fut.done()]
        if any(hasattr(f, "_link") for f in futs):
            # A nested task's refs in a task worker: their futures are
            # settled by asking the driver (``done`` polls), not by a
            # thread of this process.
            time.sleep(0.01 if left is None else min(0.01, left))
            continue
        cf.wait(futs, timeout=left, return_when=cf.FIRST_COMPLETED)
    ready = done[:num_returns]
    ids = {id(r) for r in ready}
    return ready, [r for r in refs if id(r) not in ids]


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    """Kill the actor's process; its calls in flight, and every later
    one, fail with ``ActorError``."""
    import signal
    _killed_pending.add(actor._actor_id)
    proc = _started_proc(actor._actor_id)
    if proc is not None:
        if proc.is_alive():
            proc.kill()
        proc.join(timeout=30)
    else:
        addr = _plane().kv_get(f"actor/{actor._actor_id}/addr")
        if addr is not None:
            try:
                os.kill(int(addr.decode().split(":")[2]), signal.SIGKILL)
            except ProcessLookupError:
                pass
    _channel(actor._actor_id).close()


def _forget(plane, actor_id: str) -> None:
    """Drop a dead actor's keys from the store: its address and error,
    and its user metrics (their last values folded into this process's
    view, so counters do not go back)."""
    for suffix in ("addr", "error"):
        plane.kv_del(f"actor/{actor_id}/{suffix}")
    metrics = sys.modules.get("ray_tpu_torch.util.metrics")
    if metrics is not None:
        metrics.retire_source(f"actor-{actor_id}")


def is_dead(actor: ActorHandle) -> bool:
    """True once the actor's process has exited (where this process
    started it) or its connection has failed."""
    proc = _started_proc(actor._actor_id)
    if proc is not None and proc.exitcode is not None:
        return True
    with _channels_lock:
        ch = _channels.get(actor._actor_id)
    return ch is not None and ch.dead is not None


def shutdown() -> None:
    """Kill every actor this process started and drop its store."""
    global _session
    with _session_lock:
        session, _session = _session, None
    if session is None:
        return
    with session.lock:
        procs = list(session.procs.items())
        session.procs.clear()
        watchers, session.watchers = session.watchers, []
    for _aid, p in procs:
        if p.is_alive():
            p.kill()
    for aid, p in procs:
        p.join(timeout=30)
        with _channels_lock:
            ch = _channels.pop(aid, None)
        if ch is not None:
            ch.close()
        _forget(session.plane, aid)
    for t in watchers:
        t.join(timeout=5.0)
    # The end-of-session sweep of the names (each points at an actor of
    # this session, all dead now).
    for key in session.plane.kv_keys("actor/name/"):
        session.plane.kv_del(key)
    from . import _control
    if _control._current is session.plane:
        _control.set_current(None)


atexit.register(shutdown)


# -- the actor process --------------------------------------------------------


class _Actor:
    """The actor side: the instance, the queue of calls, its threads."""

    def __init__(self, spec: Dict[str, Any]):
        self.spec = spec
        self.calls: "queue.Queue" = queue.Queue()
        #: Calls for the main thread (``side_call``).
        self.main_calls: "queue.Queue" = queue.Queue()
        self.instance = None
        self.init_error: Optional[str] = None

    def construct(self) -> None:
        module, qualname = self.spec["cls"]
        try:
            cls = _resolve_class(module, qualname)
            args, kwargs = pickle.loads(self.spec["init"])
            self.instance = cls(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - reported per call
            self.init_error = (f"the constructor of {qualname} raised "
                               f"{type(e).__name__}: {e}\n"
                               f"{traceback.format_exc()}")

    def serve_connection(self, conn) -> None:
        send_lock = threading.Lock()
        while True:
            try:
                msg = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                return
            if msg[0] == "main":
                self.main_calls.put((conn, send_lock, msg))
            else:
                self.calls.put((conn, send_lock, msg))

    def run_calls(self, calls: Optional["queue.Queue"] = None) -> None:
        calls = self.calls if calls is None else calls
        while True:
            conn, send_lock, (_kind, call_id, method, blob, streaming,
                              trace) = calls.get()
            self._run(conn, send_lock, call_id, method, blob, streaming,
                      trace)

    def _run(self, conn, send_lock, call_id, method, blob, streaming,
             trace=None):
        qual = f"{self.spec['cls'][1]}.{method}"

        def send(msg):
            try:
                data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
            except Exception as e:  # noqa: BLE001 - an unpicklable result
                data = pickle.dumps(("err", call_id, TaskError(
                    _by_reference_rule(f"the result of {qual}", e), qual,
                    traceback.format_exc())))
            with send_lock:
                try:
                    conn.send_bytes(data)
                except (OSError, EOFError):
                    pass

        if self.init_error is not None:
            send(("err", call_id, ActorError(self.spec["actor_id"],
                                             self.init_error)))
            return
        from .util import tracing
        try:
            with tracing.task_span(trace, qual, f"{call_id:x}"):
                args, kwargs = pickle.loads(blob)
                if method == _RAY_CALL:
                    result = args[0](self.instance, *args[1:], **kwargs)
                else:
                    result = getattr(self.instance, method)(*args, **kwargs)
                if streaming:
                    for item in result:
                        send(("item", call_id, item))
            _flush_call_side(send)
            send(("end", call_id) if streaming else ("ok", call_id, result))
        except BaseException as e:  # noqa: BLE001 - back to the caller
            err = TaskError(e, qual, traceback.format_exc())
            try:
                pickle.dumps(err)
            except Exception:  # noqa: BLE001 - the cause itself won't pickle
                err = TaskError(RuntimeError(repr(e)), qual,
                                traceback.format_exc())
            _flush_call_side(send)
            send(("err", call_id, err))


def _flush_call_side(send) -> None:
    """Before a call's reply: this process's finished spans go to the
    caller (ahead of the reply, so they are recorded once it resolves),
    and its user metrics to the session's store."""
    from .util import tracing
    spans = tracing._drain()
    if spans:
        send(("spans", -1, spans))
    metrics = sys.modules.get("ray_tpu_torch.util.metrics")
    if metrics is not None:
        metrics.flush_on_task_done()


def _watch_parent(parent: int) -> None:
    """Exit when the process that started this actor is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(0)
        time.sleep(0.5)


def _actor_main(spec: Dict[str, Any]) -> None:
    """Entry point of a spawned actor process."""
    global _in_actor
    import multiprocessing as mp
    from multiprocessing.connection import Listener

    import torch

    from ._control import ControlPlane, set_current
    from ._tasks import _boot_worker_env
    actor_id = spec["actor_id"]
    plane = ControlPlane.connect(spec["host"], spec["port"])
    set_current(plane)
    _boot_worker_env()
    opts = spec["options"]
    _in_actor = {"plane": plane, "options": opts, "actor_id": actor_id}
    from . import _sanitizer
    _sanitizer.spawn(_watch_parent, args=(spec["parent"],),
                     name="actor-watch-parent")
    try:
        if opts.get("num_cpus"):
            torch.set_num_threads(max(1, int(opts["num_cpus"])))
        listener = Listener(("127.0.0.1", 0),
                            authkey=mp.current_process().authkey)
    except BaseException as e:  # noqa: BLE001 - reported to the callers
        plane.kv_put(f"actor/{actor_id}/error",
                     f"{type(e).__name__}: {e}".encode())
        return
    actor = _Actor(spec)
    host, port = listener.address
    plane.kv_put(f"actor/{actor_id}/addr",
                 f"{host}:{port}:{os.getpid()}".encode())
    # Calls queue while the constructor runs; they start once it is done.
    _sanitizer.spawn(_accept, args=(listener, actor), name="actor-accept")
    actor.construct()
    n = max(1, int(opts.get("max_concurrency") or 1))
    workers = [threading.Thread(target=actor.run_calls, daemon=True,
                                name=f"actor-call-{i}") for i in range(n)]
    for t in workers:
        t.start()
    # The main thread takes side_call's calls, and nothing else, for the
    # life of the process.
    actor.run_calls(actor.main_calls)


def _accept(listener, actor: _Actor) -> None:
    while True:
        conn = listener.accept()
        from . import _sanitizer
        _sanitizer.spawn(actor.serve_connection, args=(conn,),
                         name="actor-conn")

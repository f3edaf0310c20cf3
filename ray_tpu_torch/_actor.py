"""Process actors: the part of ``ray_tpu/_private/api.py`` that the port's
process tier calls (``remote``, ``ActorClass.options(...).remote``,
``ActorHandle`` and ``ActorMethod.remote``, ``ObjectRef``,
``ObjectRefGenerator``, ``get``, ``wait``, ``put``, ``kill``).

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
resolved to its value before the call is sent (a pending one waits).

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
the calls); ``"cpu"`` hides the cards; None leaves the caller's.  There is
no scheduler: nothing is reserved.
"""

from __future__ import annotations

import atexit
import concurrent.futures as cf
import itertools
import os
import pickle
import queue
import threading
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: Seconds a caller waits for a new actor to publish its address (a spawned
#: interpreter imports torch and the actor's module first).
CONNECT_TIMEOUT_S = 300.0
_KNOWN_OPTIONS = frozenset(("max_concurrency", "device", "num_cpus",
                            "env_vars"))
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
        f"{what} must pickle by reference: actors import classes and "
        f"functions by module and name (no cloudpickle), so define them at "
        f"the top level of a module; lambdas and nested functions cannot "
        f"be sent ({type(e).__name__}: {e})")


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
        from ._control import ControlPlane, current, set_current
        self.plane = ControlPlane.serve()
        try:
            current()
        except RuntimeError:
            set_current(self.plane)
        self.procs: Dict[str, Any] = {}
        self.lock = threading.Lock()


_session: Optional[_Session] = None
_session_lock = threading.Lock()
#: In an actor process: its store client and options.
_in_actor: Optional[Dict[str, Any]] = None


def _plane():
    """The store this process reaches actors through: the session's, or in
    an actor, the client it was started with."""
    global _session
    if _in_actor is not None:
        return _in_actor["plane"]
    with _session_lock:
        if _session is None:
            _session = _Session()
        return _session.plane


# -- object refs --------------------------------------------------------------


class ObjectRef:
    """A result that may still be coming (JAX: ``ObjectRef``)."""

    __slots__ = ("_fut", "_name")

    def __init__(self, fut: cf.Future, name: str = ""):
        self._fut = fut
        self._name = name

    def future(self) -> cf.Future:
        return self._fut

    def __reduce__(self):
        raise TypeError("an ObjectRef cannot be pickled into a value: pass "
                        "it as a top-level argument (resolved before the "
                        "call) or get() it first")

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

    def _put(self, kind: str, value: Any = None) -> None:
        self._items.put((kind, value))

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
        threading.Thread(target=self._read, daemon=True,
                         name=f"actor-reader-{self.actor_id[:8]}").start()

    def submit(self, method: str, blob: bytes, streaming: bool, name: str,
               kind: str = "call"):
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
                    (kind, call_id, method, blob, streaming)))
            except (OSError, EOFError, BrokenPipeError) as e:
                self.pending.pop(call_id, None)
                self._fail_all(f"connection lost: {e!r}")
                err = ActorError(self.actor_id, self.dead)
                if streaming:
                    out._put("err", err)
                    return out
                return _resolved(exc=err, name=name)
        return out

    def _read(self) -> None:
        conn = self.conn
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
        with self.lock:
            if self.conn is not None:
                try:
                    self.conn.close()
                except OSError:
                    pass
            self._fail_all("killed")


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
        if self._num_returns not in (1, "streaming"):
            raise NotImplementedError(
                f"num_returns={self._num_returns!r}: actor methods of the "
                f"port return one value or stream (num_returns="
                f"'streaming')")
        qual = f"{self._handle._class_name}.{self._name}"
        args, kwargs = _resolve_args(args, kwargs)
        blob = _dumps((args, kwargs), f"the arguments of {qual}")
        return _channel(self._handle._actor_id).submit(
            self._name, blob, self._num_returns == "streaming", qual,
            self._kind)


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
        import torch.multiprocessing as mp
        env = dict(_device_env(opts.get("device")),
                   **{k: str(v) for k, v in
                      (opts.get("env_vars") or {}).items()})
        with _session.lock:
            # The child inherits the environment from its first instruction.
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                proc = mp.get_context("spawn").Process(
                    target=_actor_main, args=(spec,), daemon=True,
                    name=f"actor-{qualname}")
                proc.start()
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            _session.procs[actor_id] = proc
        return ActorHandle(actor_id, self._cls.__name__,
                           int(opts.get("max_concurrency") or 1))


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
    """``@remote`` / ``@remote(**options)`` for classes (JAX: ``remote``);
    a function raises ``NotImplementedError`` (remote tasks are not ported:
    the port's callers use actors)."""
    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, **options)
        raise NotImplementedError(
            "remote functions (tasks) are not ported; wrap the function in "
            "an actor class")
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
            values.append(r._fut.result(timeout=left))
        except cf.TimeoutError:
            raise GetTimeoutError(f"get timed out after {timeout} s "
                                  f"({r._name})") from None
    return values[0] if single else values


def put(value: Any) -> ObjectRef:
    """A ref holding ``value`` (sent by value wherever it is passed)."""
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
        cf.wait([r._fut for r in refs if not r._fut.done()], timeout=left,
                return_when=cf.FIRST_COMPLETED)
    ready = done[:num_returns]
    ids = {id(r) for r in ready}
    return ready, [r for r in refs if id(r) not in ids]


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    """Kill the actor's process; its calls in flight, and every later
    one, fail with ``ActorError``."""
    import signal
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
    for _aid, p in procs:
        if p.is_alive():
            p.kill()
    for aid, p in procs:
        p.join(timeout=30)
        with _channels_lock:
            ch = _channels.pop(aid, None)
        if ch is not None:
            ch.close()
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
            conn, send_lock, (_kind, call_id, method, blob, streaming) = \
                calls.get()
            self._run(conn, send_lock, call_id, method, blob, streaming)

    def _run(self, conn, send_lock, call_id, method, blob, streaming):
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
        try:
            args, kwargs = pickle.loads(blob)
            if method == _RAY_CALL:
                result = args[0](self.instance, *args[1:], **kwargs)
            else:
                result = getattr(self.instance, method)(*args, **kwargs)
            if streaming:
                for item in result:
                    send(("item", call_id, item))
                send(("end", call_id))
            else:
                send(("ok", call_id, result))
        except BaseException as e:  # noqa: BLE001 - back to the caller
            err = TaskError(e, qual, traceback.format_exc())
            try:
                pickle.dumps(err)
            except Exception:  # noqa: BLE001 - the cause itself won't pickle
                err = TaskError(RuntimeError(repr(e)), qual,
                                traceback.format_exc())
            send(("err", call_id, err))


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
    actor_id = spec["actor_id"]
    plane = ControlPlane.connect(spec["host"], spec["port"])
    set_current(plane)
    opts = spec["options"]
    _in_actor = {"plane": plane, "options": opts}
    threading.Thread(target=_watch_parent, args=(spec["parent"],),
                     daemon=True, name="actor-watch-parent").start()
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
    threading.Thread(target=_accept, args=(listener, actor), daemon=True,
                     name="actor-accept").start()
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
        threading.Thread(target=actor.serve_connection, args=(conn,),
                         daemon=True, name="actor-conn").start()

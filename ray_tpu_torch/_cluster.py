"""The head's endpoint (the head half of ``ray_tpu/_private/cluster.py``):
a TCP listener that drivers in other processes connect to as clients
(``_client``), and the control verbs it serves.

Transport: ``multiprocessing.connection`` over TCP, authenticated with an
HMAC key, the cluster token; messages are ``_protocol``'s dataclasses and
``RegisterClient``/``ClientAck``/``Ping``/``Pong`` below, sent as pickles
(the token is a secret: the endpoint unpickles what a peer sends).  Every
session of ``init()`` opens one (``_tasks._TaskSession.start_head``): on
every interface with the cluster token under ``init(head_port=...)``,
else on the loopback with this process's key, where the session's own
actors and task workers call the controller's verbs (``_actor.control``).

A client has no store of its own.  Its ``put`` sends the value inline; the
head seals a large one into the session's shared memory
(``_promote_client_put``).  Its task and actor calls carry their
arguments inline, its refs as object ids; the head keeps a ref for every
object id the client was given (``ClientProxy.objects``: freed when the
client disconnects) and answers ``get`` with the value inline.

The head pings each client every ``health_check_period_s`` and closes one
silent for ``health_check_failure_threshold`` periods.

Node registration, re-attach and the data plane (``RemoteNodeProxy``,
``DataServer``, ``DataClient``, ``ObjectPuller``, ``NodeServer``) come with
the node processes: each raises naming ROADMAP Queue 1 item 13, part 2.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import socket
import threading
import time
import traceback
from dataclasses import dataclass
from multiprocessing.connection import Listener
from typing import Any, Dict, List, Optional, Tuple

from . import _sanitizer, _serialization
from ._config import Config
from ._ids import ObjectID, PlacementGroupID, WorkerID
from ._protocol import (GetReply, GetRequest, PutFromWorker, RpcCall,
                        RpcReply, SubmitFromWorker, WaitReply, WaitRequest)
from .exceptions import ObjectLostError, RayTpuError

# The listener authenticates with an HMAC token and then unpickles peer
# messages: the token is a secret.  ``init(head_port=...)`` makes a random
# one when none is given; this default is an explicit opt-in (tests).
DEFAULT_TOKEN = b"ray-tpu-cluster"

NODES = 'ROADMAP Queue 1 item 13, part 2 ("node processes")'


def _part_2(name: str) -> type:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: see {NODES}")
    return type(name, (), {"__init__": __init__, "__doc__":
                           f"Not ported yet: see {NODES}."})


RemoteNodeProxy = _part_2("RemoteNodeProxy")
DataServer = _part_2("DataServer")
DataClient = _part_2("DataClient")
ObjectPuller = _part_2("ObjectPuller")
NodeServer = _part_2("NodeServer")


@dataclass
class RegisterClient:
    """A driver in another process asks to attach."""
    hostname: str
    os_pid: int = 0


@dataclass
class ClientAck:
    client_id_bytes: bytes
    job_id_bytes: bytes
    config_blob: str
    head_node_id_bytes: bytes


@dataclass
class Ping:
    t: float


@dataclass
class Pong:
    t: float


class _Ordered:
    """Runs what is put in order, on a thread started when work arrives
    and ended when none is left: a client's calls to one actor, which
    wait for the actor's process to start, off the client's reader (it
    must go on answering the head's pings)."""

    def __init__(self, head: "HeadServer", name: str):
        self._head = head
        self._name = name
        self._lock = threading.Lock()
        self._queue: List[Any] = []
        self._running = False

    def put(self, fn) -> None:
        with self._lock:
            self._queue.append(fn)
            if self._running:
                return
            self._running = True
        self._head._spawn(self._drain, (), self._name)

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._queue:
                    self._running = False
                    return
                fn = self._queue.pop(0)
            fn()


class ClientProxy:
    """The head's side of one client: its connection, and a ref for every
    object id the client holds (its puts, its tasks' and calls'
    returns)."""

    def __init__(self, head: "HeadServer", conn, client_id: WorkerID):
        self.head = head
        self.conn = conn
        self.client_id = client_id
        self._send_lock = threading.Lock()
        self.last_seen = time.monotonic()
        self._lock = threading.Lock()
        self.objects: Dict[ObjectID, Any] = {}
        #: actor id -> the ordered sender of this client's calls to it.
        self.senders: Dict[Any, _Ordered] = {}

    def sender(self, actor_id) -> _Ordered:
        with self._lock:
            s = self.senders.get(actor_id)
            if s is None:
                s = self.senders[actor_id] = _Ordered(
                    self.head, f"head-client-calls-{actor_id.hex()[:8]}")
            return s

    def send(self, msg) -> None:
        try:
            with self._send_lock:
                self.conn.send(msg)
        except (BrokenPipeError, OSError):
            pass

    def bind(self, oid: ObjectID, ref) -> None:
        with self._lock:
            self.objects[oid] = ref

    def ref(self, oid: ObjectID):
        with self._lock:
            ref = self.objects.get(oid)
        if ref is None:
            raise ObjectLostError(f"object {oid.hex()} is unknown to the "
                                  "head (it was freed, or came from "
                                  "another session)", oid.binary())
        return ref

    def load(self, payload: bytes) -> Any:
        """A client payload, its refs (persistent ids) made this head's."""
        return _serialization.unpack_payload(
            payload, lambda pid: self.ref(ObjectID(pid[1])))

    def release(self) -> None:
        """The client left: the refs it held go (their segments with the
        last ref of each)."""
        with self._lock:
            self.objects.clear()


class HeadServer:
    """The TCP endpoint of the head: accepts clients and serves their
    calls against this process's session."""

    def __init__(self, session, port: int = 0, token: bytes = DEFAULT_TOKEN,
                 host: str = "0.0.0.0",
                 advertise_host: Optional[str] = None):
        self.session = session
        self.token = token
        self._listener = Listener((host, port), "AF_INET", authkey=token)
        bound = self._listener.address
        self.address: Tuple[str, int] = (advertise_host or "127.0.0.1",
                                         bound[1])
        self.clients: Dict[WorkerID, ClientProxy] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._stop = threading.Event()
        #: The threads serving clients (readers, blocking requests), joined
        #: at shutdown.
        self._threads: List[threading.Thread] = []
        self._pinger: Optional[threading.Thread] = None
        self._acceptor = _sanitizer.spawn(self._accept_loop,
                                          name="head-accept")

    def _spawn(self, target, args: tuple, name: str) -> None:
        t = _sanitizer.spawn(target, args=args, name=name)
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    # -- membership ----------------------------------------------------------

    def _accept_loop(self) -> None:
        # Safe bare reads: _closed is a monotonic shutdown latch; the
        # worst a stale False costs is one extra loop iteration.
        while not self._closed:  # ray-tpu: noqa[RT401]
            try:
                conn = self._listener.accept()
            except Exception:  # noqa: BLE001 - a failed handshake
                if self._closed:  # ray-tpu: noqa[RT401]
                    return
                continue
            if self._closed:  # ray-tpu: noqa[RT401]
                conn.close()
                return
            self._spawn(self._register, (conn,), "head-register")

    def _register(self, conn) -> None:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            conn.close()
            return
        if not isinstance(msg, RegisterClient):
            # A node's registration: the node processes are not ported.
            conn.close()
            return
        self._register_client(conn)

    def _register_client(self, conn) -> None:
        session = self.session
        client_id = WorkerID.from_random()
        proxy = ClientProxy(self, conn, client_id)
        with self._lock:
            if self._closed:
                conn.close()
                return
            self.clients[client_id] = proxy
            if self._pinger is None:
                self._pinger = _sanitizer.spawn(self._ping_loop,
                                                name="head-ping")
        proxy.send(ClientAck(client_id.binary(),
                             session.node.job_id.binary(), Config.blob(),
                             session.node.node_id.binary()))
        self._client_reader(proxy)

    def _client_reader(self, proxy: ClientProxy) -> None:
        conn = proxy.conn
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError, TypeError, ValueError):
                break
            try:
                self._handle_client(proxy, msg)
            except Exception as e:  # noqa: BLE001 - answered to the client
                # The client waits for a reply keyed by request id: a
                # swallowed error would hang it, so always answer.
                self._client_error_reply(proxy, msg, e)
        try:
            conn.close()
        except OSError:
            pass
        with self._lock:
            self.clients.pop(proxy.client_id, None)
        proxy.release()

    @staticmethod
    def _client_error_reply(proxy: ClientProxy, msg, exc: Exception) -> None:
        try:
            if isinstance(msg, GetRequest):
                err = ("err", _serialization.pack_payload(_picklable(exc)))
                proxy.send(GetReply(msg.request_id,
                                    [err] * len(msg.object_ids)))
            elif isinstance(msg, WaitRequest):
                proxy.send(WaitReply(msg.request_id, []))
            elif isinstance(msg, RpcCall):
                proxy.send(RpcReply(msg.request_id, None, _error_text(exc)))
        except Exception:  # noqa: BLE001 - the client is gone
            traceback.print_exc()

    def _handle_client(self, proxy: ClientProxy, msg) -> None:
        proxy.last_seen = time.monotonic()
        if isinstance(msg, SubmitFromWorker):
            spec = msg.spec
            if spec.actor_id is None:
                self._submit(proxy, spec)
                return
            # Bound now (a get may follow at once), settled once the call
            # is sent from the actor's ordered sender.
            from ._actor import ObjectRef
            slots = [ObjectRef(cf.Future(), spec.name)
                     for _ in spec.return_ids]
            for oid, slot in zip(spec.return_ids, slots):
                proxy.bind(oid, slot)
            proxy.sender(spec.actor_id).put(
                lambda: self._submit(proxy, spec, slots))
        elif isinstance(msg, GetRequest):
            refs = [proxy.ref(oid) for oid in msg.object_ids]
            if all(r._fut.done() for r in refs):
                self._answer_get(proxy, msg, refs)
            else:
                self._spawn(self._answer_get, (proxy, msg, refs),
                            "head-client-get")
        elif isinstance(msg, WaitRequest):
            refs = [proxy.ref(oid) for oid in msg.object_ids]
            self._spawn(self._answer_wait, (proxy, msg, refs),
                        "head-client-wait")
        elif isinstance(msg, PutFromWorker):
            proxy.bind(msg.object_id, self._promote_client_put(proxy, msg))
        elif isinstance(msg, RpcCall):
            if msg.method in _BLOCKING:
                self._spawn(self._answer_rpc, (proxy, msg),
                            "head-client-rpc")
            else:
                self._answer_rpc(proxy, msg)

    def _promote_client_put(self, proxy: ClientProxy, msg: PutFromWorker):
        """A client's put arrives inline; a large one is sealed into the
        session's store (shared memory), a small one stays a value."""
        from . import _actor, _tasks
        value = proxy.load(msg.desc[1])
        if len(msg.desc[1]) > Config.get("max_inline_object_size"):
            return _tasks.put(value)
        return _actor._resolved(value, name="put")

    def _submit(self, proxy: ClientProxy, spec, slots=None) -> None:
        """A client's task or actor call (its returns bound to the object
        ids the client chose, or settling ``slots`` bound before); an
        error fails each return."""
        from . import _actor, _tasks
        try:
            args, kwargs = proxy.load(spec.arg_descs[0][1])
            n = len(spec.return_ids)
            if spec.actor_id is not None:
                info = _actor._session.controller.get_actor(spec.actor_id) \
                    if _actor._session is not None else None
                if info is None:
                    raise RayTpuError(f"actor {spec.actor_id.hex()} is "
                                      "unknown to the head")
                handle = _actor.ActorHandle(
                    spec.actor_id.hex(), info.class_name,
                    info.creation_spec.max_concurrency)
                out = _actor.ActorMethod(handle, spec.method_name,
                                         n).remote(*args, **kwargs)
            else:
                opts = {"num_returns": n, "max_retries": spec.max_retries,
                        "resources": spec.resources.to_dict(),
                        "placement_group": spec.placement_group,
                        "placement_group_bundle_index": spec.bundle_index,
                        "scheduling_strategy": spec.scheduling_strategy,
                        "runtime_env": spec.runtime_env}
                out = _tasks._submit(
                    _tasks._require_session(), spec.fn_blob, spec.name,
                    opts, packed=_tasks._pack(
                        (args, kwargs), f"the arguments of {spec.name}"))
        except Exception as e:  # noqa: BLE001 - each return raises it
            out = [_actor._resolved(exc=e, name=spec.name)
                   for _ in spec.return_ids]
        refs = out if isinstance(out, list) else [out]
        if slots is None:
            for oid, ref in zip(spec.return_ids, refs):
                proxy.bind(oid, ref)
        else:
            for ref, slot in zip(refs, slots):
                ref._fut.add_done_callback(
                    lambda f, slot=slot: _settle(slot._fut, f))

    def _answer_get(self, proxy: ClientProxy, msg: GetRequest,
                    refs: list) -> None:
        from . import _actor
        from .exceptions import GetTimeoutError
        deadline = None if msg.timeout_s is None else \
            time.monotonic() + msg.timeout_s
        values = []
        for ref in refs:
            left = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            try:
                value = _actor.get(ref, timeout=left)
                values.append(("inline", _serialization.pack_payload(value)))
            except GetTimeoutError:
                proxy.send(GetReply(msg.request_id, [], timed_out=True))
                return
            except Exception as e:  # noqa: BLE001 - raised in the client
                values.append(("err", _serialization.pack_payload(
                    _picklable(e))))
        proxy.send(GetReply(msg.request_id, values))

    def _answer_wait(self, proxy: ClientProxy, msg: WaitRequest,
                     refs: list) -> None:
        from . import _actor
        ready, _ = _actor.wait(refs, num_returns=msg.num_returns,
                               timeout=msg.timeout_s)
        ids = {id(r) for r in ready}
        proxy.send(WaitReply(msg.request_id,
                             [oid for oid, r in zip(msg.object_ids, refs)
                              if id(r) in ids]))

    def _answer_rpc(self, proxy: ClientProxy, msg: RpcCall) -> None:
        try:
            value = serve_rpc(msg.method, msg.args, msg.kwargs, proxy)
        except Exception as e:  # noqa: BLE001 - raised in the client
            proxy.send(RpcReply(msg.request_id, None, _error_text(e)))
            return
        proxy.send(RpcReply(msg.request_id, value))

    def _ping_loop(self) -> None:
        """Liveness probes: a client silent for ``failure_threshold``
        periods (it answers each ping) is closed, which ends its reader
        and frees what it held."""
        period = float(Config.get("health_check_period_s"))
        threshold = int(Config.get("health_check_failure_threshold"))
        while not self._stop.wait(period):
            now = time.monotonic()
            with self._lock:
                clients = list(self.clients.values())
            for p in clients:
                if now - p.last_seen > period * threshold:
                    try:
                        p.conn.close()
                    except OSError:
                        pass
                    continue
                p.send(Ping(now))

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            clients = list(self.clients.values())
            self.clients.clear()
            pinger = self._pinger
        self._stop.set()
        _drain_acceptor(self._listener, self._acceptor)
        try:
            self._listener.close()
        except OSError:
            pass
        for p in clients:
            try:
                p.conn.close()
            except OSError:
                pass
        if pinger is not None:
            pinger.join(timeout=5.0)
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        for p in clients:
            p.release()


def _settle(dst: "cf.Future", src: "cf.Future") -> None:
    """An actor call's value (or error) into the slot the client's object
    id was bound to."""
    exc = src.exception()
    if exc is not None:
        dst.set_exception(exc)
    else:
        dst.set_result(src.result())


def _drain_acceptor(listener, thread) -> None:
    """Unblock a thread sitting in ``listener.accept()`` and join it before
    the listener closes: closing the fd under a blocked accept lets the OS
    hand the fd number to a newer listener, whose handshakes the stale
    thread would then steal."""
    if thread is None or not thread.is_alive():
        return
    try:
        addr = listener.address
        s = socket.socket(socket.AF_INET)
        s.settimeout(1.0)
        host = addr[0] if addr[0] not in ("0.0.0.0", "") else "127.0.0.1"
        s.connect((host, addr[1]))
        s.close()
    except OSError:
        pass
    thread.join(timeout=3.0)


def _picklable(exc: BaseException) -> BaseException:
    try:
        _serialization.pack_payload(exc)
        return exc
    except Exception:  # noqa: BLE001 - its class will not pickle
        return RayTpuError(repr(exc))


def _error_text(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {exc}"


# -- the control verbs ----------------------------------------------------------


def _controller():
    from . import _actor
    return _actor._open_session().controller


def _node():
    from . import _tasks
    return _tasks._require_session().node


def _kv_put(proxy, key, value, namespace="default", overwrite=True):
    return _controller().kv_put(key, value, namespace, overwrite)


def _kv_get(proxy, key, namespace="default"):
    return _controller().kv_get(key, namespace)


def _kv_del(proxy, key, namespace="default"):
    return _controller().kv_del(key, namespace)


def _kv_keys(proxy, prefix="", namespace="default"):
    return _controller().kv_keys(prefix, namespace)


def _kv_wait(proxy, key, namespace="default", timeout=None):
    return _controller().kv_wait(key, namespace, timeout)


def _get_named_actor(proxy, name, namespace=None):
    from . import _actor
    _actor._open_session()
    return _actor._named(name, namespace)


def _create_actor(proxy, module, qualname, class_name, payload, opts):
    from . import _actor
    args, kwargs = proxy.load(payload)
    args, kwargs = _actor._resolve_args(args, kwargs)
    init = _actor._dumps((args, kwargs),
                         f"the constructor arguments of {qualname}")
    h = _actor._create_actor(module, qualname, class_name, init, opts)
    return h._actor_id, h._class_name, h._max_concurrency


def _kill_actor(proxy, actor_id, no_restart=True):
    from . import _actor
    _actor.kill(_actor.ActorHandle(actor_id), no_restart=no_restart)


def _nodes(proxy):
    return _node().nodes()


def _cluster_resources(proxy):
    return _node().cluster_resources()


def _available_resources(proxy):
    return _node().available_resources()


def _create_pg(proxy, bundles, strategy="PACK", name=None):
    return _node().create_pg(bundles, strategy, name).binary()


def _pg_state(proxy, pg_id):
    return _node().pg_state(PlacementGroupID(pg_id))


def _pg_wait(proxy, pg_id, timeout=30.0):
    from ._scheduler import wait_pg
    return wait_pg(_node(), PlacementGroupID(pg_id), timeout)


def _pg_bundle_locations(proxy, pg_id):
    return _node().pg_bundle_locations(PlacementGroupID(pg_id))


def _remove_pg(proxy, pg_id):
    _node().remove_pg(PlacementGroupID(pg_id))


def _session_info(proxy):
    """The head's pid, its session id (its segments are
    ``/dev/shm/rtt_<id>_*``) and the pids of its worker and actor
    processes."""
    from . import _actor, _tasks
    session = _tasks._require_session()
    with session.pool.cv:
        pids = [w.proc.pid for w in session.pool.workers
                if w.proc is not None and w.proc.is_alive()]
    actors = _actor._session
    if actors is not None:
        with actors.lock:
            pids += [p.pid for p in actors.procs.values() if p.is_alive()]
    return {"pid": os.getpid(), "session_id": session.id,
            "worker_pids": sorted(pids),
            "job_id": session.node.job_id.hex()}


_VERBS = {
    "kv_put": _kv_put, "kv_get": _kv_get, "kv_del": _kv_del,
    "kv_keys": _kv_keys, "kv_wait": _kv_wait,
    "get_named_actor": _get_named_actor, "create_actor": _create_actor,
    "kill_actor": _kill_actor, "nodes": _nodes,
    "cluster_resources": _cluster_resources,
    "available_resources": _available_resources,
    "create_pg": _create_pg, "pg_state": _pg_state, "pg_wait": _pg_wait,
    "pg_bundle_locations": _pg_bundle_locations, "remove_pg": _remove_pg,
    "session_info": _session_info,
}
#: Verbs that may wait: served from a thread each, not the client's
#: reader.
_BLOCKING = frozenset(("kv_wait", "pg_wait", "kill_actor", "create_actor"))


def serve_rpc(method: str, args: tuple, kwargs: dict,
              proxy: Optional[ClientProxy] = None) -> Any:
    """Run the control verb ``method`` against this process's session
    (JAX: the head's ``ctl_<method>``)."""
    fn = _VERBS.get(method)
    if fn is None:
        raise ValueError(f"unknown control verb {method!r} (known: "
                         f"{sorted(_VERBS)})")
    return fn(proxy, *args, **(kwargs or {}))

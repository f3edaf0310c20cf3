"""A driver in another process than the head's (a copy of
``ray_tpu/_private/client.py``): ``init(address="host:port",
cluster_token=...)`` connects this process to a running head
(``_cluster.HeadServer``), and the API then runs over the head's channel:
``remote`` tasks and actors, ``get``, ``put``, ``wait``, ``get_actor``,
``kill``, placement groups, ``nodes`` and the KV verbs
(``_actor.control``).

A client has no store: its puts and its calls' arguments go inline (its
refs inside them as their object ids, which the head maps to its own
refs), and ``get`` brings values back inline.  Functions and classes
cross by reference, as everywhere in the port, and must be importable by
the head's workers: one defined in the client's ``__main__``, in a
function, or a lambda raises ``ValueError`` at ``.remote()``.  Streaming
calls and ``side_call`` run in the head's process only.  The client's
objects are not reference-counted: they live until the client
disconnects.

``endpoint(head)`` is the same connection for the session's own actors
and task workers, which call the controller's verbs over it.
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
import json
import os
import queue
import socket
import threading
from multiprocessing.connection import Client as _TcpClient
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import _serialization
from ._config import Config
from ._ids import JobID, ObjectID, TaskID, WorkerID
from ._protocol import (GetReply, GetRequest, PutFromWorker, RpcCall,
                        RpcReply, SubmitFromWorker, TaskSpec, WaitReply,
                        WaitRequest)
from .exceptions import GetTimeoutError, RayTpuError


class _ClientFuture(cf.Future):
    """The future of a client's ref: ``result`` asks the head for the
    value (and keeps it), ``done`` asks whether it is ready."""

    def __init__(self, rt: "ClientRuntime", oid: ObjectID):
        super().__init__()
        self._rt = rt
        self._oid = oid

    def done(self) -> bool:
        if super().done():
            return True
        ready, _ = self._rt.wait_ids([self._oid], 1, 0)
        return bool(ready)

    def result(self, timeout=None):
        if not super().done():
            self._rt._fetch([self], timeout)
        return super().result(0)


class ClientRuntime:
    """This process's connection to the head (JAX: ``ClientRuntime``)."""

    def __init__(self, address, token: bytes):
        from ._cluster import ClientAck, RegisterClient
        if isinstance(address, str):
            host, port = address.rsplit(":", 1)
            address = (host, int(port))
        self.conn = _TcpClient(tuple(address), authkey=token)
        self.conn.send(RegisterClient(socket.gethostname(), os.getpid()))
        ack = self.conn.recv()
        if not isinstance(ack, ClientAck):
            raise RayTpuError(f"unexpected client handshake reply: {ack!r}")
        Config.initialize(json.loads(ack.config_blob))
        self.job_id = JobID(ack.job_id_bytes)
        self.worker_id = WorkerID(ack.client_id_bytes)
        # Object ids must be unique across the head's clients: they derive
        # from a task id drawn for this connection.
        self._put_task_id = TaskID.from_random()
        self._send_lock = threading.Lock()
        self._req_lock = threading.Lock()
        self._next_req = itertools.count(1)
        self._pending: Dict[int, queue.Queue] = {}
        self._obj_index = itertools.count(1)
        self._closed = False
        from . import _sanitizer
        self._reader = _sanitizer.spawn(self._reader_loop,
                                        name="client-reader")

    # -- plumbing -----------------------------------------------------------

    def send(self, msg) -> None:
        if self._closed:  # ray-tpu: noqa[RT401] - a monotonic latch
            raise RayTpuError("client session is disconnected")
        with self._send_lock:
            self.conn.send(msg)

    def _reader_loop(self) -> None:
        from ._cluster import Ping, Pong
        while True:
            try:
                msg = self.conn.recv()
            except (EOFError, OSError, TypeError, ValueError):
                break
            if isinstance(msg, Ping):
                try:
                    with self._send_lock:
                        self.conn.send(Pong(msg.t))
                except OSError:
                    break
            elif isinstance(msg, (GetReply, WaitReply, RpcReply)):
                with self._req_lock:
                    q = self._pending.get(msg.request_id)
                if q is not None:
                    q.put(msg)
        with self._req_lock:
            self._closed = True
            waiters = list(self._pending.values())
        # Wake every waiter so a blocked get fails instead of hanging.
        for q in waiters:
            q.put(None)

    def _call(self, make_msg):
        rid = next(self._next_req)
        q: queue.Queue = queue.Queue()
        with self._req_lock:
            self._pending[rid] = q
        try:
            self.send(make_msg(rid))
            reply = q.get()
        finally:
            with self._req_lock:
                self._pending.pop(rid, None)
        if reply is None:
            raise RayTpuError("client connection to the head was lost")
        return reply

    def _pack(self, value: Any, what: str) -> bytes:
        """``value`` as a frame whose refs are their object ids."""
        from ._actor import ObjectRef, _by_reference_rule

        def pid(obj):
            if isinstance(obj, ObjectRef):
                fut = obj._fut
                if isinstance(fut, _ClientFuture):
                    return ("oid", fut._oid.binary())
            return None
        try:
            return _serialization.pack_payload(value, pid)
        except (TypeError, AttributeError) as e:
            raise _by_reference_rule(what, e) from e

    def _new_ids(self, n: int) -> Tuple[TaskID, List[ObjectID]]:
        tid = TaskID.from_random()
        return tid, [ObjectID.of(tid, i + 1) for i in range(n)]

    def _refs(self, oids: List[ObjectID], name: str) -> list:
        from ._actor import ObjectRef
        return [ObjectRef(_ClientFuture(self, oid), name) for oid in oids]

    # -- submission -------------------------------------------------------

    def submit_task(self, fn_blob: bytes, name: str, opts: Dict[str, Any],
                    args: tuple, kwargs: dict):
        from . import _scheduler
        from ._resources import task_resources
        n = opts.get("num_returns", 1)
        if n == "streaming" or not isinstance(n, int) or n < 1:
            raise ValueError(f"num_returns={n!r}: a client's task returns "
                             "a positive number of values (streaming runs "
                             "in the head's process only)")
        if opts.get("device") is not None:
            raise ValueError("device= is not sent by a client: book cards "
                             "with num_tpus")
        strategy, pg, bundle = _scheduler.normalize_strategy(opts)
        runtime_env = dict(opts.get("runtime_env") or {})
        if opts.get("env_vars"):
            runtime_env["env_vars"] = dict(runtime_env.get("env_vars") or {},
                                           **opts["env_vars"])
        tid, oids = self._new_ids(n)
        from ._tasks import DEFAULT_MAX_RETRIES
        spec = TaskSpec(
            task_id=tid, name=name, fn_blob=fn_blob, method_name=None,
            arg_descs=[("val", self._pack((args, kwargs),
                                          f"the arguments of {name}"))],
            kwarg_descs={}, return_ids=oids,
            resources=task_resources(opts.get("num_cpus"),
                                     opts.get("num_tpus"),
                                     opts.get("memory"),
                                     opts.get("resources")),
            max_retries=int(opts.get("max_retries", DEFAULT_MAX_RETRIES)),
            placement_group=pg, bundle_index=bundle,
            scheduling_strategy=strategy, runtime_env=runtime_env or None)
        self.send(SubmitFromWorker(spec))
        refs = self._refs(oids, name)
        return refs[0] if n == 1 else refs

    def submit_actor_call(self, actor_id: str, method: str, name: str,
                          args: tuple, kwargs: dict, n: int):
        from ._ids import ActorID
        from ._resources import ResourceSet
        tid, oids = self._new_ids(n)
        spec = TaskSpec(
            task_id=tid, name=name, fn_blob=None, method_name=method,
            arg_descs=[("val", self._pack((args, kwargs),
                                          f"the arguments of {name}"))],
            kwarg_descs={}, return_ids=oids, resources=ResourceSet({}),
            actor_id=ActorID.from_hex(actor_id))
        self.send(SubmitFromWorker(spec))
        refs = self._refs(oids, name)
        return refs[0] if n == 1 else refs

    def create_actor(self, module: str, qualname: str, class_name: str,
                     args: tuple, kwargs: dict, opts: Dict[str, Any]):
        from ._actor import ActorHandle
        payload = self._pack((args, kwargs),
                             f"the constructor arguments of {qualname}")
        actor_id, cls_name, max_conc = self.control(
            "create_actor", module, qualname, class_name, payload, opts)
        return ActorHandle(actor_id, cls_name, max_conc)

    def put(self, value: Any):
        oid = ObjectID.of(self._put_task_id, next(self._obj_index))
        self.send(PutFromWorker(oid, ("inline", self._pack(
            value, "a put value"))))
        return self._refs([oid], "put")[0]

    # -- results ----------------------------------------------------------

    def _fetch(self, futs: Sequence[_ClientFuture],
               timeout: Optional[float]) -> None:
        """Settle ``futs`` from one ``GetRequest`` (raises
        ``GetTimeoutError`` when the head's wait runs out)."""
        oids = [f._oid for f in futs]
        reply: GetReply = self._call(
            lambda rid: GetRequest(rid, self.worker_id, oids, timeout))
        if reply.timed_out:
            raise GetTimeoutError(f"get timed out after {timeout} s")
        for fut, d in zip(futs, reply.values):
            if cf.Future.done(fut):
                continue
            try:
                value = _serialization.unpack_payload(d[1])
            except Exception as e:  # noqa: BLE001 - raised at get
                fut.set_exception(e)
                continue
            if d[0] == "inline":
                fut.set_result(value)
            else:
                fut.set_exception(value)

    def get_refs(self, refs: list, timeout: Optional[float]) -> list:
        futs = [r._fut for r in refs]
        pending = [f for f in futs if isinstance(f, _ClientFuture)
                   and not cf.Future.done(f)]
        if pending:
            self._fetch(pending, timeout)
        return [f.result(0) for f in futs]

    def wait_ids(self, oids: List[ObjectID], num_returns: int,
                 timeout: Optional[float]):
        reply: WaitReply = self._call(
            lambda rid: WaitRequest(rid, self.worker_id, oids, num_returns,
                                    timeout))
        ready = set(reply.ready)
        return ([o for o in oids if o in ready],
                [o for o in oids if o not in ready])

    def wait_refs(self, refs: list, num_returns: int,
                  timeout: Optional[float]):
        ready_ids, _ = self.wait_ids([r._fut._oid for r in refs],
                                     num_returns, timeout)
        ready_ids = set(ready_ids)
        ready = [r for r in refs if r._fut._oid in ready_ids][:num_returns]
        ids = {id(r) for r in ready}
        return ready, [r for r in refs if id(r) not in ids]

    def control(self, method: str, *args, **kwargs):
        reply: RpcReply = self._call(
            lambda rid: RpcCall(rid, self.worker_id, method, args, kwargs))
        if reply.error is not None:
            raise RuntimeError(reply.error)
        return reply.value

    def disconnect(self) -> None:
        with self._req_lock:
            self._closed = True
        try:
            self.conn.close()
        except OSError:
            pass
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=5.0)


_current: Optional[ClientRuntime] = None
_endpoints: Dict[tuple, ClientRuntime] = {}
_lock = threading.Lock()


def current() -> Optional[ClientRuntime]:
    """This process's client session (``init(address=...)``), or None."""
    return _current


def connect(address, token: bytes) -> ClientRuntime:
    """Open a client session and make it this process's runtime."""
    global _current
    rt = ClientRuntime(address, token)
    with _lock:
        _current = rt
    return rt


def disconnect() -> None:
    """Close this process's client session, if it has one."""
    global _current
    with _lock:
        rt, _current = _current, None
    if rt is not None:
        rt.disconnect()


def endpoint(head: Tuple[str, int, bytes]) -> ClientRuntime:
    """A connection to the session's endpoint for an actor or a task
    worker of it (made at first use, kept for the process's life)."""
    host, port, token = head
    with _lock:
        rt = _endpoints.get((host, port))
        if rt is None or rt._closed:  # ray-tpu: noqa[RT401]
            rt = _endpoints[(host, port)] = ClientRuntime((host, port),
                                                          token)
        return rt

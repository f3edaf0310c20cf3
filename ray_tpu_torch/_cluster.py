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
import pickle
import queue
import socket
import threading
import time
import traceback
import uuid
from collections import deque
from dataclasses import dataclass
from multiprocessing.connection import Listener
from typing import Any, Dict, List, Optional, Tuple

from . import _sanitizer, _serialization
from ._config import Config
from ._ids import ObjectID, PlacementGroupID, WorkerID
from ._protocol import (GetReply, GetRequest, PutFromWorker, RpcCall,
                        RpcReply, SubmitFromWorker, WaitReply, WaitRequest)
from .exceptions import ObjectLostError, RayTpuError

#: A node sends its load view up at most this often (when it changed).
SYNC_PERIOD_S = 1.0

# The listener authenticates with an HMAC token and then unpickles peer
# messages: the token is a secret.  ``init(head_port=...)`` makes a random
# one when none is given; this default is an explicit opt-in (tests).
DEFAULT_TOKEN = b"ray-tpu-cluster"

# -- the node plane's messages (head <-> node server) ------------------------------
#
# Down frames are ("dseq", seq, acked up-seq, msg), up frames ("useq", seq,
# acked down-seq, msg): each side keeps what the other has not acknowledged
# and sends it again after a re-attach (JAX's sequence-numbered
# redelivery), so a message written into a dying socket is never lost.


@dataclass
class RegisterNode:
    hostname: str
    resources: Dict[str, float]
    num_tpu_chips: int
    data_address: Tuple[str, int]
    os_pid: int = 0
    #: Set on a re-attach: the node's existing identity and the last
    #: down-sequence it received.
    rejoin_node_id: Optional[bytes] = None
    last_down_seq: int = 0


@dataclass
class RegisterAck:
    node_id_bytes: bytes
    job_id_bytes: bytes
    config_blob: str
    head_data_address: Tuple[str, int]
    head_node_id_bytes: bytes
    #: The highest up-sequence the head processed from this node.
    last_up_seq: int = 0
    #: A head restarted from its WAL accepted this re-attach: it knows
    #: none of the node's actors (they restart elsewhere).
    wal_resumed: bool = False
    #: What a node of the port needs besides JAX's fields: the session id
    #: (its segments are ``rtt_<session>_<node>_*``), the head's
    #: ``sys.path`` (functions cross by reference) and its session
    #: directory.  No secret: the node authenticates its workers and
    #: actors with the cluster token it dialled with, which the head made
    #: its own process key (``_tasks._TaskSession.start_head``).
    session_id: str = ""
    sys_path: Tuple[str, ...] = ()
    session_dir: str = ""


@dataclass
class DispatchTask:
    """Run a task on the node: ``spec`` carries its id, name, function,
    return ids and resources, ``args`` its packed arguments' descriptor
    (tagged with the head), ``kwargs`` its run options."""
    spec: Any
    args: list
    kwargs: dict
    target_worker: Optional[bytes] = None
    pipelined: bool = False


@dataclass
class StartActor:
    """Start an actor placed on the node (its ``_actor`` spec)."""
    actor_id: str
    qualname: str
    spec: Dict[str, Any]
    env: Dict[str, str]
    spec_resources: Any


@dataclass
class ToWorker:
    worker_id: bytes
    msg: Any


@dataclass
class KillActorWorker:
    actor_id: str
    force: bool = True


@dataclass
class NodeShutdown:
    pass


@dataclass
class FreeObject:
    names: List[str]


@dataclass
class NodeRpc:
    request_id: int
    method: str
    args: Tuple = ()


@dataclass
class NodeRpcReply:
    request_id: int
    value: Any = None
    error: Optional[str] = None


@dataclass
class UpTaskDone:
    """A task's end (``("ok"|"err"|"end", tid, ...)``) or a streamed item
    (``("item", tid, desc, inner)``), as ``_tasks._apply_reply`` reads
    it, its descriptors tagged with the node."""
    reply: tuple
    worker_id: bytes
    execution_time_s: float = 0.0
    return_ids: Tuple[bytes, ...] = ()


@dataclass
class UpNoteTaskRunning:
    tid: int
    worker_id: bytes


@dataclass
class UpWorkerDied:
    worker_id: bytes
    running: List[int]
    exit_code: Optional[int] = None


@dataclass
class UpSyncView:
    version: int
    view: Dict[str, Any]


@dataclass
class UpDispatchFailed:
    tid: int
    reason: str


@dataclass
class UpPipelineReject:
    """A pipelined dispatch found no worker with queue room."""
    tid: int


@dataclass
class UpWorkerRequest:
    """A nested request of a task running on the node (``submit``,
    ``get``, ``poll``, ``next``, ``plane``), answered with ``ToWorker``."""
    worker_id: bytes
    tid: Optional[int]
    req: tuple


@dataclass
class UpActorState:
    """An actor of the node: ``"alive"``, ``"error"`` (its constructor
    raised; ``detail`` the packed error) or ``"exit"`` (its process is
    gone; ``detail`` the exit code)."""
    actor_id: str
    state: str
    detail: Any = None
    pid: int = 0


@dataclass
class UpLogLines:
    lines: List[Tuple[str, str]]


@dataclass
class StackDumpAll:
    dump_id: int


@dataclass
class UpStackReply:
    dump_id: int
    record: Dict[str, Any]


@dataclass
class UpStackExpect:
    dump_id: int
    worker_ids: List[str]


def _nodelay(conn) -> None:
    """Send small frames at once on a TCP connection: a node sends a
    task's start and then its end, and Nagle's algorithm would hold the
    second behind the peer's delayed ACK (about 40 ms a task)."""
    try:
        s = socket.socket(fileno=os.dup(conn.fileno()))
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        finally:
            s.close()
    except OSError:
        pass


# -- descriptor location tagging -----------------------------------------------------


def tag_desc(desc, node_id_bytes: bytes):
    """Mark a node-local descriptor with its owner node."""
    if isinstance(desc, tuple) and desc and desc[0] == "shm":
        return ("at", node_id_bytes, desc)
    return desc


def untag_desc(desc, local_node_id_bytes: bytes):
    """Strip an "at" tag when the object is local; else return None."""
    if isinstance(desc, tuple) and desc and desc[0] == "at":
        if desc[1] == local_node_id_bytes:
            return desc[2]
        return None
    return desc


def desc_key(desc) -> Optional[bytes]:
    """Stable fetch key for a (possibly inner) descriptor."""
    if desc[0] == "shm":
        return desc[1].encode()
    if desc[0] == "at":
        return desc_key(desc[2])
    return None


def export_desc(desc, node_id_bytes: bytes):
    """A descriptor as it leaves node ``node_id_bytes``: a segment of the
    node is tagged; an inline payload's inner descriptors (the refs it
    holds) are tagged alike."""
    if not isinstance(desc, tuple) or not desc:
        return desc
    if desc[0] == "shm":
        return ("at", node_id_bytes, desc)
    if desc[0] == "inline":
        descs, meta, bufs = pickle.loads(desc[1])
        if not descs:
            return desc
        return ("inline", pickle.dumps(
            ([export_desc(d, node_id_bytes) for d in descs], meta, bufs),
            protocol=5))
    return desc


def import_desc(desc, local_node_id_bytes: bytes):
    """A descriptor as it arrives on node ``local_node_id_bytes``: a tag
    of this node is stripped (inner ones too); others stay tagged."""
    if not isinstance(desc, tuple) or not desc:
        return desc
    if desc[0] == "at":
        return desc[2] if desc[1] == local_node_id_bytes else desc
    if desc[0] == "inline":
        descs, meta, bufs = pickle.loads(desc[1])
        if not any(d[0] in ("at", "inline") for d in descs):
            return desc
        return ("inline", pickle.dumps(
            ([import_desc(d, local_node_id_bytes) for d in descs], meta,
             bufs), protocol=5))
    return desc


# -- the data plane: a node's object server and its pull client ----------------------

#: Bytes and counts this process moved over the data plane.
_transfers: Dict[str, float] = {"push_bytes": 0, "pull_bytes": 0,
                                "pushes": 0, "pulls": 0,
                                "push_s": 0.0, "pull_s": 0.0}
_transfers_lock = threading.Lock()


def transfer_stats() -> Dict[str, float]:
    """This process's data-plane counters: ``push_bytes``/``pushes`` (its
    ``DataServer`` sent), ``pull_bytes``/``pulls`` (its ``ObjectPuller``
    fetched), and the seconds each took."""
    with _transfers_lock:
        return dict(_transfers)


def _record_transfer(direction: str, desc, nbytes: int, dur_s: float,
                     peer: Optional[str] = None) -> None:
    """Account one cross-node payload move: this process's counters, the
    ``ray_tpu_store_transfer_*`` series and, while a trace is in flight,
    an ``obj.push``/``obj.pull`` span.  Never fails the transfer."""
    with _transfers_lock:
        _transfers[f"{direction}_bytes"] += nbytes
        _transfers[f"{direction}es" if direction == "push"
                   else f"{direction}s"] += 1
        _transfers[f"{direction}_s"] += dur_s
    try:
        from .util import telemetry, tracing
        telemetry.inc("ray_tpu_store_transfer_bytes_total", nbytes,
                      tags={"direction": direction})
        telemetry.observe("ray_tpu_store_transfer_seconds", dur_s,
                          tags={"op": direction})
        parent = tracing.current()
        if parent is not None:
            end_s = time.time()
            # A wall-clock anchor for a monotonic duration, not interval
            # arithmetic.
            start_s = end_s - dur_s  # ray-tpu: noqa[RT203]
            tracing.record_span(
                parent, f"obj.{direction}", start_s, end_s,
                attributes={"segment": desc[1] if desc[0] == "shm"
                            else None, "nbytes": nbytes, "peer": peer},
                kind="CLIENT" if direction == "pull" else "SERVER")
    except Exception as e:  # noqa: BLE001 - accounting is best-effort
        from .util import telemetry
        telemetry.note_swallowed("cluster.record_transfer", e)


def read_raw_payload(store, desc) -> Optional[bytes]:
    """The raw bytes of a segment of this node (restored if its store
    spilled it); None when it is gone."""
    try:
        if desc[0] == "shm":
            if store is not None:
                return store.read_raw(desc[1], desc[2])
            from ._object_store import _Segment
            seg = _Segment(desc[1], create=False)
            try:
                return bytes(seg.buf[:desc[2]])
            finally:
                seg.close()
    except Exception:  # noqa: BLE001 - an unreachable object
        return None
    return None


class DataServer:
    """Serves raw payloads of this node's segments to other nodes (the
    push side; one message an object)."""

    def __init__(self, store, token: bytes, host: str = "0.0.0.0",
                 advertise_host: str = "127.0.0.1"):
        self._store = store
        self._listener = Listener((host, 0), "AF_INET", authkey=token)
        self.address: Tuple[str, int] = (advertise_host,
                                         self._listener.address[1])
        self._closed = False
        self._lock = threading.Lock()
        self._conns: List[Any] = []
        self._acceptor = _sanitizer.spawn(self._accept_loop,
                                          name="data-server")

    def _accept_loop(self) -> None:
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
            _nodelay(conn)
            with self._lock:
                self._conns.append(conn)
            _sanitizer.spawn(self._serve, args=(conn,), name="data-serve")

    def _serve(self, conn) -> None:
        try:
            while True:
                desc = conn.recv()
                t0 = time.monotonic()
                payload = read_raw_payload(self._store, desc)
                conn.send_bytes(b"\x00" if payload is None
                                else b"\x01" + payload)
                if payload is not None:
                    _record_transfer("push", desc, len(payload),
                                     time.monotonic() - t0)
        except (EOFError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def shutdown(self) -> None:
        self._closed = True
        _drain_acceptor(self._listener, self._acceptor)
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class DataClient:
    """The pull side: a pooled connection to each peer's data server, one
    request in flight on each."""

    def __init__(self, token: bytes):
        self._token = token
        self._conns: Dict[Tuple[str, int], Any] = {}
        self._locks: Dict[Tuple[str, int], threading.Lock] = {}
        self._lock = threading.Lock()

    def fetch(self, address: Tuple[str, int], desc) -> Optional[bytes]:
        """The payload of ``desc`` from the peer at ``address``, or None
        when it is unreachable (a dead peer, a token mismatch, a freed
        object)."""
        from multiprocessing.connection import Client
        address = tuple(address)
        with self._lock:
            lk = self._locks.setdefault(address, threading.Lock())
        with lk:
            with self._lock:
                conn = self._conns.get(address)
            for _attempt in (0, 1):
                try:
                    if conn is None:
                        conn = Client(address, authkey=self._token)
                        _nodelay(conn)
                        with self._lock:
                            self._conns[address] = conn
                    conn.send(desc)
                    data = conn.recv_bytes()
                    return None if data[:1] == b"\x00" else \
                        memoryview(data)[1:]
                except Exception:  # noqa: BLE001 - unreachable, see above
                    if conn is not None:
                        try:
                            conn.close()
                        except OSError:
                            pass
                        with self._lock:
                            self._conns.pop(address, None)
                    conn = None
            return None

    def shutdown(self) -> None:
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass


class ObjectPuller:
    """Resolves descriptors of other nodes into segments of this node's
    store: the payload is pulled from the owner's data server, its inner
    descriptors retagged for this node, and the copy cached under the
    owner's (node, segment), so later readers map it in place."""

    def __init__(self, store, data_client: DataClient,
                 local_node_id_bytes: bytes, resolve_address,
                 segment_prefix: str):
        self._store = store
        self._client = data_client
        self._local = local_node_id_bytes
        self._resolve_address = resolve_address
        self._prefix = segment_prefix
        self._lock = threading.Lock()
        self._cache: Dict[tuple, tuple] = {}
        self._inflight: Dict[tuple, threading.Event] = {}

    def localize(self, desc):
        """A descriptor of this node for ``desc`` (pulled if need be);
        ``("err", reason)`` when the owner cannot be reached."""
        if not (isinstance(desc, tuple) and desc and desc[0] == "at"):
            return desc
        if desc[1] == self._local:
            return desc[2]
        inner = desc[2]
        if inner[0] != "shm":
            return import_desc(export_desc(inner, desc[1]), self._local)
        key = (desc[1], inner[1])
        while True:
            with self._lock:
                local = self._cache.get(key)
                if local is not None:
                    return local
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    break
            ev.wait()
        try:
            t0 = time.monotonic()
            addr = self._resolve_address(desc[1])
            payload = None if addr is None else self._client.fetch(addr,
                                                                   inner)
            if payload is None:
                return ("err", f"object {inner[1]} is unreachable (its "
                        f"node {desc[1].hex()[:12]} is gone?)")
            local = self._put(payload, desc[1])
            _record_transfer("pull", inner, len(payload),
                             time.monotonic() - t0, peer=desc[1].hex()[:12])
            with self._lock:
                self._cache[key] = local
            return local
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()

    def _put(self, payload, origin: bytes) -> tuple:
        from ._object_store import _read_parts
        env, bufs = _read_parts(payload)
        descs, meta = pickle.loads(env)
        if descs:
            env = pickle.dumps(([import_desc(export_desc(d, origin),
                                             self._local)
                                 for d in descs], meta), protocol=5)
        name = f"rtt_{self._prefix}_{uuid.uuid4().hex}"
        return self._store.put_parts(name, env, bufs)

    def forget(self, node_id: bytes, name: str) -> Optional[tuple]:
        """Drop the cached copy of (node, segment); it is returned, for
        the caller to delete from the store."""
        with self._lock:
            return self._cache.pop((node_id, name), None)


# -- the head's side of a node ---------------------------------------------------------


class RemoteNodeProxy:
    """The head's stand-in for a joined node: its dispatch surface over
    the control connection, with JAX's sequence-numbered redelivery."""

    is_remote = True

    def __init__(self, head: "HeadServer", conn, info, data_address,
                 os_pid: int = 0):
        self.head = head
        self.conn = conn
        self.info = info
        self.node_id = info.node_id
        self.data_address = tuple(data_address)
        self.os_pid = os_pid
        self._send_lock = threading.Lock()
        self.alive = True
        self.last_seen = time.monotonic()
        self._down_seq = 0
        self._ring: deque = deque()
        self.last_up_seq = 0
        self._up_seq_lock = threading.Lock()
        #: Bumped at each re-attach: a reader of an older connection
        #: that ends does not start the death timer.
        self.generation = 0

    def send(self, msg) -> None:
        with self._send_lock:
            self._down_seq += 1
            frame = ("dseq", self._down_seq, self.last_up_seq, msg)
            self._ring.append(frame)
            try:
                self.conn.send(frame)
            except (BrokenPipeError, OSError):
                pass            # stays in the ring; resent on re-attach

    def note_up_seq(self, seq: int) -> bool:
        """Claim an up-sequence number; False for a duplicate."""
        with self._up_seq_lock:
            if seq <= self.last_up_seq:
                return False
            self.last_up_seq = seq
            return True

    def note_up_acked(self, acked_down_seq: int) -> None:
        """The node received every down frame up to ``acked_down_seq``."""
        with self._send_lock:
            while self._ring and self._ring[0][1] <= acked_down_seq:
                self._ring.popleft()

    def reattach(self, conn, last_down_seq: int, ack_msg) -> None:
        """Swap in a fresh connection, send the handshake and replay the
        unacknowledged tail, all under the send lock (no dispatch can
        overtake the redelivered frames)."""
        with self._send_lock:
            old, self.conn = self.conn, conn
            self.generation += 1
            while self._ring and self._ring[0][1] <= last_down_seq:
                self._ring.popleft()
            try:
                conn.send(ack_msg)
                for frame in list(self._ring):
                    conn.send(frame)
            except (BrokenPipeError, OSError):
                pass            # the node retries the whole re-attach
        self.last_seen = time.monotonic()
        try:
            old.close()
        except OSError:
            pass

    def dispatch_task(self, spec, args_desc, opts: dict) -> None:
        self.send(DispatchTask(spec, [args_desc], opts))

    def send_to_worker(self, worker_id: bytes, msg) -> None:
        self.send(ToWorker(worker_id, msg))

    def broadcast_stack_dump(self, dump_id: int) -> None:
        self.send(StackDumpAll(dump_id))

    def kill_actor(self, actor_id: str) -> None:
        self.send(KillActorWorker(actor_id))

    def process_gone(self) -> bool:
        """True when the node's process ran on this host and is gone (no
        re-attach can come: its death need not wait for the grace)."""
        if not self.os_pid or self.info.hostname != socket.gethostname():
            return False
        try:
            with open(f"/proc/{self.os_pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
            return state in ("Z", "X")
        except (FileNotFoundError, IndexError):
            return True
        except OSError:
            return False

    def shutdown(self) -> None:
        self.send(NodeShutdown())


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
            # A task that ran on a node while this head restarted: the
            # node replays its result into the object directory.
            ref = self.head.session.runtime.directory_ref(oid)
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
        #: The joined nodes' proxies, by node id.
        self.proxies: Dict[Any, RemoteNodeProxy] = {}
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
        if isinstance(msg, RegisterNode):
            _nodelay(conn)
            self._register_node(conn, msg)
            return
        if not isinstance(msg, RegisterClient):
            conn.close()
            return
        self._register_client(conn)

    # -- nodes ---------------------------------------------------------------

    def _ack(self, node_id, last_up_seq: int = 0,
             wal_resumed: bool = False) -> RegisterAck:
        import sys
        session = self.session
        rt = session.runtime
        return RegisterAck(
            node_id.binary(), session.node.job_id.binary(), Config.blob(),
            rt.data_address(), session.node.node_id.binary(),
            last_up_seq=last_up_seq, wal_resumed=wal_resumed,
            session_id=session.id,
            sys_path=tuple(p for p in sys.path if p),
            session_dir=rt.session_dir)

    def _register_node(self, conn, msg: RegisterNode) -> None:
        """A node joins (or re-attaches under its identity after a dropped
        connection, or after this head restarted from its WAL)."""
        from ._controller import NodeInfo
        from ._ids import NodeID
        from ._resources import ResourceSet
        if msg.hostname != socket.gethostname():
            # Actors and the session's store listen on the loopback, so
            # an actor on another host could not be called.
            try:
                conn.send(f"refused: node on host {msg.hostname!r}, not "
                          f"the head's ({socket.gethostname()!r}); nodes "
                          "on other hosts wait for ROADMAP item 13 part 3")
            except (OSError, BrokenPipeError):
                pass
            conn.close()
            return
        if msg.rejoin_node_id is not None:
            if self._reattach(msg, conn) or \
                    self._reattach_from_wal(msg, conn):
                return
            conn.close()
            return
        rt = self.session.runtime
        info = NodeInfo(NodeID.from_random(), msg.hostname,
                        ResourceSet(msg.resources))
        proxy = RemoteNodeProxy(self, conn, info, msg.data_address,
                                msg.os_pid)
        with self._lock:
            if self._closed:
                conn.close()
                return
            self.proxies[info.node_id] = proxy
        self._start_pinger()
        try:
            conn.send(self._ack(info.node_id))
        except (OSError, BrokenPipeError):
            with self._lock:
                self.proxies.pop(info.node_id, None)
            return
        rt.add_node(proxy, msg)
        self._reader_loop(proxy)

    def _reattach(self, msg: RegisterNode, conn) -> bool:
        """A live node's connection dropped and it dialled back within
        the grace: same identity, its workers, actors and tasks kept; the
        unacknowledged frames of each side are sent again."""
        from ._ids import NodeID
        nid = NodeID(msg.rejoin_node_id)
        with self._lock:
            proxy = self.proxies.get(nid)
        if proxy is None or not proxy.alive:
            return False
        proxy.reattach(conn, msg.last_down_seq,
                       self._ack(nid, last_up_seq=proxy.last_up_seq))
        self._reader_loop(proxy)
        return True

    def _reattach_from_wal(self, msg: RegisterNode, conn) -> bool:
        """This head restarted from its WAL and a node of the old head
        dials back: it re-joins under its persisted identity, and the
        results of the tasks it ran meanwhile replay (``_runtime``'s
        object directory)."""
        from ._controller import NodeInfo
        from ._ids import NodeID
        from ._resources import ResourceSet
        rt = self.session.runtime
        controller = self.session.node.controller
        if controller.get_revivable(msg.rejoin_node_id) is None:
            return False
        nid = NodeID(msg.rejoin_node_id)
        info = NodeInfo(nid, msg.hostname, ResourceSet(msg.resources))
        proxy = RemoteNodeProxy(self, conn, info, msg.data_address,
                                msg.os_pid)
        with self._lock:
            if self._closed or nid in self.proxies:
                return False
            self.proxies[nid] = proxy
        self._start_pinger()
        try:
            conn.send(self._ack(nid, wal_resumed=True))
        except (OSError, BrokenPipeError):
            with self._lock:
                self.proxies.pop(nid, None)
            return True
        rt.add_node(proxy, msg, wal_resumed=True)
        self._reader_loop(proxy)
        return True

    def _start_pinger(self) -> None:
        with self._lock:
            if self._pinger is None and not self._closed:
                self._pinger = _sanitizer.spawn(self._ping_loop,
                                                name="head-ping")

    def _reader_loop(self, proxy: RemoteNodeProxy) -> None:
        """Read one connection of a node; it never waits on a dispatch
        (what may block runs on a thread of its own), so the node's pongs
        are always read."""
        conn, gen = proxy.conn, proxy.generation
        while True:
            try:
                frame = conn.recv()
            except (EOFError, OSError, TypeError, ValueError):
                break
            except Exception:  # noqa: BLE001 - a frame this head cannot load
                break
            if isinstance(frame, tuple) and frame and frame[0] == "useq":
                _tag, seq, acked, msg = frame
                proxy.note_up_acked(acked)
                if not proxy.note_up_seq(seq):
                    continue
            else:
                msg = frame
            try:
                self._handle(proxy, msg)
            except Exception as e:  # noqa: BLE001 - keep reading
                from .util import telemetry
                telemetry.note_swallowed("head.node_msg", e)
        if proxy.generation == gen and not self._closed:  # ray-tpu: noqa[RT401]
            self._node_disconnected(proxy, gen)

    def _node_disconnected(self, proxy: RemoteNodeProxy, gen: int) -> None:
        """The node's connection ended: it is dead once its process is
        gone, or when it has not re-attached within
        ``node_reconnect_grace_s``."""
        grace = float(Config.get("node_reconnect_grace_s"))
        deadline = time.monotonic() + grace
        while not self._stop.is_set():
            if proxy.generation != gen:
                return          # re-attached
            if proxy.process_gone() or time.monotonic() >= deadline:
                break
            self._stop.wait(0.05)
        if proxy.generation == gen and not self._closed:  # ray-tpu: noqa[RT401]
            self._on_node_death(proxy, "connection lost")

    def _on_node_death(self, proxy: RemoteNodeProxy, reason: str) -> None:
        with self._lock:
            if self.proxies.get(proxy.node_id) is not proxy:
                return
            self.proxies.pop(proxy.node_id, None)
        proxy.alive = False
        self.session.runtime.on_node_died(proxy.node_id, reason)

    def _handle(self, proxy: RemoteNodeProxy, msg) -> None:
        proxy.last_seen = time.monotonic()
        rt = self.session.runtime
        if isinstance(msg, Pong):
            rt.on_pong(proxy, msg)
        elif isinstance(msg, UpTaskDone):
            rt.on_task_done(proxy, msg)
        elif isinstance(msg, UpWorkerRequest):
            rt.on_worker_request(proxy, msg)
        elif isinstance(msg, UpWorkerDied):
            rt.on_worker_died(proxy, msg)
        elif isinstance(msg, UpDispatchFailed):
            rt.on_dispatch_failed(proxy, msg)
        elif isinstance(msg, UpPipelineReject):
            rt.on_pipeline_reject(proxy, msg)
        elif isinstance(msg, UpActorState):
            rt.on_actor_state(proxy, msg)
        elif isinstance(msg, UpSyncView):
            rt.on_node_view(proxy.node_id, msg.version, msg.view)
        elif isinstance(msg, UpLogLines):
            rt.on_log_lines(proxy, msg)
        elif isinstance(msg, (UpStackReply, UpStackExpect)):
            rt.on_stack_msg(proxy, msg)
        elif isinstance(msg, UpNoteTaskRunning):
            rt.on_task_running(proxy, msg)
        elif isinstance(msg, NodeRpc):
            try:
                value = rt.serve_node_rpc(msg.method, msg.args)
                proxy.send(NodeRpcReply(msg.request_id, value))
            except Exception as e:  # noqa: BLE001 - raised in the node
                proxy.send(NodeRpcReply(msg.request_id, None,
                                        _error_text(e)))

    def node_data_address(self, node_id_bytes: bytes):
        """The data server of a node (the head's own included), or None
        for a node that is gone."""
        from ._ids import NodeID
        if node_id_bytes == self.session.node.node_id.binary():
            return self.session.runtime.data_address()
        with self._lock:
            proxy = self.proxies.get(NodeID(node_id_bytes))
        return None if proxy is None else proxy.data_address

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
                        (args, kwargs), f"the arguments of {spec.name}"),
                    return_ids=list(spec.return_ids))
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
        """Liveness probes: a client or a node silent for
        ``failure_threshold`` periods (each answers every ping) is
        closed, which ends its reader (a client's refs are freed; a node
        gets its grace to re-attach)."""
        period = float(Config.get("health_check_period_s"))
        threshold = int(Config.get("health_check_failure_threshold"))
        while not self._stop.wait(period):
            now = time.monotonic()
            with self._lock:
                clients = list(self.clients.values())
                nodes = list(self.proxies.values())
            for p in nodes:
                if now - p.last_seen > period * threshold:
                    try:
                        p.conn.close()
                    except OSError:
                        pass
                    continue
                p.send(Ping(now))
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
            nodes = list(self.proxies.values())
            self.proxies.clear()
            pinger = self._pinger
        for p in nodes:
            p.shutdown()
            try:
                p.conn.close()
            except OSError:
                pass
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


# -- the node process ------------------------------------------------------------------


class NodeServer:
    """A node process: joins the head, runs the tasks and actors the head
    places here on its own worker pool (``_node.NodeManager``), serves its
    objects to other nodes and pulls theirs (the data plane), and reports
    its load view, its workers' logs and stacks up.

    Its reader never blocks: dispatches and actor starts go through a
    queue and a thread of their own (``_queue_loop``), so a ping is
    answered while a card worker starts.  When the connection drops the
    node keeps its workers and dials back within
    ``node_reconnect_grace_s`` (re-attaching under its identity, to the
    same head or to one restarted from its WAL); past it, it stops and
    its workers with it."""

    def __init__(self, head_address: Tuple[str, int], token: bytes,
                 num_cpus: float = 1.0, num_tpus: Optional[int] = None,
                 resources: Optional[Dict[str, float]] = None,
                 advertise_host: str = "127.0.0.1"):
        from ._ids import NodeID
        from ._object_store import SharedMemoryStore
        from ._scheduler import node_resources
        self.head_address = tuple(head_address)
        self.token = token
        self.advertise_host = advertise_host
        res = node_resources(num_cpus, num_tpus, resources)
        from ._resources import GPU
        self.num_cards = int(res.get(GPU, 0))
        self.num_cpus = float(num_cpus)
        self._resources = res
        self._send_lock = threading.Lock()
        self._up_seq = 0
        self._ring: deque = deque()
        self.last_down_seq = 0
        self._closed = threading.Event()
        self._queue: "queue.Queue" = queue.Queue()
        self._rpc_ids = iter(range(1, 1 << 62))
        self._rpc_waiting: Dict[int, list] = {}
        self._addr_cache: Dict[bytes, Tuple[str, int]] = {}
        self._view_version = 0
        # The store spills under the session's directory, known once the
        # head answers; the data server serves it from the start.
        self._store_cls = SharedMemoryStore
        self.store = None
        self.manager = None
        self.data_server = None
        self.data_client = None
        self.log_monitor = None
        self.conn = self._connect(RegisterNode(
            socket.gethostname(), res, self.num_cards, ("", 0),
            os_pid=os.getpid()))
        ack = self._ack
        self.node_id = NodeID(ack.node_id_bytes)
        self._boot(ack)

    # -- joining ---------------------------------------------------------------

    def _connect(self, reg: RegisterNode):
        from multiprocessing.connection import Client
        conn = Client(self.head_address, "AF_INET", authkey=self.token)
        _nodelay(conn)
        if self.data_server is not None:
            reg.data_address = self.data_server.address
        conn.send(reg)
        ack = conn.recv()
        if not isinstance(ack, RegisterAck):
            conn.close()
            raise RayTpuError(f"the head refused the node: {ack!r}")
        self._ack = ack
        return conn

    def _boot(self, ack: RegisterAck) -> None:
        import multiprocessing as mp

        from . import _log_monitor
        from ._object_store import sweep_orphan_spills
        Config.initialize(_config_overrides(ack.config_blob))
        # Workers and actors authenticate with the cluster token, the
        # head's process key too: the driver's callers reach an actor of
        # this node directly.
        mp.current_process().authkey = self.token
        nid = self.node_id.binary()
        self.segment_prefix = f"{ack.session_id}_{nid.hex()[:8]}"
        session_dir = ack.session_dir or _log_monitor.create_session_dir()
        spill_root = Config.get("object_spill_dir") or os.path.join(
            session_dir, "spill")
        sweep_orphan_spills(spill_root)
        self.store = self._store_cls(Config.get("object_store_memory"),
                                     spill_dir=spill_root)
        self.data_server = DataServer(self.store, self.token,
                                      advertise_host=self.advertise_host)
        self.data_client = DataClient(self.token)
        self.puller = ObjectPuller(self.store, self.data_client, nid,
                                   self._resolve_address,
                                   self.segment_prefix)
        self.head_node_id = ack.head_node_id_bytes
        self._addr_cache[ack.head_node_id_bytes] = tuple(
            ack.head_data_address)
        from ._node import NodeManager
        self.manager = NodeManager(
            self, nid, self.segment_prefix, self.store,
            os.path.join(session_dir, "nodes", nid.hex()[:12]),
            self.token, tuple(self.head_address) + (self.token,),
            list(ack.sys_path),
            self.num_cpus, self.num_cards)
        self.log_monitor = _log_monitor.LogMonitor(
            self.manager.logs_dir, emit=self._emit_log)
        self.log_monitor.start()
        # The data server's address went out before it existed: tell the
        # head now (a view carries it).
        self._threads = [
            _sanitizer.spawn(self._queue_loop, name="node-queue"),
            _sanitizer.spawn(self._syncer_loop, name="node-syncer"),
        ]
        self._sync_view(force=True)

    def _resolve_address(self, node_id_bytes: bytes):
        addr = self._addr_cache.get(node_id_bytes)
        if addr is None:
            try:
                addr = self.node_rpc("node_data_address", node_id_bytes)
            except Exception:  # noqa: BLE001 - the head cannot say
                addr = None
            if addr is not None:
                addr = tuple(addr)
                self._addr_cache[node_id_bytes] = addr
        return addr

    def export(self, desc):
        return export_desc(desc, self.node_id.binary())

    # -- sending up ----------------------------------------------------------------

    def send_up(self, msg) -> None:
        with self._send_lock:
            self._up_seq += 1
            frame = ("useq", self._up_seq, self.last_down_seq, msg)
            if not isinstance(msg, (Pong, UpSyncView, UpLogLines)):
                self._ring.append(frame)
            try:
                self.conn.send(frame)
            except (BrokenPipeError, OSError):
                pass            # resent after the re-attach

    def node_rpc(self, method: str, *args, timeout: float = 30.0):
        rid = next(self._rpc_ids)
        slot = [threading.Event(), None]
        self._rpc_waiting[rid] = slot
        self.send_up(NodeRpc(rid, method, args))
        if not slot[0].wait(timeout):
            self._rpc_waiting.pop(rid, None)
            raise TimeoutError(f"node rpc {method} timed out")
        reply = slot[1]
        if reply.error is not None:
            raise RayTpuError(reply.error)
        return reply.value

    def _emit_log(self, fname: str, line: str) -> None:
        self.send_up(UpLogLines([(fname, line)]))

    def _sync_view(self, force: bool = False) -> None:
        view = self.manager.view()
        view["transfer"] = transfer_stats()
        view["data_address"] = self.data_server.address
        key = {k: v for k, v in view.items() if k != "memory_total_bytes"}
        if force or key != getattr(self, "_last_view", None):
            self._last_view = key
            self._view_version += 1
            self.send_up(UpSyncView(self._view_version, view))

    def _syncer_loop(self) -> None:
        while not self._closed.wait(SYNC_PERIOD_S):
            try:
                self._sync_view()
            except Exception as e:  # noqa: BLE001 - the next period retries
                from .util import telemetry
                telemetry.note_swallowed("node.syncer", e)

    # -- serving -------------------------------------------------------------------

    def serve_forever(self) -> None:
        while not self._closed.is_set():
            try:
                # Only this thread swaps the connection (``_try_rejoin``).
                frame = self.conn.recv()  # ray-tpu: noqa[RT401]
            except (EOFError, OSError):
                if self._closed.is_set() or not self._try_rejoin():
                    break
                continue
            except Exception:  # noqa: BLE001 - a frame it cannot load
                continue
            if isinstance(frame, tuple) and frame and frame[0] == "dseq":
                _tag, seq, acked, msg = frame
                with self._send_lock:
                    while self._ring and self._ring[0][1] <= acked:
                        self._ring.popleft()
                    if seq <= self.last_down_seq:
                        continue
                    self.last_down_seq = seq
            else:
                msg = frame
            self._handle(msg)
        self.shutdown()

    def _handle(self, msg) -> None:
        if isinstance(msg, Ping):
            self.send_up(Pong(msg.t))
        elif isinstance(msg, (DispatchTask, StartActor)):
            self._queue.put(msg)
        elif isinstance(msg, ToWorker):
            self.manager.send_to_worker(msg.worker_id, msg.msg)
        elif isinstance(msg, KillActorWorker):
            self.manager.kill_actor(msg.actor_id)
        elif isinstance(msg, FreeObject):
            for name in msg.names:
                self.store.delete(name)
        elif isinstance(msg, StackDumpAll):
            ids = self.manager.stack_dump(msg.dump_id)
            self.send_up(UpStackExpect(msg.dump_id, ids))
        elif isinstance(msg, NodeRpcReply):
            slot = self._rpc_waiting.pop(msg.request_id, None)
            if slot is not None:
                slot[1] = msg
                slot[0].set()
        elif isinstance(msg, NodeShutdown):
            self._closed.set()

    def _queue_loop(self) -> None:
        """Dispatches and actor starts, in arrival order, off the
        reader."""
        while True:
            msg = self._queue.get()
            if msg is None:
                return
            try:
                if isinstance(msg, DispatchTask):
                    self.manager.run_task(msg)
                else:
                    self.manager.start_actor(msg)
            except Exception as e:  # noqa: BLE001 - reported up
                if isinstance(msg, DispatchTask):
                    self.send_up(UpDispatchFailed(
                        msg.kwargs["tid"], _error_text(e)))
                else:
                    self.send_up(UpActorState(msg.actor_id, "exit",
                                              _error_text(e), 0))

    def _try_rejoin(self) -> bool:
        """Dial the head again under this node's identity until the grace
        runs out; True once re-attached."""
        grace = float(Config.get("node_reconnect_grace_s"))
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline and not self._closed.is_set():
            with self._send_lock:
                last_down_seq = self.last_down_seq
            try:
                conn = self._connect(RegisterNode(
                    socket.gethostname(), self._resources, self.num_cards,
                    self.data_server.address, os_pid=os.getpid(),
                    rejoin_node_id=self.node_id.binary(),
                    last_down_seq=last_down_seq))
            except Exception:  # noqa: BLE001 - the head is not back yet
                time.sleep(0.2)
                continue
            ack = self._ack
            if ack.node_id_bytes != self.node_id.binary():
                conn.close()
                return False
            self._addr_cache = {ack.head_node_id_bytes:
                                tuple(ack.head_data_address)}
            with self._send_lock:
                self.conn = conn
                if ack.wal_resumed:
                    self.last_down_seq = 0
                # What the head has not processed goes again, in order.
                resend = [f for f in self._ring if f[1] > ack.last_up_seq]
                for f in resend:
                    try:
                        conn.send(f)
                    except (BrokenPipeError, OSError):
                        break
            if ack.wal_resumed:
                # The restarted head knows none of this node's actors:
                # they restart elsewhere from their creation specs.
                for aid in list(self.manager.actors):
                    self.manager.kill_actor(aid)
            self._sync_view(force=True)
            return True
        return False

    def shutdown(self) -> None:
        self._closed.set()
        self._queue.put(None)
        if self.manager is not None:
            self.manager.shutdown()
        if self.log_monitor is not None:
            self.log_monitor.stop()
        if self.data_server is not None:
            self.data_server.shutdown()
        if self.data_client is not None:
            self.data_client.shutdown()
        with self._send_lock:
            conn = self.conn
        try:
            conn.close()
        except OSError:
            pass
        if self.store is not None:
            self.store.shutdown()


def _config_overrides(blob: str) -> Dict[str, Any]:
    import json
    try:
        return json.loads(blob) if blob else {}
    except ValueError:
        return {}


def run_node_server(head_host: str, head_port: int, token: bytes,
                    num_cpus: float = 1.0, num_tpus: Optional[int] = None,
                    resources: Optional[Dict[str, float]] = None,
                    advertise_host: str = "127.0.0.1") -> None:
    """Join the head and serve until told to stop (or the head is gone
    past the grace)."""
    server = NodeServer((head_host, head_port), token, num_cpus, num_tpus,
                        resources, advertise_host)
    import signal

    def on_term(signum, frame):
        server._closed.set()
        try:
            server.conn.close()
        except OSError:
            pass

    signal.signal(signal.SIGTERM, on_term)
    server.serve_forever()


def main(argv=None) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch._node_server_main")
    p.add_argument("--address", required=True, help="the head's host:port")
    p.add_argument("--token", required=True, help="the cluster token")
    p.add_argument("--num-cpus", type=float, default=1.0)
    p.add_argument("--num-tpus", type=int, default=None,
                   help="cards this node offers (default: those detected)")
    p.add_argument("--resources", default=None,
                   help="custom resources, as JSON")
    p.add_argument("--advertise-host", default="127.0.0.1",
                   help="the address other nodes pull this node's "
                        "objects from (the head takes nodes of its own "
                        "host only, until ROADMAP item 13 part 3)")
    args = p.parse_args(argv)
    host, port = args.address.rsplit(":", 1)
    run_node_server(host, int(port), args.token.encode(), args.num_cpus,
                    args.num_tpus,
                    json.loads(args.resources) if args.resources else None,
                    args.advertise_host)
    return 0


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

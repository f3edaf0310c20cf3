"""A node's worker pool (the port of ``ray_tpu/_private/node.py``'s
``NodeManager`` and ``WorkerHandle``), run inside a node process
(``_cluster.NodeServer``).

The head places a task on this node; the node runs it on one of its own
workers:

- a worker is ``python -m ray_tpu_torch._worker_main``, started with
  ``subprocess`` in the node's process group (a node killed with its
  group takes its workers along; a worker also exits on EOF of its
  socket and when its parent is gone).  It dials the node's unix socket
  and registers with its worker id; one that does not register within
  ``worker_register_timeout_s`` is killed (the register watchdog);
- idle workers are pooled per env signature (the task's ``env_vars``,
  device and runtime env); a task holding cards gets exactly its granted
  cards through ``CUDA_VISIBLE_DEVICES`` (``_scheduler.CardPool``, the
  same grant the session's node makes) and its worker exits after it:
  card workers are not pooled, as in JAX;
- frames to a worker go through its send loop, which coalesces what is
  pending into one list frame (``_wire``);
- a worker's stdout and stderr go to ``<session>/logs/worker-<id>.out``
  and ``.err`` (``_log_monitor`` tails them up to the head);
- a worker that dies reports its running task up (``UpWorkerDied``): the
  head retries it under ``max_retries`` or fails it.

Results are sealed by the worker into segments named
``rtt_<session>_<node>_<id>``; the node adopts each into its store
(``_object_store.SharedMemoryStore`` with a spill directory) and sends
the descriptors up tagged with its node id (``_cluster.tag_desc``).

Actors placed here start as the session's actors do (``_actor._actor_main``
under ``torch.multiprocessing``'s spawn), watched by a thread that sends
their state and their exit up to the head.
"""

from __future__ import annotations

import collections
import os
import pickle
import queue
import subprocess
import sys
import threading
import time
import uuid
from multiprocessing.connection import Listener
from typing import Any, Deque, Dict, List, Optional

from . import _sanitizer, _wire

#: Tasks a busy worker may hold queued behind the one it runs (pipelined
#: submission: the head credits a node this many a CPU).
PIPELINE_DEPTH = 2
#: Seconds a spawned worker has to dial back and register.
REGISTER_TIMEOUT_S = 60.0


class WorkerHandle:
    """The node's side of one worker process."""

    def __init__(self, manager: "NodeManager", worker_id: bytes,
                 env_key: tuple, proc: subprocess.Popen):
        self.manager = manager
        self.worker_id = worker_id
        self.env_key = env_key
        self.proc = proc
        self.conn = None
        self.ready = threading.Event()
        #: Task ids (the head's) running on it, with their messages.
        self.running: Dict[int, Any] = {}
        self.holds_cards = False
        self.cards: List[int] = []
        self.dead = False
        self.retire = False
        self._out: "queue.Queue" = queue.Queue()
        self.register_watchdog: Optional[threading.Timer] = None

    def send(self, msg) -> None:
        """Queue ``msg`` for the send loop (frames before the worker
        registers wait there)."""
        self._out.put(msg)

    def _send_loop(self) -> None:
        """Coalesce what is pending into one list frame per write."""
        while True:
            msg = self._out.get()
            if msg is None:
                return
            batch = [msg]
            while True:
                try:
                    nxt = self._out.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._out.put(None)
                    break
                batch.append(nxt)
            frame = batch[0] if len(batch) == 1 else batch
            try:
                self.conn.send_bytes(pickle.dumps(frame, protocol=5))
            except (OSError, EOFError, BrokenPipeError):
                return

    def stop(self) -> None:
        self._out.put(None)
        t = self.register_watchdog
        if t is not None:
            t.cancel()
        if self.proc.poll() is None:
            self.proc.kill()


class NodeManager:
    """The node's workers and actors (JAX: ``NodeManager``)."""

    def __init__(self, server, node_id: bytes, segment_prefix: str,
                 store, session_dir: str, authkey: bytes,
                 head_endpoint: tuple, sys_path: List[str],
                 num_cpus: float, num_cards: int):
        from ._scheduler import CardPool
        self.server = server
        self.node_id = node_id
        self.segment_prefix = segment_prefix
        self.store = store
        self.session_dir = session_dir
        self.logs_dir = os.path.join(session_dir, "logs")
        os.makedirs(self.logs_dir, exist_ok=True)
        self.authkey = authkey
        self.head_endpoint = head_endpoint
        self.sys_path = sys_path
        self.max_idle = max(1, int(num_cpus))
        self.cards = CardPool(num_cards)
        self._lock = threading.RLock()
        self.workers: Dict[bytes, WorkerHandle] = {}
        self.idle: Dict[tuple, Deque[WorkerHandle]] = {}
        self.actors: Dict[str, Any] = {}
        self._stop = threading.Event()
        self.tasks_run = 0
        sock_dir = os.path.join(session_dir, "sockets")
        os.makedirs(sock_dir, exist_ok=True)
        self.sock_path = os.path.join(
            sock_dir, f"node-{node_id.hex()[:12]}-{os.getpid()}.sock")
        self._listener = Listener(self.sock_path, "AF_UNIX",
                                  authkey=authkey)
        self._threads: List[threading.Thread] = [
            _sanitizer.spawn(self._accept_loop, name="node-accept")]

    # -- workers ---------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except Exception:  # noqa: BLE001 - a failed handshake, or closed
                if self._stop.is_set():
                    return
                continue
            _sanitizer.spawn(self._register, args=(conn,),
                             name="node-register")

    def _register(self, conn) -> None:
        try:
            _kind, worker_id, _pid = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError, ValueError):
            conn.close()
            return
        with self._lock:
            h = self.workers.get(worker_id)
        if h is None or h.dead:
            conn.close()
            return
        t, h.register_watchdog = h.register_watchdog, None
        if t is not None:
            t.cancel()
        h.conn = conn
        _sanitizer.spawn(h._send_loop, name="node-worker-send")
        h.ready.set()
        self._reader(h)

    def _spawn_worker(self, env_key: tuple) -> WorkerHandle:
        worker_id = uuid.uuid4().bytes[:16]
        child_env = dict(os.environ)
        child_env.update(dict(env_key))
        child_env.update({
            "RAY_TPU_WORKER_ID": worker_id.hex(),
            "RAY_TPU_NODE_SOCK": self.sock_path,
            "RAY_TPU_AUTHKEY": self.authkey.hex(),
            "RAY_TPU_NODE_ID": self.node_id.hex(),
            "RAY_TPU_SEGMENT_PREFIX": self.segment_prefix,
            "RAY_TPU_HEAD_ENDPOINT": pickle.dumps(
                tuple(self.head_endpoint)).hex(),
            # Functions pickle by reference: the head's and this node's
            # paths travel to the worker, which imports their modules.
            "RAY_TPU_SYS_PATH": os.pathsep.join(
                p for p in list(self.sys_path) + sys.path
                if p and os.path.exists(p)),
        })
        tag = f"worker-{worker_id.hex()[:8]}"
        files = [open(os.path.join(self.logs_dir, tag + ext), "ab")
                 for ext in (".out", ".err")]
        python = child_env.pop("RAY_TPU_PYTHON", sys.executable)
        try:
            proc = subprocess.Popen(
                [python, "-m", "ray_tpu_torch._worker_main"],
                env=child_env, cwd=os.getcwd(), stdout=files[0],
                stderr=files[1])
        finally:
            for f in files:
                f.close()
        h = WorkerHandle(self, worker_id, env_key, proc)
        with self._lock:
            self.workers[worker_id] = h
        t = threading.Timer(REGISTER_TIMEOUT_S, self._register_timed_out,
                            args=(h,))
        t.daemon = True
        h.register_watchdog = t
        t.start()
        return h

    def _register_timed_out(self, h: WorkerHandle) -> None:
        if not h.ready.is_set():
            h.stop()
            try:
                h.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            self._worker_died(h)

    def _reader(self, h: WorkerHandle) -> None:
        while True:
            try:
                frame = pickle.loads(h.conn.recv_bytes())
            except (EOFError, OSError):
                break
            except Exception:  # noqa: BLE001 - a frame this node cannot load
                break
            for msg in (frame if isinstance(frame, list) else [frame]):
                try:
                    self._on_worker_msg(h, msg)
                except Exception as e:  # noqa: BLE001 - keep reading
                    from .util import telemetry
                    telemetry.note_swallowed("node.worker_msg", e)
        try:
            h.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            h.proc.kill()
        self._worker_died(h)

    def _on_worker_msg(self, h: WorkerHandle, msg) -> None:
        from ._cluster import UpStackReply, UpTaskDone, UpWorkerRequest
        tag = msg[0]
        if tag == _wire.TASK_DONE:
            tid = msg[8]
            self.tasks_run += 1
            if msg[4] is None:
                descs = [d for _oid, d in msg[3]]
                for d in descs:
                    self._adopt(d)
                reply = ("ok", tid, [self.server.export(d) for d in descs],
                         [[self.server.export(d) for d in inner]
                          for inner in msg[9]], msg[10], msg[11])
            else:
                reply = ("err", tid, msg[4][1], msg[10], msg[11])
            self._task_ended(h, tid)
            self.server.send_up(UpTaskDone(
                reply, h.worker_id, msg[7],
                tuple(oid for oid, _d in msg[3])))
        elif tag in ("item", "end"):
            if tag == "item":
                self._adopt(msg[2])
                msg = (tag, msg[1], self.server.export(msg[2]),
                       [self.server.export(d) for d in msg[3]])
                self.server.send_up(UpTaskDone(msg, h.worker_id, 0.0))
            else:
                self._task_ended(h, msg[1])
                self.server.send_up(UpTaskDone(msg, h.worker_id, 0.0))
        elif tag == "stack":
            self.server.send_up(UpStackReply(msg[1], msg[2]))
        elif tag in ("localize", "restore"):
            _sanitizer.spawn(self._answer_local, args=(h, msg),
                             name="node-localize")
        else:
            # A nested submit, get, poll, next item or the plane's
            # address: the head answers (ToWorker).  A submit's packed
            # arguments leave this node: their descriptors are tagged.
            if tag == "submit":
                msg = msg[:5] + (self.server.export(msg[5]),)
            tid = next(iter(h.running), None)
            self.server.send_up(UpWorkerRequest(h.worker_id, tid, msg))

    def _answer_local(self, h: WorkerHandle, msg) -> None:
        kind, rid, desc = msg
        try:
            if kind == "localize":
                out = ("value", self.server.puller.localize(desc))
            else:
                ok = self.store.restore(desc[1]) is not None
                out = ("restored",) if ok else ("missing",)
        except Exception as e:  # noqa: BLE001 - raised in the worker
            from ._tasks import _error_blob
            out = ("error", _error_blob(e))
        h.send(("reply", rid, out))

    def _adopt(self, desc) -> None:
        if desc[0] == "shm":
            try:
                self.store.adopt_segment(desc[1], desc[2])
            except Exception as e:  # noqa: BLE001 - the store is full
                from .util import telemetry
                telemetry.note_swallowed("node.adopt", e)

    def _task_ended(self, h: WorkerHandle, tid) -> None:
        with self._lock:
            h.running.pop(tid, None)
            if h.running:
                return
            cards, h.cards = h.cards, []
            if h.holds_cards or self._stop.is_set():
                h.retire = True
            elif not h.dead:
                q = self.idle.setdefault(h.env_key, collections.deque())
                if sum(len(v) for v in self.idle.values()) < self.max_idle:
                    q.append(h)
                else:
                    h.retire = True
        self.cards.give_back(cards)
        if h.retire:
            h.stop()

    def _worker_died(self, h: WorkerHandle) -> None:
        from ._cluster import UpWorkerDied
        with self._lock:
            if h.dead:
                return
            h.dead = True
            self.workers.pop(h.worker_id, None)
            q = self.idle.get(h.env_key)
            if q is not None and h in q:
                q.remove(h)
            running, h.running = list(h.running), {}
            cards, h.cards = h.cards, []
        self.cards.give_back(cards)
        h.stop()
        if running and not self._stop.is_set():
            self.server.send_up(UpWorkerDied(h.worker_id, running,
                                             h.proc.returncode))

    # -- tasks -------------------------------------------------------------------

    def run_task(self, msg) -> None:
        """Run a dispatched task (``DispatchTask``) on a worker of its env
        signature: an idle one, or a new one."""
        from ._cluster import UpDispatchFailed
        spec, opts = msg.spec, msg.kwargs
        try:
            cards = self.cards.take(spec)
        except RuntimeError as e:
            self.server.send_up(UpDispatchFailed(opts["tid"], str(e)))
            return
        from ._scheduler import CardPool
        env = dict(opts.get("env") or {})
        env.update(CardPool.env(cards))
        env_key = tuple(sorted(env.items()))
        args_desc = self.server.puller.localize(msg.args[0])
        if args_desc[0] == "err":
            self.cards.give_back(cards)
            self.server.send_up(UpDispatchFailed(
                opts["tid"], "its arguments could not be pulled"))
            return
        run_opts = {k: v for k, v in opts.items() if k != "env"}
        frame = _wire.encode_run_task(spec, [args_desc], run_opts,
                                      spec.fn_blob)
        with self._lock:
            h = None
            if not cards:
                q = self.idle.get(env_key)
                while q:
                    cand = q.popleft()
                    if not cand.dead:
                        h = cand
                        break
            if h is None and msg.pipelined:
                # Queue ahead on a busy worker of the signature with room
                # (it runs its tasks one at a time), or refuse.
                room = [w for w in self.workers.values()
                        if w.env_key == env_key and not w.dead
                        and not w.holds_cards and w.running
                        and len(w.running) <= PIPELINE_DEPTH]
                if not room:
                    from ._cluster import UpPipelineReject
                    self.server.send_up(UpPipelineReject(opts["tid"]))
                    return
                h = min(room, key=lambda w: len(w.running))
            if h is None:
                h = self._spawn_worker(env_key)
            h.running[opts["tid"]] = spec.name
            h.holds_cards = bool(cards)
            h.cards = cards
        h.send(frame)
        from ._cluster import UpNoteTaskRunning
        self.server.send_up(UpNoteTaskRunning(opts["tid"], h.worker_id))

    def send_to_worker(self, worker_id: bytes, msg) -> None:
        with self._lock:
            h = self.workers.get(worker_id)
        if h is not None:
            h.send(msg)

    # -- actors ------------------------------------------------------------------

    def start_actor(self, msg) -> None:
        """Start an actor placed here (``StartActor``), pinned to its
        granted cards, and watch it."""
        from ._cluster import UpActorState
        try:
            cards = self.cards.take(msg.spec_resources)
        except RuntimeError as e:
            self.server.send_up(UpActorState(msg.actor_id, "exit", str(e),
                                             -1))
            return
        from ._scheduler import CardPool
        env = dict(msg.env)
        env.update(CardPool.env(cards))
        import torch.multiprocessing as mp

        from ._actor import _actor_main, _child_environment
        spec = dict(msg.spec, head=tuple(self.head_endpoint))
        ctx = mp.get_context("spawn")
        parent, child = ctx.Pipe(duplex=True)
        with _child_environment(env):
            proc = ctx.Process(target=_actor_main, args=(spec, child),
                               daemon=True, name=f"actor-{msg.qualname}")
            proc.start()
        child.close()
        with self._lock:
            self.actors[msg.actor_id] = proc
        _sanitizer.spawn(self._watch_actor,
                         args=(msg.actor_id, proc, parent, cards),
                         name=f"node-actor-watch-{msg.actor_id[:8]}")

    def _watch_actor(self, actor_id: str, proc, conn, cards) -> None:
        from ._cluster import UpActorState
        from ._protocol import ActorStateMsg
        while True:
            try:
                m = conn.recv()
            except (EOFError, OSError):
                break
            if isinstance(m, ActorStateMsg):
                self.server.send_up(UpActorState(actor_id, m.state,
                                                 m.error, proc.pid))
        proc.join()
        conn.close()
        self.cards.give_back(cards)
        with self._lock:
            if self.actors.get(actor_id) is proc:
                self.actors.pop(actor_id, None)
        if not self._stop.is_set():
            self.server.send_up(UpActorState(actor_id, "exit",
                                             proc.exitcode, proc.pid))

    def kill_actor(self, actor_id: str) -> None:
        with self._lock:
            proc = self.actors.get(actor_id)
        if proc is not None and proc.is_alive():
            proc.kill()

    # -- diagnostics and views ----------------------------------------------------

    def stack_dump(self, dump_id: int) -> List[str]:
        """Ask every registered worker for its stacks (each answers on its
        receive thread); the ids asked, which the head expects."""
        with self._lock:
            live = [h for h in self.workers.values()
                    if h.ready.is_set() and not h.dead]
        for h in live:
            h.send(("stack", dump_id))
        return [h.worker_id.hex() for h in live]

    def view(self) -> Dict[str, Any]:
        from ._scheduler import _host_memory
        with self._lock:
            workers = len(self.workers)
            running = sum(len(h.running) for h in self.workers.values())
            actors = len(self.actors)
        return {"workers": workers, "running_tasks": running,
                "actors": actors, "tasks_run": self.tasks_run,
                "memory_total_bytes": int(_host_memory()),
                "store": self.store.stats()}

    def worker_pids(self) -> List[int]:
        with self._lock:
            pids = [h.proc.pid for h in self.workers.values()]
            pids += [p.pid for p in self.actors.values()]
        return pids

    def shutdown(self) -> None:
        self._stop.set()
        with self._lock:
            workers = list(self.workers.values())
            actors = list(self.actors.values())
        for h in workers:
            h.stop()
        for p in actors:
            if p.is_alive():
                p.kill()
        try:
            self._listener.close()
        except OSError:
            pass
        for h in workers:
            try:
                h.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        for p in actors:
            p.join(timeout=10)
        try:
            os.unlink(self.sock_path)
        except FileNotFoundError:
            pass

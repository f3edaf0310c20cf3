"""The task loop every worker process runs (the task execution of
``ray_tpu/_private/worker.py``), shared by the two kinds of worker:

- the session's own workers (``_tasks``' pool: spawned by the driver,
  a ``multiprocessing`` pipe each, ``_tasks._DriverLink``);
- a node's workers (``_node.NodeManager``: ``python -m
  ray_tpu_torch._worker_main``, which dials its node's unix socket and
  registers; ``NodeLink`` below speaks ``_wire``'s frames).

Both take one task at a time: resolve the function by reference, load the
arguments (top-level refs become their values), run it, seal each return
value (inline, or a shared-memory segment of this process's node) and
send the descriptors back with this process's telemetry, user metrics and
finished spans.  A task's nested ``.remote()``, ``get``, ``put`` and
actor lookups go over the same link: to the driver, or to the node, which
relays them to the head.

A node's worker answers a stack dump on its receive thread (the thread
that reads the link, never the one running the task), so a task wedged in
user code does not stop it from answering; a worker that cannot answer at
all is reported unresponsive by the head.
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from . import _tasks, _wire


def watch_parent(parent: int) -> None:
    """Exit once the process that started this one is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(0)
        time.sleep(0.5)


def boot_worker_env() -> None:
    """Isolation and runtime env of a worker, applied before any task:
    the rlimit tier, ``working_dir``/``py_modules``, and a pip env's venv
    site directory ahead of the parent's paths."""
    from . import _cgroup, _runtime_env
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


#: thread ident -> (task id hex, task name) of the task it runs (the
#: stack dump names what each thread is running).
thread_tasks: Dict[int, tuple] = {}


def run_loop(link, pid: int) -> None:
    """Take tasks from ``link`` until it closes (the shared loop)."""
    from ._actor import ObjectRef
    from .exceptions import TaskError
    last_snap = None
    from .util import tracing
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
            tracing_mod = sys.modules.get("ray_tpu_torch.util.tracing")
            spans = tracing_mod._drain() if tracing_mod is not None \
                else None
            if not (tel_snap or user or spans):
                return None
            return tel_snap, user, spans

        _tasks._in_worker["link"] = link
        me = threading.get_ident()
        thread_tasks[me] = (f"{tid:x}", name)
        try:
            fn = _tasks._resolve_fn(fn_blob)
            args, kwargs = _tasks._load(args_desc)
            # Top-level refs become their values (JAX's worker resolves
            # them); refs nested in containers stay refs.
            args = [_tasks._load(a._fut.result())
                    if isinstance(a, ObjectRef) else a for a in args]
            kwargs = {k: _tasks._load(v._fut.result())
                      if isinstance(v, ObjectRef) else v
                      for k, v in kwargs.items()}
            with tracing.task_span(opts.get("trace"), name, f"{tid:x}"):
                result = fn(*args, **kwargs)
                if opts["streaming"]:
                    for item in result:
                        inner: list = []
                        desc = _tasks._seal(item, f"an item of {name}",
                                            inner)
                        link.send(("item", tid, desc, inner))
            if opts["streaming"]:
                _tasks._in_worker["link"] = None
                link.send(("end", tid, pid, snap()))
                continue
            n = opts["num_returns"]
            values = [result] if n == 1 else list(result)
            if len(values) != n:
                raise ValueError(f"task {name!r} returned {len(values)} "
                                 f"values; num_returns={n}")
            inners: List[list] = [[] for _ in values]
            descs = [_tasks._seal(v, f"the result of {name}", i)
                     for v, i in zip(values, inners)]
            _tasks._in_worker["link"] = None
            link.send(("ok", tid, descs, inners, pid, snap()))
        except BaseException as e:  # noqa: BLE001 - back to the caller
            _tasks._in_worker["link"] = None
            err = e if isinstance(e, TaskError) else TaskError(
                e, name, traceback.format_exc())
            try:
                blob = pickle.dumps(err)
            except Exception:  # noqa: BLE001 - the cause won't pickle
                blob = pickle.dumps(TaskError(RuntimeError(repr(e)), name,
                                              traceback.format_exc()))
            link.send(("err", tid, blob, pid, snap()))
        finally:
            thread_tasks.pop(me, None)


class NodeLink(_tasks._DriverLink):
    """A node's worker's side of its unix socket (``_tasks._DriverLink``'s
    requests and task queue): ``_wire``'s RUN_TASK frames become the
    loop's task messages and its results TASK_DONE frames; a stack
    request is answered here, on the receive thread."""

    def __init__(self, conn, worker_id: bytes):
        self.worker_id = worker_id
        #: The return ids and start of each task taken.
        self._running: Dict[int, tuple] = {}
        super().__init__(conn)

    def _on(self, msg) -> None:
        tag = msg[0]
        if tag == _wire.RUN_TASK:
            spec, args, opts = _wire.decode_run_task(msg)
            tid = opts["tid"]
            self._running[tid] = (spec.task_id.binary(),
                                  [r.binary() for r in spec.return_ids],
                                  time.monotonic())
            self.tasks.put(("task", tid, spec.name, spec.fn_blob, args[0],
                            opts))
        elif tag == "stack":
            from ._diagnostics import capture_process_stacks
            rec = capture_process_stacks(self.worker_id.hex(),
                                         thread_tasks=dict(thread_tasks))
            self.send(("stack", msg[1], rec))
        else:
            super()._on(msg)

    def send(self, msg: tuple) -> None:
        kind = msg[0]
        if kind in ("ok", "err"):
            task_id, return_ids, t0 = self._running.pop(msg[1])
            if kind == "ok":
                msg = _wire.encode_task_done(
                    task_id, self.worker_id, list(zip(return_ids, msg[2])),
                    None, False, None, time.monotonic() - t0) + (
                        msg[1], msg[3], msg[4], msg[5])
            else:
                msg = _wire.encode_task_done(
                    task_id, self.worker_id, [], ("err", msg[2]), True,
                    None, time.monotonic() - t0) + (msg[1], None, msg[3],
                                                    msg[4])
        elif kind == "end":
            self._running.pop(msg[1], None)
        super().send(msg)


def node_worker_main() -> None:
    """A node's worker (``python -m ray_tpu_torch._worker_main``): dial
    the node's socket, register, and run tasks until it closes."""
    for p in os.environ.get("RAY_TPU_SYS_PATH", "").split(os.pathsep):
        if p and p not in sys.path:
            sys.path.append(p)
    from multiprocessing.connection import Client

    from . import _sanitizer
    from ._config import Config
    Config.initialize()
    sock_path = os.environ["RAY_TPU_NODE_SOCK"]
    authkey = bytes.fromhex(os.environ["RAY_TPU_AUTHKEY"])
    worker_id = bytes.fromhex(os.environ["RAY_TPU_WORKER_ID"])
    head = os.environ.get("RAY_TPU_HEAD_ENDPOINT")
    import multiprocessing as mp
    mp.current_process().authkey = authkey
    _tasks._in_worker = {
        "session": os.environ["RAY_TPU_SEGMENT_PREFIX"], "link": None,
        "head": tuple(pickle.loads(bytes.fromhex(head))) if head else None,
        "node": bytes.fromhex(os.environ["RAY_TPU_NODE_ID"])}
    _sanitizer.spawn(watch_parent, args=(os.getppid(),),
                     name="node-worker-watch-parent")
    boot_worker_env()
    conn = Client(sock_path, "AF_UNIX", authkey=authkey)
    conn.send_bytes(pickle.dumps(("register", worker_id, os.getpid())))
    link = NodeLink(conn, worker_id)
    run_loop(link, os.getpid())

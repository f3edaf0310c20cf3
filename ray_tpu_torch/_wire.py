"""Compact wire encoding for the hot node<->worker messages (a copy of
``ray_tpu/_private/wire.py``, value for value).

``RunTask`` and ``TaskDone`` travel as plain tuples of bytes/str/int:
pickling one is far cheaper than pickling the nested dataclasses, and the
frame carries no class references.  Senders coalesce: a connection's
pending messages go out as ONE list frame (one pickle, one write), see
``_node.WorkerHandle._send_loop`` and ``_worker.NodeLink``.

A list frame means "batch"; a tuple frame dispatches on its tag string;
anything else is a cold-path message (``_protocol``'s dataclasses or the
port's own request tuples).

In the port a node's worker receives the task's packed arguments as the
one element of ``args`` (the descriptor of ``_tasks``' argument
envelope) and its run options as ``kwargs``; ``TaskDone``'s ``results``
pair each return id with its descriptor.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ._ids import ActorID, ObjectID, TaskID, WorkerID

RUN_TASK = "rt"
TASK_DONE = "td"


class WireSpec:
    """Worker-side view of a task spec, rebuilt from a wire tuple.

    Carries exactly the fields worker.py reads; driver-side scheduling
    state (resources, placement group, retry counts) never crosses the
    pipe for hot-path tasks.
    """

    __slots__ = ("task_id", "name", "fn_blob", "fn_id", "method_name",
                 "return_ids", "actor_id", "create_actor_id", "streaming",
                 "max_concurrency", "runtime_env", "trace_ctx")

    def __init__(self, task_id, name, fn_blob, fn_id, method_name,
                 return_ids, actor_id, streaming, max_concurrency,
                 runtime_env, trace_ctx=None):
        self.task_id = task_id
        self.name = name
        self.fn_blob = fn_blob
        self.fn_id = fn_id
        self.method_name = method_name
        self.return_ids = return_ids
        self.actor_id = actor_id
        self.create_actor_id = None
        self.streaming = streaming
        self.max_concurrency = max_concurrency
        self.runtime_env = runtime_env
        self.trace_ctx = trace_ctx


def encode_run_task(spec, args: List, kwargs: Dict,
                    fn_blob: Optional[bytes] = None) -> tuple:
    """spec -> wire tuple.  Caller guarantees spec.create_actor_id is None
    (creation ships the full dataclass: cold path, needs every field).
    ``fn_blob`` is the possibly-stripped blob for THIS worker (the node
    drops it once a worker has seen the fn_id)."""
    return (RUN_TASK,
            spec.task_id.binary(),
            spec.name,
            fn_blob,
            spec.fn_id,
            spec.method_name,
            tuple(r.binary() for r in spec.return_ids),
            spec.actor_id.binary() if spec.actor_id is not None else None,
            spec.streaming,
            spec.max_concurrency,
            spec.runtime_env.get("env_vars") if spec.runtime_env else None,
            args,
            kwargs,
            spec.trace_ctx)


def decode_run_task(t: tuple):
    """wire tuple -> (WireSpec, args, kwargs)."""
    env_vars = t[10]
    return (WireSpec(
        TaskID(t[1]), t[2], t[3], t[4], t[5],
        [ObjectID(b) for b in t[6]],
        ActorID(t[7]) if t[7] is not None else None,
        t[8], t[9],
        {"env_vars": env_vars} if env_vars else None,
        t[13] if len(t) > 13 else None,
    ), t[11], t[12])


def encode_task_done(task_id_bytes: bytes, worker_id_bytes: bytes,
                     results: List[Tuple[bytes, tuple]],
                     error: Optional[tuple], is_application_error: bool,
                     actor_id_bytes: Optional[bytes],
                     execution_time_s: float) -> tuple:
    return (TASK_DONE, task_id_bytes, worker_id_bytes, results, error,
            is_application_error, actor_id_bytes, execution_time_s)


def decode_task_done(t: tuple):
    """wire tuple -> protocol.TaskDone (driver side)."""
    from ._protocol import TaskDone
    return TaskDone(
        TaskID(t[1]), WorkerID(t[2]),
        [(ObjectID(b), desc) for b, desc in t[3]],
        t[4], t[5],
        ActorID(t[6]) if t[6] is not None else None,
        t[7])

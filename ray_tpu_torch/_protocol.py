"""The messages of the head's client channel (a copy of the part of
``ray_tpu/_private/protocol.py`` that the head and its clients carry):
small dataclasses sent as pickles over a ``multiprocessing.connection``.

``TaskSpec`` is also the scheduler's spec (``_scheduler``) and an actor's
creation spec in the controller's table (``_controller``), which the WAL
persists.  ``TaskDone`` is what a node's worker reports (built from
``_wire``'s frame on the node's side).

Value descriptors on the client channel:
    ("inline", payload_bytes)   -- a packed payload (``_serialization``)
    ("err", payload_bytes)      -- a packed exception
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ._ids import ActorID, ObjectID, PlacementGroupID, TaskID, WorkerID
from ._resources import ResourceSet

ValueDesc = Tuple  # ("inline", bytes) | ("err", bytes)


@dataclass
class TaskSpec:
    task_id: TaskID
    name: str
    # One of: serialized function (normal task / actor ctor) or method name.
    fn_blob: Optional[bytes]
    method_name: Optional[str]
    # Args are ObjectIDs (dependencies) or already-serialized inline values.
    arg_descs: List[Tuple[str, Any]]  # ("ref", ObjectID) | ("val", bytes)
    kwarg_descs: Dict[str, Tuple[str, Any]]
    return_ids: List[ObjectID]
    resources: ResourceSet
    actor_id: Optional[ActorID] = None        # actor method target
    create_actor_id: Optional[ActorID] = None  # actor construction
    max_retries: int = 0
    retry_count: int = 0
    placement_group: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    scheduling_strategy: Optional[Any] = None
    runtime_env: Optional[Dict[str, Any]] = None
    max_concurrency: int = 1
    submitter: str = "driver"  # worker id hex of the submitting process
    # num_returns="streaming": results stream item-by-item as
    # ObjectID.of(task_id, i); a ("end",) marker closes the stream
    # (reference: ObjectRefStream, src/ray/core_worker/task_manager.h:86).
    streaming: bool = False
    # Stable identity of fn_blob (reference: the GCS function table —
    # functions are exported once and referenced by id).  When set, the
    # node strips fn_blob for workers that have already received it, and
    # workers reuse the unpickled callable instead of re-loading per task.
    fn_id: Optional[bytes] = None
    # W3C traceparent of the submit span (reference:
    # tracing_helper.py:34 — span context propagated in task metadata);
    # None unless tracing is enabled on the submitting process.
    trace_ctx: Optional[str] = None
    # ObjectIDs pickled INSIDE argument values (nested refs): tracked as
    # borrows — retained until this task completes, escalated to
    # escaped-forever only if the worker still holds them afterwards
    # (reference: reference_counter.h:44 borrower bookkeeping).
    nested_refs: Tuple = ()


@dataclass
class TaskDone:
    """worker -> node: task finished."""
    task_id: TaskID
    worker_id: WorkerID
    results: List[Tuple[ObjectID, ValueDesc]]
    error: Optional[ValueDesc] = None
    is_application_error: bool = False
    actor_id: Optional[ActorID] = None
    execution_time_s: float = 0.0


@dataclass
class SubmitFromWorker:
    """worker -> node: nested task/actor submission."""
    spec: TaskSpec


@dataclass
class GetRequest:
    """worker -> node: resolve object values for a blocking get."""
    request_id: int
    worker_id: WorkerID
    object_ids: List[ObjectID]
    timeout_s: Optional[float] = None


@dataclass
class GetReply:
    """node -> worker."""
    request_id: int
    values: List[ValueDesc]
    timed_out: bool = False


@dataclass
class WaitRequest:
    request_id: int
    worker_id: WorkerID
    object_ids: List[ObjectID]
    num_returns: int
    timeout_s: Optional[float]
    fetch_local: bool = True


@dataclass
class WaitReply:
    request_id: int
    ready: List[ObjectID]


@dataclass
class PutFromWorker:
    """worker -> node: register a worker-created object."""
    object_id: ObjectID
    desc: ValueDesc
    owner_hint: Optional[str] = None


@dataclass
class ActorStateMsg:
    """worker -> node: actor constructor finished / actor died.

    ``direct_addr`` is the worker's direct-call listener (direct.py):
    peers push actor calls straight to it after resolving through the
    head (reference: actor_task_submitter.h:68 caller->actor stream)."""
    actor_id: ActorID
    state: str  # "alive" | "error"
    error: Optional[ValueDesc] = None
    direct_addr: Optional[Tuple[str, int]] = None


@dataclass
class ContainedRefs:
    """worker -> node: ``inner`` ObjectRefs were serialized INSIDE the
    value of ``outer`` (a task result / stream item / worker put).  The
    owner retains the inner objects for exactly as long as the outer
    object lives — freeing the outer releases them — instead of pinning
    them forever (reference: reference_counter.h:44 nested-ref
    containment via serializer hooks)."""
    outer: ObjectID
    inner: List[ObjectID]


@dataclass
class RpcCall:
    """worker -> node: generic control-plane call (KV, actor lookup, ...)."""
    request_id: int
    worker_id: WorkerID
    method: str
    args: Tuple
    kwargs: Dict


@dataclass
class RpcReply:
    request_id: int
    value: Any = None
    error: Optional[str] = None

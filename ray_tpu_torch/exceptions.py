"""The error types of the port, in one place (a copy of
``ray_tpu/_private/exceptions.py``).

Every tier raises these classes: ``_actor``, ``_tasks``, the head
(``_cluster``) and its client (``_client``) import them from here, so an
``except`` written against any of them catches what each tier raises.
"""

from __future__ import annotations

import traceback
from typing import Any, Optional


class RayTpuError(Exception):
    """Base of every runtime error."""


class TaskError(RayTpuError):
    """A task or an actor method raised; re-raised at ``get`` with the
    remote traceback (its ``cause`` is the exception)."""

    def __init__(self, cause: BaseException, task_name: str = "",
                 remote_traceback: str = ""):
        self.cause = cause
        self.task_name = task_name
        self.remote_traceback = remote_traceback
        super().__init__(
            f"task {task_name!r} failed: {type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{remote_traceback}")

    @classmethod
    def from_exception(cls, exc: BaseException,
                       task_name: str = "") -> "TaskError":
        return cls(exc, task_name, traceback.format_exc())

    def __reduce__(self):
        return (TaskError, (self.cause, self.task_name,
                            self.remote_traceback))


class ActorError(RayTpuError):
    """The actor died before or while running the method."""

    def __init__(self, actor_id: Any = None, cause: Optional[str] = None):
        self.actor_id = actor_id
        self.reason = cause
        super().__init__(
            f"actor {actor_id} is dead: {cause or 'unknown cause'}")

    def __reduce__(self):
        return (ActorError, (self.actor_id, self.reason))


class ActorUnavailableError(RayTpuError):
    """The actor cannot be reached for now (it is restarting)."""


class WorkerCrashedError(RayTpuError):
    """The worker process died mid-task."""


class OutOfMemoryError(WorkerCrashedError):
    """The memory monitor killed the task's worker; its message says
    "OOM-killed"."""


class ObjectLostError(RayTpuError):
    """An object's value was lost (``object_id_bytes``, when known, names
    it)."""

    def __init__(self, message: str = "",
                 object_id_bytes: Optional[bytes] = None):
        self.object_id_bytes = object_id_bytes
        super().__init__(message)

    def __reduce__(self):
        return (ObjectLostError, (self.args[0] if self.args else "",
                                  self.object_id_bytes))


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` ran out of time."""


class ObjectStoreFullError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    """A runtime env could not be set up."""


class PlacementGroupUnschedulableError(RayTpuError):
    pass

"""Collective communication among actors (counterpart of
``ray_tpu/collective/__init__.py``, the ``ray.util.collective`` shape).

The same API, names and group semantics as the JAX package: members call
``init_collective_group(world_size, rank, backend, group_name)``, which
blocks until every member has joined, then run ops by group name.  Ops take
numpy arrays (or tensors) and return numpy arrays, as JAX's do.

Backends (``backends.py``):

- ``"xla"``, ``"gloo"`` and ``"auto"``: a gloo ``torch.distributed`` process
  group over host arrays;
- ``"tpu"`` and ``"nccl"``: an NCCL process group over CUDA tensors, one
  card a member (NCCL refuses two ranks on one card);
- ``"kv"`` and ``"cpu"``: the pure-Python exchange through the store.

Every group rendezvouses through this process's ``_control.py`` store (an
actor's, or the main process's session store), so several groups live in one
process.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

from .backends import DistBackend, KVBackend

_lock = threading.Lock()
_groups: Dict[str, Any] = {}

SUM = "sum"
PROD = "prod"
MIN = "min"
MAX = "max"

#: JAX's backend names -> (backend class, torch.distributed backend).
_BACKENDS = {"xla": (DistBackend, "gloo"), "gloo": (DistBackend, "gloo"),
             "auto": (DistBackend, "gloo"), "tpu": (DistBackend, "nccl"),
             "nccl": (DistBackend, "nccl"), "kv": (KVBackend, None),
             "cpu": (KVBackend, None)}


def init_collective_group(world_size: int, rank: int,
                          backend: str = "xla",
                          group_name: str = "default") -> None:
    """Join a collective group; blocks until all members rendezvous."""
    with _lock:
        if group_name in _groups:
            raise ValueError(f"group {group_name!r} already initialized")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown collective backend {backend!r}")
    cls, dist_backend = _BACKENDS[backend]
    g = cls(world_size, rank, group_name) if dist_backend is None else \
        cls(world_size, rank, group_name, dist_backend)
    g.setup()
    with _lock:
        _groups[group_name] = g


def is_group_initialized(group_name: str = "default") -> bool:
    with _lock:
        return group_name in _groups


def destroy_collective_group(group_name: str = "default") -> None:
    with _lock:
        g = _groups.pop(group_name, None)
    if g is not None:
        g.teardown()


def _group(group_name: str):
    with _lock:
        g = _groups.get(group_name)
    if g is None:
        raise ValueError(f"collective group {group_name!r} not initialized; "
                         "call init_collective_group() first")
    return g


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size


def allreduce(tensor, group_name: str = "default", op: str = SUM):
    return _group(group_name).allreduce(tensor, op)


def allgather(tensor, group_name: str = "default"):
    return _group(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: str = SUM):
    return _group(group_name).reducescatter(tensor, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group(group_name).broadcast(tensor, src_rank)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = SUM):
    return _group(group_name).reduce(tensor, dst_rank, op)


def barrier(group_name: str = "default") -> None:
    _group(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    _group(group_name).send(tensor, dst_rank)


def recv(shape, dtype, src_rank: int, group_name: str = "default"):
    return _group(group_name).recv(shape, dtype, src_rank)


__all__ = [
    "init_collective_group", "destroy_collective_group",
    "is_group_initialized", "get_rank", "get_collective_group_size",
    "allreduce", "allgather", "reducescatter", "broadcast", "reduce",
    "barrier", "send", "recv", "SUM", "PROD", "MIN", "MAX",
]

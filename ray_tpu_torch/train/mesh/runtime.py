"""Worker and controller mesh runtime (counterpart of
ray_tpu/train/mesh/runtime.py).

Worker side: ``build_worker_mesh`` builds the global mesh of the worker's
``torch.distributed`` world and installs it as the ambient mesh;
``shard_tree``/``shard_batch_tree`` place trees onto it.  Controller side:
``publish_mesh_status`` records the live mesh shape on the control plane
under ``MESH_KV_KEY`` (``read_mesh_status`` reads it back).

Telemetry: ``ray_tpu_train_mesh_axis_size{axis}``,
``ray_tpu_train_param_shard_bytes`` (and, in ``reshape``,
``ray_tpu_train_mesh_reshapes_total``).  A rank of the port holds one
device, so this process's bytes and its device's bytes are the same number.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..._tree import tree_leaves, tree_map
from ...parallel.mesh import Mesh, MeshSpec, build_mesh, set_global_mesh
from ...parallel.sharding import ShardingRules, shard_pytree
from ...util import telemetry

#: Control-plane key of the live mesh shape (JAX's: outside ``train/``,
#: which a run consumes and deletes, so it outlives the run).
MESH_KV_KEY = "diagnostics/mesh/last"


def build_worker_mesh(spec: MeshSpec, device=None) -> Mesh:
    """The global mesh of this worker's world, installed as the ambient
    mesh; refreshes the axis-size gauges."""
    mesh = build_mesh(spec, device)
    set_global_mesh(mesh)
    note_mesh_axes(mesh.shape)
    return mesh


def note_mesh_axes(axes: Dict[str, int]) -> None:
    for axis, size in axes.items():
        telemetry.set_gauge("ray_tpu_train_mesh_axis_size", float(size),
                            tags={"axis": axis})


def _local_bytes(leaf) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return 0


def addressable_param_bytes(tree) -> int:
    """Bytes of ``tree`` this process holds: every leaf's local block."""
    return sum(_local_bytes(x) for x in tree_leaves(tree))


def per_device_param_bytes(tree) -> Dict[str, int]:
    """Bytes of ``tree`` resident on this process's device, keyed by
    "rank<r>:<device>" (JAX keys its devices by name; a rank of the port
    holds one)."""
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        return {}
    return {f"rank{rank}:{leaves[0].device}": addressable_param_bytes(tree)}


def note_param_shard_bytes(tree) -> int:
    n = addressable_param_bytes(tree)
    telemetry.set_gauge("ray_tpu_train_param_shard_bytes", float(n))
    return n


def publish_mesh_status(run_id: str, axes: Dict[str, int], world: int,
                        devices_per_worker: int) -> None:
    """Controller side: record the live mesh shape on the control plane
    (best effort: status display never fails a run)."""
    from .reshape import mesh_descriptor
    try:
        from ..._control import _control
        _control("kv_put", MESH_KV_KEY, json.dumps({
            "run_id": run_id,
            "descriptor": mesh_descriptor(axes),
            "axes": {a: int(s) for a, s in axes.items()},
            "world": int(world),
            "devices_per_worker": int(devices_per_worker),
            "time": time.time(),
        }).encode())
    except Exception as e:  # noqa: BLE001 - observability is best-effort
        telemetry.note_swallowed("train.mesh.publish_status", e)


def read_mesh_status() -> Optional[Dict[str, Any]]:
    """The last published mesh shape, or None."""
    try:
        from ..._control import _control
        raw = _control("kv_get", MESH_KV_KEY)
        return json.loads(raw) if raw else None
    except Exception as e:  # noqa: BLE001
        telemetry.note_swallowed("train.mesh.read_status", e)
        return None


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.array(x, copy=True))


def shard_tree(tree, logical_tree, mesh: Mesh,
               rules: Optional[ShardingRules] = None):
    """Place a tree of full host arrays onto ``mesh`` by logical axes:
    every rank passes the same full values and keeps its own blocks (a
    copy, never a view of the caller's array).  A None logical entry
    replicates its leaf.  Refreshes ``ray_tpu_train_param_shard_bytes``."""
    out = shard_pytree(tree_map(lambda x: _as_tensor(x).clone(), tree),
                       logical_tree, mesh, rules)
    note_param_shard_bytes(out)
    return out


def shard_batch_tree(batch, mesh: Mesh,
                     rules: Optional[ShardingRules] = None):
    """Place per-process batch leaves onto the mesh's data axes: each
    process contributes its LOCAL rows of the global batch (the leading
    dim over (dp, fsdp), rows in rank order)."""
    from ...parallel.spmd import batch_pspec
    placements = tuple(batch_pspec(mesh, rules))
    out = {}
    for k, v in batch.items():
        t = _as_tensor(v).to(mesh.device)
        if mesh.device_mesh is None:
            out[k] = t
            continue
        from torch.distributed.tensor import DTensor
        out[k] = DTensor.from_local(t, mesh.device_mesh, placements,
                                    run_check=False)
    return out


__all__ = ["MESH_KV_KEY", "build_worker_mesh", "note_mesh_axes",
           "addressable_param_bytes", "per_device_param_bytes",
           "note_param_shard_bytes", "publish_mesh_status",
           "read_mesh_status", "shard_tree", "shard_batch_tree"]

"""Worker mesh runtime: build the mesh and place trees onto it (counterpart
of ray_tpu/train/mesh/runtime.py: its placement helpers; the mesh-status
publishing and telemetry gauges come with the port of the core runtime and
``util/telemetry``).

A rank of the port holds one device, so this process's bytes and its
device's bytes are the same number.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..._tree import tree_leaves, tree_map
from ...parallel.mesh import Mesh, MeshSpec, build_mesh, set_global_mesh
from ...parallel.sharding import ShardingRules, shard_pytree


def build_worker_mesh(spec: MeshSpec, device=None) -> Mesh:
    """The global mesh of this worker's world, installed as the ambient
    mesh."""
    mesh = build_mesh(spec, device)
    set_global_mesh(mesh)
    return mesh


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


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.array(x, copy=True))


def shard_tree(tree, logical_tree, mesh: Mesh,
               rules: Optional[ShardingRules] = None):
    """Place a tree of full host arrays onto ``mesh`` by logical axes:
    every rank passes the same full values and keeps its own blocks (a
    copy, never a view of the caller's array).  A None logical entry
    replicates its leaf."""
    return shard_pytree(tree_map(lambda x: _as_tensor(x).clone(), tree),
                        logical_tree, mesh, rules)


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


__all__ = ["build_worker_mesh", "addressable_param_bytes",
           "per_device_param_bytes", "shard_tree", "shard_batch_tree"]

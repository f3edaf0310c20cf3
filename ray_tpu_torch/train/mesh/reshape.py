"""Mesh-reshape checkpoint restore (counterpart of
ray_tpu/train/mesh/reshape.py).

A sharded save needs no special casing: ``checkpoint.format.snapshot_tree``
writes every DTensor block with its GLOBAL index.  On restore, given the
TARGET mesh's layout, each rank computes the box its block covers
(``process_index``), reads only those byte ranges through the index algebra,
and wraps them as DTensors on the target mesh.  Saved and target mesh
shapes are independent: dp2 -> fsdp2 and fsdp4 -> dp2xfsdp2 both reduce to
index intersection, bit-exact.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ..._tree import tree_flatten_with_keys, tree_map_with_keys
from ...checkpoint import format as ckpt_format
from ...checkpoint import sharding as idx
from ...parallel.mesh import Mesh
from ...parallel.sharding import (NamedSharding, ShardingRules,
                                  default_rules, map_logical,
                                  named_sharding)
from ...util import telemetry

#: Axis print order for descriptors ("dp2xfsdp4"), outer to inner.
_DESC_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


def mesh_descriptor(mesh_or_axes) -> str:
    """Canonical short name of a mesh shape: axes > 1 in outer-to-inner
    order ("dp2xfsdp4"), "single" for an all-ones mesh."""
    axes = (mesh_or_axes if isinstance(mesh_or_axes, dict)
            else mesh_or_axes.shape)
    parts = [f"{a}{axes[a]}" for a in _DESC_ORDER
             if int(axes.get(a, 1)) > 1]
    parts += [f"{a}{s}" for a, s in axes.items()
              if a not in _DESC_ORDER and int(s) > 1]
    return "x".join(parts) if parts else "single"


def sharding_tree(logical_tree, mesh: Mesh,
                  rules: Optional[ShardingRules] = None):
    """Tree of logical-axis tuples -> tree of NamedShardings on ``mesh``
    (None leaves stay None: host-side scalars and objects)."""
    rules = rules or default_rules()
    return map_logical(
        lambda ax: None if ax is None else named_sharding(mesh, ax, rules),
        logical_tree)


def process_index(sharding: NamedSharding, global_shape
                  ) -> Optional[idx.Index]:
    """The slice of a global array this rank's device owns under
    ``sharding``: the restore placement, so a rank never reads byte
    ranges outside its block.  None for a scalar."""
    if not global_shape:
        return None
    return sharding.local_index(tuple(int(d) for d in global_shape))


def _is_sharding(x) -> bool:
    return x is None or isinstance(x, NamedSharding)


def _key_shardings(sharding_tree_) -> Dict[str, Any]:
    return dict(tree_flatten_with_keys(sharding_tree_,
                                       is_leaf=_is_sharding))


def placement_for(sharding_tree_) -> Callable:
    """checkpoint ``placement`` callable from a sharding tree: each leaf
    restores only this rank's box."""
    by_key = _key_shardings(sharding_tree_)

    def placement(key: str, global_shape) -> Optional[idx.Index]:
        sh = by_key.get(key)
        if sh is None or not global_shape:
            return None
        return process_index(sh, global_shape)
    return placement


def save_metrics(mesh: Mesh, metrics: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Stamp the saving mesh's shape into checkpoint metrics (the "mesh"
    key is reserved on mesh saves)."""
    out = dict(metrics or {})
    out["mesh"] = mesh_descriptor(mesh)
    return out


def restore_to_mesh(path: str, sharding_tree_, *,
                    loader: Optional[Callable] = None,
                    count_reshape: bool = True):
    """Restore a committed checkpoint onto a (possibly different) mesh.

    ``sharding_tree_``: tree of NamedShardings (None leaves restore as
    they were saved, on the CPU) matching the saved tree's structure.
    ``loader(path, placement)`` overrides the raw restore.
    ``count_reshape=False`` leaves ``ray_tpu_train_mesh_reshapes_total``
    alone (the trainer counts once a group, on rank 0).  Returns the tree
    with every sharded leaf a DTensor on the target mesh (on the one-device
    mesh, a tensor on its device)."""
    from torch.distributed.tensor import DTensor
    manifest = ckpt_format.read_manifest(path)
    by_key = _key_shardings(sharding_tree_)
    placement = placement_for(sharding_tree_)
    host = (loader or (lambda p, pl: ckpt_format.restore_tree(
        p, placement=pl)))(path, placement)
    shapes = manifest.get("leaves") or {}
    saved_desc = (manifest.get("metrics") or {}).get("mesh")
    target = next((sh.mesh for sh in by_key.values() if sh is not None),
                  None)
    if count_reshape and isinstance(saved_desc, str) and \
            target is not None and saved_desc != mesh_descriptor(target):
        telemetry.inc("ray_tpu_train_mesh_reshapes_total")

    def place(key, block):
        sh = by_key.get(key)
        if sh is None or key not in shapes:
            return block
        mesh = sh.mesh
        block = block.to(mesh.device)
        if mesh.device_mesh is None:
            return block
        gshape = tuple(int(d) for d in shapes[key]["global_shape"])
        stride = [1] * len(gshape)
        for d in range(len(gshape) - 2, -1, -1):
            stride[d] = stride[d + 1] * gshape[d + 1]
        return DTensor.from_local(block, mesh.device_mesh, sh.placements,
                                  run_check=False, shape=gshape,
                                  stride=tuple(stride))

    out = tree_map_with_keys(place, host)
    from .runtime import note_param_shard_bytes
    note_param_shard_bytes(out)
    return out

"""Mesh runtime of the train worker group (counterpart of
ray_tpu/train/mesh): ``MeshConfig`` (config.py), the worker mesh, placement
helpers, gauges and the controller's mesh-status record (runtime.py), and
the restore of a checkpoint onto another mesh shape (reshape.py)."""

from .config import MeshConfig
from .reshape import (mesh_descriptor, process_index, restore_to_mesh,
                      sharding_tree)
from .runtime import (MESH_KV_KEY, addressable_param_bytes,
                      build_worker_mesh, note_mesh_axes,
                      note_param_shard_bytes, publish_mesh_status,
                      read_mesh_status)

__all__ = [
    "MeshConfig", "build_worker_mesh", "mesh_descriptor",
    "sharding_tree", "process_index", "restore_to_mesh",
    "addressable_param_bytes", "note_param_shard_bytes",
    "note_mesh_axes", "publish_mesh_status", "read_mesh_status",
    "MESH_KV_KEY",
]

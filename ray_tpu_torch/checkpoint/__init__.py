"""Checkpoints (counterpart of ray_tpu/checkpoint): wire format v1, the
JAX package's own, its index algebra, async sharded saves with an atomic
manifest commit, and the legacy single-pickle layout."""

from .async_writer import AsyncCheckpointWriter, WriteJob, publish_shard
from .format import (CheckpointError, is_committed, load_pytree,
                     read_manifest, restore_tree, save, save_pytree,
                     snapshot_tree, verify_checkpoint)
from .manager import (Checkpoint, CheckpointManager, WorkerCheckpointClient,
                      atomic_rmtree, scan_run_dir, step_dir)

__all__ = ["AsyncCheckpointWriter", "WriteJob", "publish_shard",
           "CheckpointError", "is_committed", "load_pytree",
           "read_manifest", "restore_tree", "save", "save_pytree",
           "snapshot_tree", "verify_checkpoint", "Checkpoint",
           "CheckpointManager", "WorkerCheckpointClient", "atomic_rmtree",
           "scan_run_dir", "step_dir"]

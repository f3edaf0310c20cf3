"""Checkpoints (counterpart of ray_tpu/checkpoint): wire format v1, the
JAX package's own, and its index algebra."""

from .format import (CheckpointError, is_committed, read_manifest,
                     restore_tree, save, verify_checkpoint)

__all__ = ["CheckpointError", "is_committed", "read_manifest",
           "restore_tree", "save", "verify_checkpoint"]

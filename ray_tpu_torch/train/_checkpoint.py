"""Thin compat shim over ``ray_tpu_torch.checkpoint`` (a copy of
ray_tpu/train/_checkpoint.py).

The checkpoint implementation lives in the ``checkpoint`` subsystem
(async sharded saves, atomic manifest commit, resharding restore).  This
module keeps the historical import surface — ``Checkpoint``,
``CheckpointManager``, ``save_pytree``, ``load_pytree`` — stable for
train code written against it.
"""

from __future__ import annotations

from ..checkpoint.format import load_pytree, save_pytree
from ..checkpoint.manager import Checkpoint, CheckpointManager

__all__ = ["Checkpoint", "CheckpointManager", "save_pytree", "load_pytree"]

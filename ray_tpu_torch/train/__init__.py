"""Training orchestration of the port (counterpart of ray_tpu/train):
``TorchTrainer`` (JAX: ``JaxTrainer``) over spawned worker processes, the
per-worker context and report API, async sharded checkpoints committed by
the controller, failure restarts, the watchdog, and the mesh runtime
(``train.mesh``)."""

from ..checkpoint.format import load_pytree, save_pytree
from ..checkpoint.manager import Checkpoint, CheckpointManager
from ..profiler.attribution import fence, step_phase
from ._context import (TrainContext, get_context, get_mesh, load_checkpoint,
                       load_sharded, report, save_checkpoint, shard,
                       shard_batch)
from .controller import CrashLoopError
from .mesh.config import MeshConfig
from .trainer import (CheckpointConfig, FailureConfig, Result, RunConfig,
                      ScalingConfig, TorchTrainer)
from .watchdog import TrainWatchdog, WatchdogConfig

__all__ = [
    "TorchTrainer", "ScalingConfig", "RunConfig", "FailureConfig",
    "CheckpointConfig", "Result", "Checkpoint", "CheckpointManager",
    "get_context", "report", "TrainContext", "save_pytree", "load_pytree",
    "save_checkpoint", "load_checkpoint", "CrashLoopError",
    "WatchdogConfig", "TrainWatchdog", "step_phase", "fence",
    "MeshConfig", "get_mesh", "shard", "shard_batch", "load_sharded",
]

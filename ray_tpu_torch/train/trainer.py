"""TorchTrainer: the user-facing Train API (counterpart of
ray_tpu/train/trainer.py, whose ``JaxTrainer`` it stands beside).

    result = TorchTrainer(train_fn, train_loop_config={...},
                          scaling_config=ScalingConfig(num_workers=4),
                          run_config=RunConfig(name="run", storage_path=p)
                          ).fit()

``train_fn`` must be a module-level function: the spawned workers import
it by reference (no cloudpickle on the card machine).  ``ScalingConfig(
device=None)`` books a card for each worker through the scheduler (worker r
takes the card it is granted) and builds the kernels once before spawning;
``device="cpu"`` runs gloo CPU workers.  ``resources_per_worker`` and
elastic ``min_workers``/``max_workers`` book through the scheduler too.
Options the port does not support yet raise ``NotImplementedError`` naming
their ROADMAP entry.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..checkpoint.manager import EMERGENCY_REPLICA_TODO, Checkpoint
from .controller import TrainController, todo
from .mesh.config import MeshConfig
from .watchdog import WatchdogConfig


@dataclass
class FailureConfig:
    """``max_failures`` is a lifetime budget by default; ``failure_window_s``
    turns it into a rolling-window budget.  Restarts back off exponentially
    (bounded), and the crash-loop breaker fails fast, with a diagnosis
    bundle, when the same error signature recurs immediately
    ``crash_loop_threshold`` times in a row."""
    max_failures: int = 0
    failure_window_s: Optional[float] = None
    restart_backoff_initial_s: float = 1.0
    restart_backoff_max_s: float = 30.0
    restart_backoff_factor: float = 2.0
    restart_backoff_reset_s: float = 60.0
    crash_loop_threshold: int = 0
    crash_loop_window_s: float = 60.0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    # Async saves block the step only for the host snapshot; the bounded
    # write queue applies backpressure past ``max_inflight`` saves.
    async_save: bool = True
    max_inflight: int = 2
    # Not ported (raises at fit()): peer-RAM replicas of the newest shards.
    emergency_replica: bool = False


@dataclass
class ScalingConfig:
    """JAX's fields, plus ``device``: None puts worker r on card r, "cpu"
    runs CPU workers over gloo."""
    num_workers: int = 1
    use_tpu: bool = False
    chips_per_worker: int = 0
    topology: Optional[str] = None
    num_slices: int = 1
    resources_per_worker: Optional[Dict[str, float]] = None
    env_per_worker: Optional[Dict[str, str]] = None
    # Form a process group even for num_workers == 1.
    force_distributed: bool = False
    mesh_config: Optional[MeshConfig] = None
    # Elastic: size each group to what fits in [min_workers, max_workers],
    # and upsize between checks at a checkpoint boundary.
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None
    elastic_check_interval_s: float = 5.0
    # How long spawning and forming the group may take before the
    # formation counts as a failure.
    formation_timeout_s: float = 300.0
    device: Optional[str] = None

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None or self.max_workers is not None


@dataclass
class RunConfig:
    name: str = "ray_tpu_experiment"
    storage_path: str = ""
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)

    def __post_init__(self):
        if not self.storage_path:
            self.storage_path = os.path.join(
                tempfile.gettempdir(), "ray_tpu_results")


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    error: Optional[Exception] = None
    all_reports: List[Dict[str, Any]] = field(default_factory=list)
    num_failures: int = 0
    # Drain notices are not ported: always 0.
    num_drains: int = 0
    world_size_history: List[int] = field(default_factory=list)
    # {goodput_ratio, total_s, productive_s, phases_s}.
    goodput: Optional[Dict[str, Any]] = None
    # Rank 0's step phases summed over the run: {"seconds", "fraction"}.
    step_phases: Optional[Dict[str, Any]] = None
    mesh: Optional[Dict[str, int]] = None
    #: Seconds from spawning each incarnation to its formed group.
    formation_seconds: List[float] = field(default_factory=list)


def _refuse_unsupported(scaling: ScalingConfig, run: RunConfig) -> None:
    if scaling.num_slices > 1:
        raise NotImplementedError(
            f"num_slices > 1 is {todo('multi-slice')}")
    if scaling.use_tpu or scaling.topology or scaling.chips_per_worker:
        raise NotImplementedError(
            "use_tpu, topology and chips_per_worker have no port (a worker "
            f"holds one card): {todo('TPU scaling fields')}")
    if run.checkpoint_config.emergency_replica:
        raise NotImplementedError(EMERGENCY_REPLICA_TODO)
    if scaling.device not in (None, "cpu"):
        raise ValueError(f"ScalingConfig.device must be None (the cards) or "
                         f"'cpu', not {scaling.device!r}")


def _check_by_reference(fn: Callable, config: Any) -> None:
    """The train fn and its config travel to spawned processes by pickle,
    the fn by reference."""
    qualname = getattr(fn, "__qualname__", "")
    if "<locals>" in qualname or "<lambda>" in qualname:
        raise ValueError(
            f"train_loop_per_worker {qualname!r} is not a module-level "
            "function: TorchTrainer's workers import the train fn by "
            "reference, so define it at the top level of a module")
    try:
        pickle.dumps((fn, config))
    except Exception as e:  # noqa: BLE001 - re-raised with the rule
        raise ValueError(
            "train_loop_per_worker and train_loop_config must pickle (the "
            "fn by reference, as a module-level function): " + repr(e)
        ) from e


class TorchTrainer:
    """Data-parallel (or mesh-parallel) trainer over a group of spawned
    worker processes (JAX: ``JaxTrainer``).

    ``train_loop_per_worker`` runs once per worker with the group's process
    group formed; inside it, use ``ray_tpu_torch.train.get_context()``,
    ``report(...)`` and ``save_checkpoint(...)``."""

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._train_fn = train_loop_per_worker
        self._config = train_loop_config
        self._scaling = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()

    def fit(self) -> Result:
        from ..util import telemetry
        scaling = self._scaling
        _refuse_unsupported(scaling, self._run_config)
        _check_by_reference(self._train_fn, self._config)
        if scaling.device != "cpu":
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchTrainer runs its workers on the cards and no CUDA "
                    "device is visible; pass ScalingConfig(device='cpu') "
                    "for CPU workers")
            if torch.cuda.device_count() < scaling.num_workers:
                raise RuntimeError(
                    f"{scaling.num_workers} workers need as many cards; "
                    f"{torch.cuda.device_count()} visible")
            # Once here, not in N workers running nvcc at once.
            from ..ops import _build
            _build.build()
        controller = TrainController(
            self._train_fn, self._config, scaling, self._run_config)
        with telemetry.profile_span(
                "train_fit", "train",
                extra={"experiment": self._run_config.name,
                       "num_workers": scaling.num_workers}):
            return controller.run()

"""Algorithm + AlgorithmConfig: the RL training loop and its config.

A copy of ``ray_tpu/rl/algorithm.py`` with two changes for the port: the
config carries a ``device`` (``.resources(device=...)``; None is the card),
which every algorithm builds its modules, learners and runners on; and
``save``/``restore`` write and read numpy trees, so a checkpoint holds no
tensors and the JAX package reads it as its own (and the port reads the
JAX package's, whose arrays ``np.asarray`` takes).

Reference: rllib/algorithms/algorithm.py:208 (Algorithm is a Trainable with
``step:1169`` orchestrating ``training_step:2420``) and
algorithm_config.py (fluent AlgorithmConfig: .environment(),
.env_runners(), .training(), .learners(), .build_algo()).
"""

from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Any, Callable, Dict, Optional, Type

from .._device import resolve_device
from ._transfer import to_numpy
from .env import make_env
from .env_runner import EnvRunnerGroup
from .rl_module import RLModuleSpec


class AlgorithmConfig:
    """Algorithm hyperparameters, set fluently (an API like the
    reference: config.environment("CartPole-v1").training(lr=1e-3))."""

    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        self.env_spec: Any = None
        self.num_env_runners = 0
        self.num_envs_per_runner = 4
        self.rollout_fragment_length = 128
        # Factory returning a list of env-to-module connectors (reference:
        # AlgorithmConfig.env_runners(env_to_module_connector=...)); a
        # factory (not an instance) so every runner gets its own state.
        self.env_to_module_fn: Optional[Callable] = None
        self.num_learners = 0
        self.lr = 3e-4
        self.gamma = 0.99
        self.train_batch_size = 512
        self.seed = 0
        self.module_hidden = (64, 64)
        # Custom module factory (see rl_module(module_factory=...)).
        self.module_factory: Optional[Callable] = None
        self.device: Any = None
        self.extra: Dict[str, Any] = {}

    # -- fluent setters --------------------------------------------------- #

    def environment(self, env: Any) -> "AlgorithmConfig":
        self.env_spec = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    env_to_module_connector: Optional[Callable] = None
                    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if env_to_module_connector is not None:
            self.env_to_module_fn = env_to_module_connector
        return self

    def build_env_to_module(self):
        """Instantiate the connector pipeline (fresh state per runner)."""
        if self.env_to_module_fn is None:
            return None
        from .connectors import ConnectorPipeline
        made = self.env_to_module_fn()
        if isinstance(made, ConnectorPipeline):
            return made
        return ConnectorPipeline(list(made) if isinstance(made, (list, tuple))
                                 else [made])

    def learners(self, *, num_learners: Optional[int] = None
                 ) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 train_batch_size: Optional[int] = None,
                 **extra: Any) -> "AlgorithmConfig":
        if lr is not None:
            self.lr = lr
        if gamma is not None:
            self.gamma = gamma
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        self.extra.update(extra)
        return self

    def rl_module(self, *, hidden=None,
                  module_factory=None) -> "AlgorithmConfig":
        """``module_factory``: zero-arg callable returning a custom
        module (models.CNNPolicyModule / GRUPolicyModule, or anything
        with the module dict surface).  Env runners AND learners build
        from it, so recurrent modules train end-to-end (reference:
        rl_module(rl_module_spec=...) custom RLModule classes)."""
        if hidden is not None:
            self.module_hidden = tuple(hidden)
        if module_factory is not None:
            self.module_factory = module_factory
        return self

    def resources(self, *, device: Any = None) -> "AlgorithmConfig":
        """The device the algorithm runs its modules on (None: the
        card)."""
        self.device = device
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    # -- build ------------------------------------------------------------ #

    def module_spec(self) -> RLModuleSpec:
        probe = make_env(self.env_spec)
        obs_dim = probe.observation_dim
        if self.env_to_module_fn is not None:
            obs_dim *= self.build_env_to_module().output_dim_factor
        return RLModuleSpec(obs_dim, probe.num_actions,
                            tuple(self.module_hidden))

    def build_algo(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use PPOConfig() etc.")
        return self.algo_class(self)

    # legacy alias (reference keeps .build around)
    build = build_algo


class Algorithm:
    """Iterative trainer; subclass implements ``training_step``."""

    # Off-policy algorithms that drive their own env loop (DQN) set this
    # False to skip building the policy-rollout EnvRunnerGroup.
    _use_env_runner_group = True

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.iteration = 0
        self._start = time.monotonic()  # duration base: NTP-immune
        self.env_runner_group: Optional[EnvRunnerGroup] = None
        if self._use_env_runner_group:
            self.env_runner_group = EnvRunnerGroup(
                lambda: make_env(config.env_spec),
                num_env_runners=config.num_env_runners,
                num_envs_per_runner=config.num_envs_per_runner,
                module_spec=config.module_spec(), seed=config.seed,
                env_to_module_fn=config.env_to_module_fn
                and config.build_env_to_module,
                module_fn=config.module_factory, device=self.device)
        self.setup(config)

    # -- subclass hooks ---------------------------------------------------- #

    def setup(self, config: AlgorithmConfig) -> None:
        pass

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- public API --------------------------------------------------------- #

    def train(self) -> Dict[str, Any]:
        """One iteration (reference: Algorithm.step:1169)."""
        t0 = time.monotonic()
        results = self.training_step()
        self.iteration += 1
        if self.env_runner_group is not None:
            results.setdefault("env_runners",
                               self.env_runner_group.aggregate_metrics())
        results["training_iteration"] = self.iteration
        results["time_this_iter_s"] = time.monotonic() - t0
        results["time_total_s"] = time.monotonic() - self._start
        return results

    def get_weights(self):
        raise NotImplementedError

    def set_weights(self, params) -> None:
        raise NotImplementedError

    def save(self, checkpoint_dir: str) -> str:
        """Reference: Checkpointable.save_to_path (rllib/utils/checkpoints)."""
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump({"weights": to_numpy(self.get_weights()),
                         "iteration": self.iteration}, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "rb") as f:
            state = pickle.load(f)
        # A JAX package checkpoint holds JAX arrays: numpy them first.
        self.set_weights(to_numpy(state["weights"]))
        self.iteration = state["iteration"]
        if self.env_runner_group is not None:
            self.env_runner_group.sync_weights(self.get_weights())

    def stop(self) -> None:
        if self.env_runner_group is not None:
            self.env_runner_group.stop()

"""DQN: off-policy Q-learning with replay and target network.

Counterpart of ``ray_tpu/rl/dqn.py`` (double-Q targets; prioritized replay
optional).  The TD targets are computed on the device and stay there: the
learner reads them as they are (``dqn.py:145,178`` fetched them to the
host first), so an update makes one host sync, the metrics'; prioritized
replay adds one, the TD errors its priorities need.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ._transfer import fetch, to_device
from .algorithm import Algorithm, AlgorithmConfig
from .env import make_env
from .learner import TorchLearner
from .replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from .rl_module import QModule, take


def dqn_loss(module: QModule, params, batch):
    q_taken = take(module.q_values(params, batch["obs"]), batch["actions"])
    td_error = q_taken - batch["targets"]
    weights = batch.get("weights")
    if weights is None:
        weights = torch.ones_like(td_error)
    loss = torch.mean(weights * td_error ** 2)
    return loss, {"td_error_mean": torch.mean(torch.abs(td_error)),
                  "q_mean": torch.mean(q_taken)}


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(DQN)
        self.buffer_size = 50_000
        self.prioritized_replay = False
        self.learning_starts = 500
        self.target_update_freq = 500  # in sampled env steps
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 5_000
        self.double_q = True
        self.train_batch_size = 64
        self.updates_per_step = 1

    def training(self, *, buffer_size=None, prioritized_replay=None,
                 learning_starts=None, target_update_freq=None,
                 epsilon_decay_steps=None, double_q=None,
                 updates_per_step=None, **kw) -> "DQNConfig":
        super().training(**kw)
        if buffer_size is not None:
            self.buffer_size = buffer_size
        if prioritized_replay is not None:
            self.prioritized_replay = prioritized_replay
        if learning_starts is not None:
            self.learning_starts = learning_starts
        if target_update_freq is not None:
            self.target_update_freq = target_update_freq
        if epsilon_decay_steps is not None:
            self.epsilon_decay_steps = epsilon_decay_steps
        if double_q is not None:
            self.double_q = double_q
        if updates_per_step is not None:
            self.updates_per_step = updates_per_step
        return self


class DQN(Algorithm):
    """Single-process sampler (epsilon-greedy needs per-step control, so DQN
    drives its own env loop instead of the policy-rollout EnvRunnerGroup)."""

    _use_env_runner_group = False

    def setup(self, config: DQNConfig) -> None:
        spec = config.module_spec()
        self.module = QModule(spec)
        self.learner = TorchLearner(self.module, dqn_loss,
                                    learning_rate=config.lr,
                                    seed=config.seed, device=self.device)
        self.target_params = self.learner.params
        if config.prioritized_replay:
            self.buffer: ReplayBuffer = PrioritizedReplayBuffer(
                config.buffer_size, seed=config.seed)
        else:
            self.buffer = ReplayBuffer(config.buffer_size, seed=config.seed)
        self.env = make_env(config.env_spec)
        self._obs, _ = self.env.reset(seed=config.seed)
        self._steps = 0
        self._rng = np.random.default_rng(config.seed)
        self._ep_return = 0.0
        self._returns: list = []

    # -- behavior policy --------------------------------------------------- #

    def _epsilon(self) -> float:
        cfg: DQNConfig = self.config
        frac = min(1.0, self._steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    @torch.no_grad()
    def _act(self, obs: np.ndarray) -> int:
        if self._rng.random() < self._epsilon():
            return int(self._rng.integers(self.env.num_actions))
        return int(fetch(self.module.forward_inference(
            self.learner.params, to_device(obs[None], self.device)))[0, 0])

    # -- training ----------------------------------------------------------- #

    @torch.no_grad()
    def _targets(self, batch: Dict[str, Any]) -> torch.Tensor:
        """r + gamma (1 - term) Q_target(s', argmax_a Q(s', a)), on the
        device (double-Q: the argmax by the online net)."""
        b = to_device({k: batch[k] for k in
                       ("next_obs", "rewards", "terminateds")}, self.device)
        q_next_target = self.module.q_values(self.target_params,
                                             b["next_obs"])
        chooser = self.module.q_values(self.learner.params, b["next_obs"]) \
            if self.config.double_q else q_next_target
        next_q = take(q_next_target, torch.argmax(chooser, dim=-1))
        return (b["rewards"] + self.config.gamma * (1.0 - b["terminateds"])
                * next_q).to(torch.float32)

    def _update(self, batch: Dict[str, Any], idx=None) -> Dict[str, float]:
        """Targets and one learner update on a replay batch; with the
        sampled rows' ``idx`` (prioritized replay) their new TD errors
        become their priorities."""
        batch["targets"] = self._targets(batch)
        metrics = self.learner.update(batch)
        if idx is not None:
            with torch.no_grad():
                b = to_device({k: batch[k] for k in ("obs", "actions")},
                              self.device)
                td = take(self.module.q_values(self.learner.params,
                                               b["obs"]), b["actions"]) \
                    - batch["targets"]
            self.buffer.update_priorities(idx, fetch(td)[0])
        return metrics

    def training_step(self) -> Dict[str, Any]:
        cfg: DQNConfig = self.config
        metrics: Dict[str, float] = {}
        for _ in range(cfg.rollout_fragment_length):
            action = self._act(self._obs)
            next_obs, r, term, trunc, _ = self.env.step(action)
            self.buffer.add(
                obs=self._obs[None], actions=np.array([action], np.int32),
                rewards=np.array([r], np.float32), next_obs=next_obs[None],
                terminateds=np.array([float(term)], np.float32))
            self._ep_return += r
            self._steps += 1
            if term or trunc:
                self._returns.append(self._ep_return)
                self._ep_return = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = next_obs
            if (self._steps >= cfg.learning_starts
                    and self._steps % cfg.updates_per_step == 0):
                if cfg.prioritized_replay:
                    batch, idx, w = self.buffer.sample(cfg.train_batch_size)
                    batch["weights"] = w
                else:
                    batch, idx = self.buffer.sample(cfg.train_batch_size), None
                metrics = self._update(batch, idx)
            if self._steps % cfg.target_update_freq == 0:
                self.target_params = self.learner.params
        recent = self._returns[-100:]
        return {
            "learner": metrics,
            "epsilon": self._epsilon(),
            "num_env_steps_sampled": self._steps,
            "buffer_size": len(self.buffer),
            "env_runners": {
                "episode_return_mean":
                    float(np.mean(recent)) if recent else float("nan"),
                "num_episodes": len(self._returns),
            },
        }

    def get_weights(self):
        return self.learner.params

    def set_weights(self, params) -> None:
        self.learner.set_weights(params)
        self.target_params = self.learner.params

    def stop(self) -> None:
        super().stop()

"""Multi-agent RL: MultiAgentEnv + runner + independent-PPO training.

Counterpart of ``ray_tpu/rl/multi_agent.py``: dict-keyed obs / action /
reward per agent with ``"__all__"`` termination, a policy mapping, and
independent PPO per policy, each policy a ``TorchLearner`` updated on the
transitions of the agents mapped to it.  Each policy's batched forward
comes back to the host in one transfer.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, make_generator, resolve_device
from ._transfer import fetch, to_device
from .algorithm import Algorithm, AlgorithmConfig
from .learner import TorchLearner
from .ppo import compute_gae, minibatch_epochs, ppo_consts, ppo_loss
from .rl_module import DiscretePolicyModule, RLModuleSpec


class MultiAgentEnv:
    """Dict-keyed multi-agent episodic env (reference:
    rllib/env/multi_agent_env.py).

    ``reset -> (obs_dict, info)``; ``step(action_dict) -> (obs_dict,
    reward_dict, terminated_dict, truncated_dict, info)``.  Termination
    dicts carry per-agent flags plus ``"__all__"`` for episode end.  Only
    agents present in ``obs_dict`` act next step.
    """

    agent_ids: Tuple[str, ...]
    observation_dim: int
    num_actions: int

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, int]):
        raise NotImplementedError


class MultiGuess(MultiAgentEnv):
    """Two-agent one-step env for learning tests: each agent sees its own
    one-hot context and is rewarded for matching it.  Agents are fully
    independent, so independent learning reaches mean reward 1.0 each."""

    agent_ids = ("a0", "a1")
    observation_dim = 4
    num_actions = 4

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._ctx: Dict[str, int] = {}

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        obs = {}
        for aid in self.agent_ids:
            c = int(self._rng.integers(self.num_actions))
            self._ctx[aid] = c
            o = np.zeros(self.observation_dim, np.float32)
            o[c] = 1.0
            obs[aid] = o
        return obs, {}

    def step(self, action_dict: Dict[str, int]):
        rewards = {aid: 1.0 if int(a) == self._ctx[aid] else 0.0
                   for aid, a in action_dict.items()}
        zeros = {aid: np.zeros(self.observation_dim, np.float32)
                 for aid in action_dict}
        term = {aid: True for aid in action_dict}
        term["__all__"] = True
        trunc = {aid: False for aid in action_dict}
        trunc["__all__"] = False
        return zeros, rewards, term, trunc, {}


class MultiAgentEnvRunner:
    """Steps one MultiAgentEnv, bucketing transitions per policy via the
    mapping fn (reference: rllib/env/multi_agent_env_runner.py)."""

    def __init__(self, env_creator: Callable[[], MultiAgentEnv],
                 policies: Dict[str, RLModuleSpec],
                 policy_mapping_fn: Callable[[str], str],
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.env = env_creator()
        self.policies = policies
        self.mapping = policy_mapping_fn
        self.modules = {pid: DiscretePolicyModule(spec)
                        for pid, spec in policies.items()}
        self.params = {pid: m.init(make_generator(self.device, seed + i))
                       for i, (pid, m) in enumerate(self.modules.items())}
        self._gen = make_generator(self.device, seed + 999)
        self._obs, _ = self.env.reset(seed=seed)
        self._ep_return = 0.0
        self._returns: List[float] = []

    def set_params(self, params: Dict[str, Any]) -> None:
        self.params.update(to_device(params, self.device))

    @torch.no_grad()
    def sample(self, num_steps: int) -> Dict[str, Dict[str, np.ndarray]]:
        """Collect ``num_steps`` env steps; returns per-policy column
        batches with per-transition dones (episode boundaries)."""
        buf: Dict[str, Dict[str, List]] = {
            pid: {k: [] for k in ("obs", "actions", "logp", "values",
                                  "rewards", "dones", "terminateds")}
            for pid in self.policies}
        for _ in range(num_steps):
            # Group live agents by policy for batched forward passes.
            by_policy: Dict[str, List[str]] = {}
            for aid in self._obs:
                by_policy.setdefault(self.mapping(aid), []).append(aid)
            actions: Dict[str, int] = {}
            step_meta: Dict[str, Tuple[str, float, float]] = {}
            for pid, aids in by_policy.items():
                obs_batch = np.stack([self._obs[a] for a in aids])
                # ONE transfer per policy forward, not three.
                acts, logp, vals = fetch(
                    *self.modules[pid].forward_exploration(
                        self.params[pid], to_device(obs_batch, self.device),
                        self._gen))
                for i, aid in enumerate(aids):
                    actions[aid] = int(acts[i])
                    step_meta[aid] = (pid, float(logp[i]), float(vals[i]))
            prev_obs = self._obs
            next_obs, rewards, term, trunc, _ = self.env.step(actions)
            done_all = term.get("__all__", False) or \
                trunc.get("__all__", False)
            for aid, act in actions.items():
                pid, logp, val = step_meta[aid]
                b = buf[pid]
                b["obs"].append(prev_obs[aid])
                b["actions"].append(act)
                b["logp"].append(logp)
                b["values"].append(val)
                b["rewards"].append(rewards.get(aid, 0.0))
                a_done = term.get(aid, False) or trunc.get(aid, False) \
                    or done_all
                b["dones"].append(a_done)
                b["terminateds"].append(term.get(aid, False))
                self._ep_return += rewards.get(aid, 0.0)
            if done_all:
                self._returns.append(self._ep_return)
                self._ep_return = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = next_obs
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for pid, b in buf.items():
            if not b["obs"]:
                continue
            out[pid] = {
                "obs": np.asarray(b["obs"], np.float32),
                "actions": np.asarray(b["actions"], np.int32),
                "logp": np.asarray(b["logp"], np.float32),
                "values": np.asarray(b["values"], np.float32),
                "rewards": np.asarray(b["rewards"], np.float32),
                "dones": np.asarray(b["dones"], bool),
                "terminateds": np.asarray(b["terminateds"], bool),
            }
        return out

    def metrics(self) -> Dict[str, float]:
        recent = self._returns[-100:]
        return {
            "episode_return_mean":
                float(np.mean(recent)) if recent else float("nan"),
            "num_episodes": len(self._returns),
        }


class MultiAgentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(MultiAgentPPO)
        self.policies: Optional[Dict[str, Any]] = None
        self.policy_mapping_fn: Callable[[str], str] = lambda aid: "default"
        self.clip_param = 0.2
        self.lambda_ = 0.95
        self.num_epochs = 4
        self.minibatch_size = 128
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01

    def multi_agent(self, *, policies=None, policy_mapping_fn=None
                    ) -> "MultiAgentPPOConfig":
        """reference: AlgorithmConfig.multi_agent(policies=...,
        policy_mapping_fn=...)."""
        if policies is not None:
            self.policies = policies
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self


class MultiAgentPPO(Algorithm):
    """Independent PPO per policy (reference: rllib multi-agent PPO with
    the default independent-learning setup)."""

    _use_env_runner_group = False

    def setup(self, config: MultiAgentPPOConfig) -> None:
        probe = config.env_spec() if callable(config.env_spec) \
            else config.env_spec
        if not isinstance(probe, MultiAgentEnv):
            raise ValueError("MultiAgentPPO needs a MultiAgentEnv (or a "
                             "creator returning one)")
        spec = RLModuleSpec(probe.observation_dim, probe.num_actions,
                            tuple(config.module_hidden))
        if config.policies is None:
            pids = sorted({config.policy_mapping_fn(a)
                           for a in probe.agent_ids})
            config.policies = {pid: spec for pid in pids}
        policies = {pid: (s if isinstance(s, RLModuleSpec) else spec)
                    for pid, s in config.policies.items()}
        creator = (config.env_spec if callable(config.env_spec)
                   else lambda: config.env_spec)
        self.runner = MultiAgentEnvRunner(
            creator, policies, config.policy_mapping_fn, seed=config.seed,
            device=self.device)
        self.learners = {
            pid: TorchLearner(self.runner.modules[pid], ppo_loss,
                              learning_rate=config.lr, seed=config.seed + i,
                              device=self.device)
            for i, pid in enumerate(policies)}
        # Runner starts from learner weights so old-logp matches.
        self.runner.set_params({pid: ln.params
                                for pid, ln in self.learners.items()})
        self._rng = np.random.default_rng(config.seed)

    def _update_policy(self, pid: str, rollout: Dict[str, np.ndarray]
                       ) -> Dict[str, float]:
        cfg: MultiAgentPPOConfig = self.config
        # Single-stream GAE: [T, 1] time-major view of the flat stream.
        T = len(rollout["rewards"])
        adv, ret = compute_gae(
            rollout["rewards"][:, None], rollout["values"][:, None],
            rollout["dones"][:, None], rollout["terminateds"][:, None],
            np.zeros(1, np.float32), cfg.gamma, cfg.lambda_)
        a = adv[:, 0]
        batch = {
            "obs": rollout["obs"],
            "actions": rollout["actions"],
            "logp_old": rollout["logp"],
            "advantages": ((a - a.mean()) / (a.std() + 1e-8)
                           ).astype(np.float32),
            "value_targets": ret[:, 0].astype(np.float32),
        }
        return minibatch_epochs(
            self.learners[pid].update, batch, ppo_consts(cfg), self._rng,
            cfg.num_epochs, min(cfg.minibatch_size, T), self.device)

    def training_step(self) -> Dict[str, Any]:
        cfg: MultiAgentPPOConfig = self.config
        per_policy = self.runner.sample(cfg.rollout_fragment_length)
        metrics: Dict[str, Any] = {}
        for pid, rollout in per_policy.items():
            m = self._update_policy(pid, rollout)
            if m:
                metrics[pid] = m
        self.runner.set_params({pid: ln.params
                                for pid, ln in self.learners.items()})
        return {"learner": metrics,
                "env_runners": self.runner.metrics()}

    def get_weights(self):
        return {pid: ln.params for pid, ln in self.learners.items()}

    def set_weights(self, params) -> None:
        for pid, p in params.items():
            self.learners[pid].set_weights(p)
        self.runner.set_params(dict(params))

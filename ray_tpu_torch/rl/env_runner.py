"""Rollout layer: EnvRunner (vector env + module inference) and
EnvRunnerGroup.

Counterpart of ``ray_tpu/rl/env_runner.py``.  The module runs on the
runner's ``device`` (None: the card); the envs are numpy on the host.  Each
env step makes one host sync: the observations go up through pinned memory
without a wait, and the step's actions, log-probs and values come back in
ONE transfer (``env_runner.py:148-171``; the JAX package's RT502 fix).
Episode truncations add one read of V(final_obs), and a sample one read of
the bootstrap values at its end.

``EnvRunnerGroup`` keeps one local runner (``num_env_runners=0``); remote
runners raise ``NotImplementedError`` (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .._device import DeviceLike, make_generator, resolve_device
from ._transfer import fetch, to_device
from .env import VectorEnv
from .learner import PROCESS_TIER
from .rl_module import DiscretePolicyModule, RLModuleSpec, categorical, take


class EnvRunner:
    """Collects fixed-length rollout batches with the current policy."""

    def __init__(self, env_creator: Callable, *, num_envs: int = 4,
                 module_spec: Optional[RLModuleSpec] = None,
                 seed: int = 0, explore: bool = True,
                 env_to_module=None, module=None,
                 reward_connector=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.vec = VectorEnv(env_creator, num_envs, seed=seed)
        # Reward-path connector (reference: rllib clip_rewards): applied
        # to the per-step reward vector before it enters the batch.
        self.reward_connector = reward_connector
        # Env-to-module connector pipeline (reference: rllib ConnectorV2):
        # observations pass through it before every forward; its state
        # syncs with the weights via get_state/set_state.
        from .connectors import Connector, ConnectorPipeline
        if env_to_module is not None and \
                not isinstance(env_to_module, ConnectorPipeline):
            env_to_module = ConnectorPipeline(
                [env_to_module] if isinstance(env_to_module, Connector)
                else list(env_to_module))
        self.env_to_module = env_to_module
        obs_dim = self.vec.observation_dim
        if env_to_module is not None:
            obs_dim *= env_to_module.output_dim_factor
        self.spec = module_spec or RLModuleSpec(
            obs_dim, self.vec.num_actions)
        # Custom module hook (e.g. models.CNNPolicyModule): anything with
        # the init/forward_train-dict/forward_exploration surface.
        self.module = module if module is not None \
            else DiscretePolicyModule(self.spec)
        self.explore = explore
        self._gen = make_generator(self.device, seed)
        self.params = self.module.init(make_generator(self.device, seed + 1))
        self._obs = self._connect(self.vec.reset())
        # Episode-return bookkeeping for metrics.
        self._ep_returns = np.zeros(num_envs, np.float64)
        self._ep_lens = np.zeros(num_envs, np.int64)
        self._finished_returns: List[float] = []
        self._finished_lens: List[int] = []
        # Recurrent modules (models.GRUPolicyModule surface:
        # initial_state/forward_step) carry hidden state through the
        # rollout, here on the device; sample() then also records
        # window-start states and PPO trains with sequence batches.
        self.recurrent = hasattr(self.module, "initial_state") \
            and hasattr(self.module, "forward_step")
        if self.recurrent:
            self._rec_state = self.module.initial_state(num_envs).to(
                self.device)

    def _connect(self, obs: np.ndarray) -> np.ndarray:
        return obs if self.env_to_module is None else self.env_to_module(obs)

    # -- weights --------------------------------------------------------- #

    def get_state(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {"params": self.params}
        if self.env_to_module is not None:
            state["connectors"] = self.env_to_module.get_state()
        return state

    def set_state(self, state: Dict[str, Any]) -> bool:
        self.params = to_device(state["params"], self.device)
        if self.env_to_module is not None and "connectors" in state:
            self.env_to_module.set_state(state["connectors"])
        return True

    def set_weights(self, params) -> bool:
        self.params = to_device(params, self.device)
        return True

    # -- sampling -------------------------------------------------------- #

    def _act(self, obs: torch.Tensor):
        """One step's forward -> (actions, logp, values) on the host, in
        one transfer."""
        n = self.vec.num_envs
        if self.recurrent:
            logits, values, self._rec_state = self.module.forward_step(
                self.params, obs, self._rec_state)
            if not self.explore:
                # Greedy, like forward_inference for evaluation runners.
                a = fetch(torch.argmax(logits, -1))[0]
                return a, np.zeros(n, np.float32), np.zeros(n, np.float32)
            actions = categorical(logits, self._gen)
            a, logp, v = fetch(actions, take(torch.log_softmax(logits, -1),
                                             actions), values)
            return a, logp, v
        if not self.explore:
            a = fetch(self.module.forward_inference(self.params, obs))[0]
            return a, np.zeros(n, np.float32), np.zeros(n, np.float32)
        return tuple(fetch(*self.module.forward_exploration(
            self.params, obs, self._gen)))

    def _values(self, obs: np.ndarray, state=None) -> np.ndarray:
        x = to_device(obs, self.device)
        if self.recurrent:
            return fetch(self.module.forward_step(self.params, x, state)[1])[0]
        return fetch(self.module.forward_train(self.params, x)["value"])[0]

    @torch.no_grad()
    def sample(self, num_steps: int = 256) -> Dict[str, np.ndarray]:
        """Rollout ``num_steps`` per sub-env; returns time-major flattened
        arrays plus bootstrap values for GAE."""
        n, d = self.vec.num_envs, self.spec.observation_dim
        obs_buf = np.empty((num_steps, n, d), np.float32)
        act_buf = np.empty((num_steps, n), np.int32)
        logp_buf = np.empty((num_steps, n), np.float32)
        val_buf = np.empty((num_steps, n), np.float32)
        rew_buf = np.empty((num_steps, n), np.float32)
        done_buf = np.empty((num_steps, n), bool)
        term_buf = np.empty((num_steps, n), bool)
        # V(final_obs) for truncated boundaries (0 elsewhere): the GAE
        # bootstrap for episodes cut by time limits, not by termination.
        boot_buf = np.zeros((num_steps, n), np.float32)
        # Recurrent: the learner replays this window from its start
        # state, resetting at in-window episode boundaries.
        state_in = self._rec_state.clone() if self.recurrent else None

        for t in range(num_steps):
            actions, logp, values = self._act(
                to_device(self._obs, self.device))
            actions = actions.astype(np.int64)
            obs_buf[t] = self._obs
            act_buf[t] = actions
            logp_buf[t] = logp
            val_buf[t] = values
            raw_obs, rewards, dones, terms, final_obs = \
                self.vec.step(actions)
            if self.env_to_module is not None and dones.any():
                # Auto-reset rows carry a fresh episode's obs: history-
                # keeping connectors must not leak old frames into it.
                self.env_to_module.on_episode_boundaries(dones)
            self._obs = self._connect(raw_obs)
            rew_buf[t] = rewards if self.reward_connector is None \
                else self.reward_connector(rewards)
            done_buf[t] = dones
            term_buf[t] = terms
            truncs = dones & ~terms
            if self.explore and truncs.any():
                # Note: with a stateful FrameStack connector the truncation
                # bootstrap sees the post-step stack — an approximation the
                # reference shares (final_observation is a single frame).
                fo = final_obs if self.env_to_module is None else \
                    self.env_to_module.transform(final_obs)
                # Recurrent: the value of the truncated final obs under the
                # state that produced it (before the reset below).
                vals = self._values(fo, self._rec_state
                                    if self.recurrent else None)
                boot_buf[t, truncs] = vals[truncs]
            if self.recurrent and dones.any():
                # Fresh episodes start from the zero state.
                self._rec_state = torch.where(
                    to_device(dones, self.device)[:, None], 0.0,
                    self._rec_state)
            self._ep_returns += rewards
            self._ep_lens += 1
            for i in np.nonzero(dones)[0]:
                self._finished_returns.append(float(self._ep_returns[i]))
                self._finished_lens.append(int(self._ep_lens[i]))
                self._ep_returns[i] = 0.0
                self._ep_lens[i] = 0

        # Bootstrap value for the final observation of each sub-env.
        if self.explore:
            last_val = self._values(self._obs, self._rec_state
                                    if self.recurrent else None)
        else:
            last_val = np.zeros(n, np.float32)
        out = {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "values": val_buf, "rewards": rew_buf, "dones": done_buf,
            "terminateds": term_buf, "bootstrap_values": boot_buf,
            "last_values": last_val,
        }
        if self.recurrent:
            out["state_in"] = state_in.cpu().numpy()
        return out

    def metrics(self, window: int = 100) -> Dict[str, float]:
        rets = self._finished_returns[-window:]
        lens = self._finished_lens[-window:]
        return {
            "episode_return_mean": float(np.mean(rets)) if rets else np.nan,
            "episode_len_mean": float(np.mean(lens)) if lens else np.nan,
            "num_episodes": len(self._finished_returns),
        }


class EnvRunnerGroup:
    """The local runner (reference: env_runner_group.py:70 with
    ``num_env_runners=0``, the rllib debugging convention)."""

    def __init__(self, env_creator: Callable, *, num_env_runners: int = 0,
                 num_envs_per_runner: int = 4,
                 module_spec: Optional[RLModuleSpec] = None, seed: int = 0,
                 env_to_module_fn=None, module_fn=None,
                 device: DeviceLike = None):
        if num_env_runners != 0:
            raise NotImplementedError(
                f"num_env_runners={num_env_runners}: remote env runners "
                f"are not ported yet; see {PROCESS_TIER}.  Use "
                f"num_env_runners=0.")
        self.num_env_runners = 0
        self.local = EnvRunner(
            env_creator, num_envs=num_envs_per_runner,
            module_spec=module_spec, seed=seed,
            env_to_module=env_to_module_fn and env_to_module_fn(),
            module=module_fn and module_fn(), device=device)
        self.remotes: list = []

    def sample(self, num_steps: int = 256) -> List[Dict[str, np.ndarray]]:
        return [self.local.sample(num_steps)]

    def sync_weights(self, params) -> None:
        self.local.set_state({"params": params})

    def connector_state(self):
        return self.local.get_state().get("connectors")

    def aggregate_metrics(self) -> Dict[str, float]:
        return self.local.metrics()

    def stop(self) -> None:
        pass

"""RL environment API + built-in envs (no gym dependency).

A copy of ``ray_tpu/rl/env.py`` (numpy only): the port imports
nothing of the JAX package, not even its framework-free modules.

Reference: rllib's env layer (rllib/env/) consumes Farama gymnasium; the
TPU build keeps the same (reset/step, observation_space-ish metadata)
surface but ships self-contained numpy envs so CI needs no extra deps.
CartPole-v1 dynamics follow the classic Barto-Sutton-Anderson formulation
(matching gymnasium.envs.classic_control.CartPoleEnv semantics).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class Env:
    """Single-agent episodic environment.

    ``reset(seed) -> (obs, info)``; ``step(action) -> (obs, reward,
    terminated, truncated, info)`` — the gymnasium 5-tuple convention the
    reference's EnvRunners consume.

    Discrete envs set ``num_actions``; continuous envs set ``action_dim``
    (+ ``action_low``/``action_high`` bounds) and take float vectors in
    ``step``.
    """

    observation_dim: int
    num_actions: int = 0
    # Continuous action space (None = discrete).
    action_dim: Optional[int] = None
    action_low: float = -1.0
    action_high: float = 1.0

    @property
    def is_continuous(self) -> bool:
        return self.action_dim is not None

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        raise NotImplementedError

    def step(self, action
             ) -> Tuple[np.ndarray, float, bool, bool, Dict]:
        raise NotImplementedError


class CartPole(Env):
    """Classic cart-pole balance task; reward +1 per step, 500-step cap."""

    observation_dim = 4
    num_actions = 2

    def __init__(self, max_steps: int = 500):
        self._rng = np.random.default_rng(0)
        self.max_steps = max_steps
        self._state = np.zeros(4, np.float64)
        self._t = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = 10.0 if action == 1 else -10.0
        costh, sinth = np.cos(theta), np.sin(theta)
        gravity, masscart, masspole, length = 9.8, 1.0, 0.1, 0.5
        total_mass = masscart + masspole
        polemass_length = masspole * length
        tau = 0.02

        temp = (force + polemass_length * theta_dot ** 2 * sinth) / total_mass
        thetaacc = (gravity * sinth - costh * temp) / (
            length * (4.0 / 3.0 - masspole * costh ** 2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costh / total_mass
        x = x + tau * x_dot
        x_dot = x_dot + tau * xacc
        theta = theta + tau * theta_dot
        theta_dot = theta_dot + tau * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._t += 1

        terminated = bool(abs(x) > 2.4 or abs(theta) > 12 * np.pi / 180)
        truncated = self._t >= self.max_steps
        return (self._state.astype(np.float32), 1.0, terminated, truncated,
                {})


class StatelessGuess(Env):
    """Trivial one-step env for fast learning tests: observation is a
    one-hot context; the reward is 1 when action == context else 0.  An
    optimal policy reaches mean return 1.0; random play ~1/num_actions."""

    def __init__(self, n: int = 4, seed: int = 0):
        self.observation_dim = n
        self.num_actions = n
        self._rng = np.random.default_rng(seed)
        self._ctx = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ctx = int(self._rng.integers(self.num_actions))
        obs = np.zeros(self.observation_dim, np.float32)
        obs[self._ctx] = 1.0
        return obs, {}

    def step(self, action: int):
        reward = 1.0 if int(action) == self._ctx else 0.0
        obs = np.zeros(self.observation_dim, np.float32)
        return obs, reward, True, False, {}


class DelayedRecall(Env):
    """Partially observable memory probe: the FIRST observation encodes
    a one-hot cue; every later observation carries only a phase scalar.
    Reward 1 arrives iff the action on the final step matches the cue —
    a memoryless policy cannot beat 1/num_actions expected return, a
    recurrent one reaches ~1.0 (the recurrent-module analog of rllib's
    StatelessCartPole memory checks)."""

    def __init__(self, delay: int = 3, n: int = 2, seed: int = 0):
        self.delay = delay
        self.observation_dim = 1 + n      # [phase, cue one-hot...]
        self.num_actions = n
        self._rng = np.random.default_rng(seed)
        self._cue = 0
        self._t = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._cue = int(self._rng.integers(self.num_actions))
        self._t = 0
        obs = np.zeros(self.observation_dim, np.float32)
        obs[1 + self._cue] = 1.0
        return obs, {}

    def step(self, action: int):
        self._t += 1
        done = self._t > self.delay
        reward = 0.0
        if done:
            reward = 1.0 if int(action) == self._cue else 0.0
        obs = np.zeros(self.observation_dim, np.float32)
        obs[0] = self._t / (self.delay + 1)
        return obs, reward, done, False, {}


class Pendulum(Env):
    """Classic underactuated pendulum swing-up (gymnasium Pendulum-v1
    dynamics): obs [cos th, sin th, th_dot], torque in [-2, 2], reward
    -(th^2 + 0.1 th_dot^2 + 0.001 a^2), 200-step episodes."""

    observation_dim = 3
    action_dim = 1
    action_low = -2.0
    action_high = 2.0

    def __init__(self, max_steps: int = 200):
        self._rng = np.random.default_rng(0)
        self.max_steps = max_steps
        self._th = 0.0
        self._thdot = 0.0
        self._t = 0

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._th), np.sin(self._th), self._thdot],
                        np.float32)

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th = self._rng.uniform(-np.pi, np.pi)
        self._thdot = self._rng.uniform(-1.0, 1.0)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        g, m, length, dt = 10.0, 1.0, 1.0, 0.05
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -2.0, 2.0))
        th = ((self._th + np.pi) % (2 * np.pi)) - np.pi
        cost = th ** 2 + 0.1 * self._thdot ** 2 + 0.001 * u ** 2
        thdot = self._thdot + (
            3 * g / (2 * length) * np.sin(th)
            + 3.0 / (m * length ** 2) * u) * dt
        thdot = float(np.clip(thdot, -8.0, 8.0))
        self._th = self._th + thdot * dt
        self._thdot = thdot
        self._t += 1
        return self._obs(), -float(cost), False, self._t >= self.max_steps, {}


class TargetReach(Env):
    """One-step continuous env for fast learning tests: obs is a target in
    [-0.8, 0.8]; reward is -(action - target)^2.  An optimal policy earns
    ~0; a random tanh policy ~-0.5."""

    observation_dim = 1
    action_dim = 1
    action_low = -1.0
    action_high = 1.0

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._target = 0.0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._target = float(self._rng.uniform(-0.8, 0.8))
        return np.array([self._target], np.float32), {}

    def step(self, action):
        a = float(np.asarray(action).reshape(-1)[0])
        reward = -(a - self._target) ** 2
        return np.zeros(1, np.float32), reward, True, False, {}


_ENV_REGISTRY: Dict[str, Callable[[], Env]] = {
    "CartPole-v1": CartPole,
    "StatelessGuess": StatelessGuess,
    "Pendulum-v1": Pendulum,
    "TargetReach": TargetReach,
}


def register_env(name: str, creator: Callable[[], Env]) -> None:
    """Reference: ray.tune.register_env / rllib env registry."""
    _ENV_REGISTRY[name] = creator


def make_env(spec: Any) -> Env:
    if isinstance(spec, Env):
        return spec
    if isinstance(spec, str):
        try:
            return _ENV_REGISTRY[spec]()
        except KeyError:
            raise ValueError(f"unknown env {spec!r}; register_env() it first")
    if callable(spec):
        return spec()
    raise TypeError(f"cannot build env from {spec!r}")


class VectorEnv:
    """N independent env copies stepped in lockstep with auto-reset
    (reference: rllib SingleAgentEnvRunner wraps gymnasium.vector)."""

    def __init__(self, creator: Callable[[], Env], num_envs: int,
                 seed: int = 0):
        if isinstance(creator, Env) and num_envs > 1:
            # A bare Env instance would alias the same object across all
            # sub-envs (N lockstep copies stepping one shared state) —
            # give each sub-env its own deep copy instead.
            import copy
            self.envs: List[Env] = [copy.deepcopy(creator)
                                    for _ in range(num_envs)]
        else:
            self.envs = [make_env(creator) for _ in range(num_envs)]
        self.num_envs = num_envs
        self.observation_dim = self.envs[0].observation_dim
        self.num_actions = self.envs[0].num_actions
        self._seed = seed

    def reset(self) -> np.ndarray:
        obs = [e.reset(seed=self._seed + i)[0]
               for i, e in enumerate(self.envs)]
        self._seed += self.num_envs
        return np.stack(obs)

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                        np.ndarray]:
        """Returns (obs, rewards, dones, terminateds, final_obs).

        Finished sub-envs auto-reset; ``dones`` marks boundaries (terminated
        or truncated).  ``final_obs[i]`` is the pre-reset observation of a
        finished sub-env (== obs[i] otherwise) so truncated episodes can
        bootstrap from V(final_obs) instead of the next episode's reset
        state (the gymnasium ``final_observation`` convention)."""
        obs_out = np.empty((self.num_envs, self.observation_dim), np.float32)
        final_obs = np.empty_like(obs_out)
        rewards = np.empty(self.num_envs, np.float32)
        dones = np.zeros(self.num_envs, bool)
        terminateds = np.zeros(self.num_envs, bool)
        for i, (env, a) in enumerate(zip(self.envs, actions)):
            obs, r, term, trunc, _ = env.step(int(a))
            rewards[i] = r
            final_obs[i] = obs
            if term or trunc:
                dones[i] = True
                terminateds[i] = term
                obs, _ = env.reset(seed=self._seed)
                self._seed += 1
            obs_out[i] = obs
        return obs_out, rewards, dones, terminateds, final_obs

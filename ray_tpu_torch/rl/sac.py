"""SAC: soft actor-critic for continuous control.

Counterpart of ``ray_tpu/rl/sac.py``: one update is the critic, actor,
temperature and polyak steps of the JAX package's jitted ``update``, each
optimizer an ``optim.adam`` (optax's), all on the device; the metrics come
back in ONE transfer (the JAX package's RT502 fix).  The two normal draws
of an update (the next-state action, then the current one) come from a
``torch.Generator``, or from ``eps`` when a test hands over JAX's draws.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import optim
from .._device import make_generator
from .._tree import tree_map
from ._transfer import fetch, fetch_metrics, to_device
from .algorithm import Algorithm, AlgorithmConfig
from .env import make_env
from .learner import value_and_grad
from .replay_buffer import ReplayBuffer
from .rl_module import ContinuousModuleSpec, GaussianPolicyModule, TwinQModule


class SACState(NamedTuple):
    pi_params: Any
    q_params: Any
    q_target: Any
    log_alpha: Any
    pi_opt: Any
    q_opt: Any
    alpha_opt: Any


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(SAC)
        self.buffer_size = 100_000
        self.learning_starts = 500
        self.tau = 0.005            # polyak coefficient
        self.train_batch_size = 256
        self.updates_per_step = 1
        self.initial_alpha = 0.2
        self.target_entropy = None  # default: -action_dim
        self.actor_lr = None        # default: lr
        self.critic_lr = None
        self.alpha_lr = 3e-4

    def training(self, *, buffer_size=None, learning_starts=None, tau=None,
                 updates_per_step=None, initial_alpha=None,
                 target_entropy=None, actor_lr=None, critic_lr=None,
                 alpha_lr=None, **kw) -> "SACConfig":
        super().training(**kw)
        for name, val in (("buffer_size", buffer_size),
                          ("learning_starts", learning_starts),
                          ("tau", tau),
                          ("updates_per_step", updates_per_step),
                          ("initial_alpha", initial_alpha),
                          ("target_entropy", target_entropy),
                          ("actor_lr", actor_lr),
                          ("critic_lr", critic_lr),
                          ("alpha_lr", alpha_lr)):
            if val is not None:
                setattr(self, name, val)
        return self


def _step(opt, grads, opt_state, params):
    updates, opt_state = opt.update(grads, opt_state, params)
    return optim.apply_updates(params, updates), opt_state


def polyak(target, online, tau: float):
    return tree_map(lambda t, o: (1 - tau) * t + tau * o, target, online)


class SAC(Algorithm):
    """Off-policy; drives its own env loop like DQN."""

    _use_env_runner_group = False

    def _continuous_setup(self, config, name: str):
        """The env, the policy and the three optimizers SAC and TQC share;
        returns (spec, generator for the params)."""
        env = make_env(config.env_spec)
        if not env.is_continuous:
            raise ValueError(f"{name} requires a continuous-action env "
                             "(set env.action_dim)")
        self.env = env
        spec = ContinuousModuleSpec(env.observation_dim, env.action_dim,
                                    env.action_low, env.action_high,
                                    tuple(config.module_hidden))
        self.pi = GaussianPolicyModule(spec)
        self.target_entropy = (config.target_entropy
                               if config.target_entropy is not None
                               else -float(env.action_dim))
        self.pi_optim = optim.adam(config.actor_lr or config.lr)
        self.q_optim = optim.adam(config.critic_lr or config.lr)
        self.alpha_optim = optim.adam(config.alpha_lr)
        self.buffer = ReplayBuffer(config.buffer_size, seed=config.seed)
        self._gen = make_generator(self.device, config.seed + 1)
        self._obs, _ = self.env.reset(seed=config.seed)
        self._steps = 0
        self._rng = np.random.default_rng(config.seed)
        self._ep_return = 0.0
        self._returns: list = []
        return spec, make_generator(self.device, config.seed)

    def _log_alpha0(self, config) -> torch.Tensor:
        return torch.log(torch.tensor(config.initial_alpha,
                                      dtype=torch.float32,
                                      device=self.device))

    def setup(self, config: SACConfig) -> None:
        spec, gen = self._continuous_setup(config, "SAC")
        self.q = TwinQModule(spec)
        pi_params = self.pi.init(gen)
        q_params = self.q.init(gen)
        log_alpha = self._log_alpha0(config)
        self.state = SACState(
            pi_params, q_params, q_params, log_alpha,
            self.pi_optim.init(pi_params), self.q_optim.init(q_params),
            self.alpha_optim.init(log_alpha))

    def _draws(self, eps, shape) -> Tuple[torch.Tensor, torch.Tensor]:
        if eps is not None:
            return to_device(tuple(eps), self.device)
        return tuple(torch.randn(shape, generator=self._gen,
                                 device=self.device) for _ in range(2))

    def _actor_and_alpha(self, state, batch, alpha, eps_cur, critic):
        """The actor step against ``critic(obs, a)`` (a Q estimate per row)
        and the temperature step; SAC and TQC share it."""
        def actor_loss(pp):
            a, logp = self.pi.sample(pp, batch["obs"], eps=eps_cur)
            return torch.mean(alpha * logp - critic(batch["obs"], a)), \
                torch.mean(logp)

        (aloss, logp_mean), pi_grads = value_and_grad(actor_loss,
                                                      state.pi_params)
        logp_mean = logp_mean.detach()
        with torch.no_grad():
            pi_params, pi_opt = _step(self.pi_optim, pi_grads, state.pi_opt,
                                      state.pi_params)
        target = logp_mean + self.target_entropy
        _, a_grads = value_and_grad(
            lambda la: -torch.exp(la) * target, state.log_alpha)
        with torch.no_grad():
            log_alpha, alpha_opt = _step(self.alpha_optim, a_grads,
                                         state.alpha_opt, state.log_alpha)
        return aloss.detach(), logp_mean, pi_params, pi_opt, log_alpha, \
            alpha_opt

    def _update(self, batch: Dict[str, Any],
                eps: Optional[Tuple[Any, Any]] = None
                ) -> Dict[str, torch.Tensor]:
        """One update of ``self.state``; the metrics stay on the device.
        ``eps``: the standard-normal draws (next state's, current
        state's), each [B, action_dim]; drawn from the algorithm's
        generator unless given."""
        cfg: SACConfig = self.config
        state = self.state
        batch = to_device(batch, self.device)
        eps_next, eps_cur = self._draws(
            eps, (len(batch["obs"]), self.env.action_dim))
        alpha = torch.exp(state.log_alpha)
        q = self.q

        # -- critic: soft TD target from the target twin (clipped) --------
        with torch.no_grad():
            next_a, next_logp = self.pi.sample(state.pi_params,
                                               batch["next_obs"],
                                               eps=eps_next)
            tq1, tq2 = q.q_values(state.q_target, batch["next_obs"], next_a)
            next_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target = batch["rewards"] + cfg.gamma * \
                (1.0 - batch["terminateds"]) * next_v

        def critic_loss(qp):
            q1, q2 = q.q_values(qp, batch["obs"], batch["actions"])
            return torch.mean((q1 - target) ** 2 + (q2 - target) ** 2), \
                (torch.mean(q1), torch.mean(torch.abs(q1 - target)))

        (closs, (q_mean, td_abs)), q_grads = value_and_grad(critic_loss,
                                                            state.q_params)
        with torch.no_grad():
            q_params, q_opt = _step(self.q_optim, q_grads, state.q_opt,
                                    state.q_params)

        # -- actor: maximize E[min Q - alpha log pi]; temperature ---------
        aloss, logp_mean, pi_params, pi_opt, log_alpha, alpha_opt = \
            self._actor_and_alpha(
                state, batch, alpha, eps_cur,
                lambda obs, a: torch.minimum(*q.q_values(q_params, obs, a)))

        with torch.no_grad():
            q_target = polyak(state.q_target, q_params, cfg.tau)
        self.state = SACState(pi_params, q_params, q_target, log_alpha,
                              pi_opt, q_opt, alpha_opt)
        return {"critic_loss": closs.detach(), "actor_loss": aloss,
                "alpha": alpha, "q_mean": q_mean.detach(),
                "td_abs": td_abs.detach(), "logp_mean": logp_mean}

    @torch.no_grad()
    def _act(self, obs: np.ndarray) -> np.ndarray:
        cfg: SACConfig = self.config
        if self._steps < cfg.learning_starts:
            # Warmup: uniform random actions across the bounds.
            return self._rng.uniform(
                self.env.action_low, self.env.action_high,
                self.env.action_dim).astype(np.float32)
        return self.compute_single_action(obs, explore=True)

    def training_step(self) -> Dict[str, Any]:
        cfg: SACConfig = self.config
        metrics: Dict[str, float] = {}
        for _ in range(cfg.rollout_fragment_length):
            action = self._act(self._obs)
            next_obs, r, term, trunc, _ = self.env.step(action)
            self.buffer.add(
                obs=self._obs[None], actions=action[None].astype(np.float32),
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
            if self._steps >= cfg.learning_starts and \
                    self._steps % cfg.updates_per_step == 0:
                # ONE transfer for the metrics dict, not one per value.
                metrics = fetch_metrics(self._update(
                    self.buffer.sample(cfg.train_batch_size)))
        recent = self._returns[-100:]
        return {
            "learner": metrics,
            "num_env_steps_sampled": self._steps,
            "buffer_size": len(self.buffer),
            "env_runners": {
                "episode_return_mean":
                    float(np.mean(recent)) if recent else float("nan"),
                "num_episodes": len(self._returns),
            },
        }

    def get_weights(self):
        return {"pi": self.state.pi_params, "q": self.state.q_params,
                "q_target": self.state.q_target,
                "log_alpha": self.state.log_alpha}

    def set_weights(self, params) -> None:
        params = to_device(params, self.device)
        self.state = self.state._replace(
            pi_params=params["pi"], q_params=params["q"],
            q_target=params["q_target"], log_alpha=params["log_alpha"])

    @torch.no_grad()
    def compute_single_action(self, obs: np.ndarray,
                              explore: bool = False) -> np.ndarray:
        x = to_device(obs[None], self.device)
        if explore:
            a, _ = self.pi.sample(self.state.pi_params, x, self._gen)
        else:
            a = self.pi.forward_inference(self.state.pi_params, x)
        return fetch(a[0])[0]

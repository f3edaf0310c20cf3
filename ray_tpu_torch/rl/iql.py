"""IQL: implicit Q-learning over offline transitions (discrete actions).

Counterpart of ``ray_tpu/rl/iql.py`` on the BC/CQL scaffolding:

  * V(s) learns the tau-expectile of Q_target(s, a_data);
  * Q(s, a) regresses on r + gamma * (1 - d) * V(s');
  * pi extracts by advantage-weighted regression:
    max E[exp(beta * (Q_target - V)) * log pi(a_data | s)].

The three heads update in one step (a single loss with the gradient cut
where IQL decouples them), as the JAX package's one jitted step does.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ._transfer import fetch, to_device
from .algorithm import Algorithm
from .env import make_env
from .learner import TorchLearner
from .offline import BCConfig, OfflineData
from .rl_module import _init_mlp, _mlp, take


class IQLModule:
    """Composite module: q / v / pi MLP heads over the observation."""

    def __init__(self, spec):
        self.spec = spec

    def init(self, gen: torch.Generator):
        obs, act, hidden = (self.spec.observation_dim,
                            self.spec.num_actions,
                            tuple(self.spec.hidden))
        return {
            "q": _init_mlp(gen, (obs, *hidden, act)),
            "v": _init_mlp(gen, (obs, *hidden, 1)),
            "pi": _init_mlp(gen, (obs, *hidden, act)),
        }

    def q_values(self, params, obs):
        return _mlp(params["q"], obs)

    def value(self, params, obs):
        return _mlp(params["v"], obs)[..., 0]

    def logits(self, params, obs):
        return _mlp(params["pi"], obs)

    def forward_inference(self, params, obs):
        return torch.argmax(self.logits(params, obs), dim=-1)


def iql_loss(module: IQLModule, params, batch):
    obs, actions = batch["obs"], batch["actions"]
    tau = batch["expectile"][0]
    beta = batch["awr_beta"][0]

    # Expectile regression: V toward Q_target(s, a_data).
    tq = take(_mlp(batch["target_q"], obs), actions).detach()
    v = module.value(params, obs)
    diff = tq - v
    weight = torch.where(diff > 0, tau, 1.0 - tau)
    v_loss = torch.mean(weight * diff ** 2)

    # Q TD toward r + gamma (1-d) V(s') (value net gradient-stopped).
    v_next = module.value(params, batch["next_obs"]).detach()
    targets = batch["rewards"] + batch["gamma"][0] * \
        (1.0 - batch["terminateds"]) * v_next
    q_loss = torch.mean((take(module.q_values(params, obs), actions)
                         - targets) ** 2)

    # Advantage-weighted policy extraction.
    adv = (tq - v).detach()
    w = torch.clamp(torch.exp(beta * adv), max=100.0)
    logp = take(torch.log_softmax(module.logits(params, obs), -1), actions)
    pi_loss = -torch.mean(w * logp)

    total = q_loss + v_loss + pi_loss
    return total, {"q_loss": q_loss, "v_loss": v_loss, "pi_loss": pi_loss,
                   "adv_mean": torch.mean(adv), "w_mean": torch.mean(w)}


class IQLConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = IQL
        self.expectile = 0.8
        self.awr_beta = 3.0
        self.target_update_freq = 10  # in updates

    def training(self, *, expectile=None, awr_beta=None,
                 target_update_freq=None, **kw) -> "IQLConfig":
        super().training(**kw)
        if expectile is not None:
            self.expectile = expectile
        if awr_beta is not None:
            self.awr_beta = awr_beta
        if target_update_freq is not None:
            self.target_update_freq = target_update_freq
        return self


class IQL(Algorithm):
    """Discrete implicit Q-learning (reference: rllib/algorithms/iql)."""

    _use_env_runner_group = False

    def setup(self, config: IQLConfig) -> None:
        if config.input_path is None:
            raise ValueError("IQLConfig.offline_data(input_path=...) "
                             "required")
        self.data = OfflineData(config.input_path, seed=config.seed)
        for c in ("rewards", "next_obs", "terminateds"):
            if c not in self.data.columns:
                raise ValueError(f"IQL needs transition column {c!r}")
        self.env = make_env(config.env_spec)
        self.module = IQLModule(config.module_spec())
        self.learner = TorchLearner(self.module, iql_loss,
                                    learning_rate=config.lr,
                                    seed=config.seed, device=self.device)
        self.target_q = self.learner.params["q"]
        self._n_updates = 0

    def _update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        cfg: IQLConfig = self.config
        metrics = self.learner.update({
            "obs": batch["obs"], "actions": batch["actions"],
            "rewards": batch["rewards"], "next_obs": batch["next_obs"],
            "terminateds": batch["terminateds"],
            "target_q": self.target_q,
            "gamma": np.array([cfg.gamma], np.float32),
            "expectile": np.array([cfg.expectile], np.float32),
            "awr_beta": np.array([cfg.awr_beta], np.float32)})
        self._n_updates += 1
        if self._n_updates % cfg.target_update_freq == 0:
            self.target_q = self.learner.params["q"]
        return metrics

    def training_step(self) -> Dict[str, Any]:
        cfg: IQLConfig = self.config
        metrics: Dict[str, float] = {}
        for _ in range(cfg.updates_per_iteration):
            metrics = self._update(self.data.sample(cfg.train_batch_size))
        return {"learner": metrics, "dataset_size": self.data.size}

    @torch.no_grad()
    def compute_single_action(self, obs: np.ndarray) -> int:
        return int(fetch(self.module.forward_inference(
            self.learner.params, to_device(obs[None], self.device)))[0, 0])

    def get_weights(self):
        return {"params": self.learner.params, "target_q": self.target_q}

    def set_weights(self, params) -> None:
        self.learner.set_weights(params["params"])
        self.target_q = to_device(params["target_q"], self.device)

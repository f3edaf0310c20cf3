"""TQC: truncated quantile critics for continuous control.

Counterpart of ``ray_tpu/rl/tqc.py`` on the SAC scaffolding.  The critic
ensemble keeps its params stacked ``[N, ...]`` (the JAX package's layout,
so its weights carry over 1:1); a batched matmul over the leading axis
stands in for ``jax.vmap`` (``tqc.py:40-54``) and evaluates the N critics
at once.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .rl_module import ContinuousModuleSpec, _init_mlp
from .sac import SAC, SACConfig, _step, polyak
from ._transfer import to_device
from .learner import value_and_grad


class TQCState(NamedTuple):
    pi_params: Any
    z_params: Any     # quantile critic ensemble
    z_target: Any
    log_alpha: Any
    pi_opt: Any
    z_opt: Any
    alpha_opt: Any


class QuantileCriticEnsemble:
    """N critics x M quantiles of Z(s, a), batched over the ensemble."""

    def __init__(self, spec: ContinuousModuleSpec, num_critics: int,
                 num_quantiles: int):
        self.spec = spec
        self.n = num_critics
        self.m = num_quantiles

    def init(self, gen: torch.Generator):
        dims = (self.spec.observation_dim + self.spec.action_dim,
                *self.spec.hidden, self.m)
        per = [_init_mlp(gen, dims) for _ in range(self.n)]
        return {k: torch.stack([p[k] for p in per]) for k in per[0]}

    def quantiles(self, params, obs, actions):
        """-> [N, B, M]: ``_mlp`` of every critic, as [N]-batched
        matmuls."""
        x = torch.cat([obs, actions], dim=-1)[None]          # [1, B, D]
        n = len(params) // 2
        for i in range(n):
            x = x @ params[f"w{i}"] + params[f"b{i}"][:, None, :]
            if i < n - 1:
                x = torch.tanh(x)
        return x


def _quantile_huber(pred, target, taus, kappa: float = 1.0):
    """pred [B, M]; target [B, K] (gradient-free); taus [M] -> scalar."""
    delta = target[:, None, :] - pred[:, :, None]          # [B, M, K]
    abs_d = torch.abs(delta)
    huber = torch.where(abs_d <= kappa, 0.5 * delta ** 2,
                        kappa * (abs_d - 0.5 * kappa))
    weight = torch.abs(taus[None, :, None] - (delta < 0).to(torch.float32))
    return torch.mean(torch.sum(weight * huber, dim=1) / kappa)


class TQCConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = TQC
        self.num_critics = 3
        self.num_quantiles = 13
        self.top_quantiles_to_drop = 2  # per critic

    def training(self, *, num_critics=None, num_quantiles=None,
                 top_quantiles_to_drop=None, **kw) -> "TQCConfig":
        super().training(**kw)
        if num_critics is not None:
            self.num_critics = num_critics
        if num_quantiles is not None:
            self.num_quantiles = num_quantiles
        if top_quantiles_to_drop is not None:
            self.top_quantiles_to_drop = top_quantiles_to_drop
        return self


class TQC(SAC):
    """Off-policy, drives its own env loop (SAC scaffolding)."""

    def setup(self, config: TQCConfig) -> None:
        spec, gen = self._continuous_setup(config, "TQC")
        self.z = QuantileCriticEnsemble(spec, config.num_critics,
                                        config.num_quantiles)
        n, m = config.num_critics, config.num_quantiles
        self.kept = n * (m - config.top_quantiles_to_drop)
        if self.kept <= 0:
            raise ValueError("top_quantiles_to_drop leaves no target atoms")
        self.taus = (2 * torch.arange(m, dtype=torch.float32,
                                      device=self.device) + 1) / (2 * m)
        pi_params = self.pi.init(gen)
        z_params = self.z.init(gen)
        log_alpha = self._log_alpha0(config)
        self.state = TQCState(
            pi_params, z_params, z_params, log_alpha,
            self.pi_optim.init(pi_params), self.q_optim.init(z_params),
            self.alpha_optim.init(log_alpha))

    def _update(self, batch: Dict[str, Any],
                eps: Optional[Tuple[Any, Any]] = None
                ) -> Dict[str, torch.Tensor]:
        cfg: TQCConfig = self.config
        state, z, n = self.state, self.z, self.z.n
        batch = to_device(batch, self.device)
        eps_next, eps_cur = self._draws(
            eps, (len(batch["obs"]), self.env.action_dim))
        alpha = torch.exp(state.log_alpha)

        # -- critics: truncated pooled target distribution ----------------
        with torch.no_grad():
            next_a, next_logp = self.pi.sample(state.pi_params,
                                               batch["next_obs"],
                                               eps=eps_next)
            tz = z.quantiles(state.z_target, batch["next_obs"], next_a)
            B = tz.shape[1]
            pooled = torch.sort(tz.permute(1, 0, 2).reshape(B, -1),
                                dim=-1).values[:, :self.kept]
            target = batch["rewards"][:, None] + cfg.gamma * \
                (1.0 - batch["terminateds"])[:, None] * \
                (pooled - alpha * next_logp[:, None])

        def critic_loss(zp):
            qs = z.quantiles(zp, batch["obs"], batch["actions"])
            loss = sum(_quantile_huber(qs[i], target, self.taus)
                       for i in range(n)) / n
            return loss, torch.mean(qs)

        (closs, z_mean), z_grads = value_and_grad(critic_loss,
                                                  state.z_params)
        with torch.no_grad():
            z_params, z_opt = _step(self.q_optim, z_grads, state.z_opt,
                                    state.z_params)

        # -- actor (mean of ALL quantiles) and temperature ----------------
        aloss, logp_mean, pi_params, pi_opt, log_alpha, alpha_opt = \
            self._actor_and_alpha(
                state, batch, alpha, eps_cur,
                lambda obs, a: torch.mean(z.quantiles(z_params, obs, a),
                                          dim=(0, 2)))

        with torch.no_grad():
            z_target = polyak(state.z_target, z_params, cfg.tau)
        self.state = TQCState(pi_params, z_params, z_target, log_alpha,
                              pi_opt, z_opt, alpha_opt)
        return {"critic_loss": closs.detach(), "actor_loss": aloss,
                "alpha": alpha, "z_mean": z_mean.detach(),
                "logp_mean": logp_mean}

    def get_weights(self):
        return {"pi": self.state.pi_params, "z": self.state.z_params,
                "z_target": self.state.z_target,
                "log_alpha": self.state.log_alpha}

    def set_weights(self, params) -> None:
        params = to_device(params, self.device)
        self.state = self.state._replace(
            pi_params=params["pi"], z_params=params["z"],
            z_target=params["z_target"], log_alpha=params["log_alpha"])

"""RLModule: the model abstraction (policy + value / Q heads) in PyTorch.

Counterpart of ``ray_tpu/rl/rl_module.py``: the same modules as pure
functions of parameter trees (dicts of tensors with the JAX package's keys
``w{i}``/``b{i}`` and layouts), so a JAX ``get_weights()`` carried over
through numpy (``models.convert.params_from_numpy``) drives them unchanged.

``init`` draws from an explicit ``torch.Generator`` on the device the
params should live on (JAX's threefry draws cannot be matched: carry JAX's
weights across to feed both packages the same ones).  Sampling takes a
generator too, and ``GaussianPolicyModule.sample`` an optional ``eps`` so a
test can hand it the normal draws JAX made.  Discrete actions are drawn by
Gumbel-max on the device (``-log`` of exponential noise), the distribution
of ``jax.random.categorical``, with no host sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class RLModuleSpec:
    """Reference: rllib RLModuleSpec (catalog-free minimal form)."""
    observation_dim: int
    num_actions: int
    hidden: Tuple[int, ...] = (64, 64)


def _init_mlp(gen: torch.Generator, dims: Sequence[int]) -> Params:
    """``w{i}`` ~ N(0, 2 / fan_in) and ``b{i}`` = 0, fp32, on the
    generator's device (``ray_tpu/rl/rl_module.py:_init_mlp``)."""
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = torch.randn(a, b, generator=gen,
                                      device=gen.device) * (2.0 / a) ** 0.5
        params[f"b{i}"] = torch.zeros(b, device=gen.device)
    return params


def _mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    n = len(params) // 2
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = torch.tanh(x)
    return x


def categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Samples of ``softmax(logits)`` over the last axis by Gumbel-max:
    argmax(logits - log E), E ~ Exp(1).  Stays on the device."""
    e = torch.empty_like(logits, dtype=torch.float32).exponential_(
        generator=gen)
    return torch.argmax(logits - torch.log(e), dim=-1)


def take(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(logp_all, actions[..., None], -1)[..., 0]``."""
    return torch.take_along_dim(logp_all, actions.long()[..., None],
                                dim=-1)[..., 0]


class DiscretePolicyModule:
    """Separate policy and value MLP towers for discrete action spaces
    (the PPO default; reference: rllib DefaultPPORLModule)."""

    def __init__(self, spec: RLModuleSpec):
        self.spec = spec

    def init(self, gen: torch.Generator) -> Params:
        dims_p = [self.spec.observation_dim, *self.spec.hidden,
                  self.spec.num_actions]
        dims_v = [self.spec.observation_dim, *self.spec.hidden, 1]
        return {"pi": _init_mlp(gen, dims_p), "vf": _init_mlp(gen, dims_v)}

    def forward_train(self, params: Params, obs: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        logits = _mlp(params["pi"], obs)
        value = _mlp(params["vf"], obs)[..., 0]
        return {"action_logits": logits, "value": value}

    def forward_inference(self, params: Params,
                          obs: torch.Tensor) -> torch.Tensor:
        """Greedy actions."""
        return torch.argmax(_mlp(params["pi"], obs), dim=-1)

    def forward_exploration(self, params: Params, obs: torch.Tensor,
                            gen: torch.Generator
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """Sampled actions + their log-probs + value estimates."""
        out = self.forward_train(params, obs)
        logits = out["action_logits"]
        actions = categorical(logits, gen)
        return actions, take(torch.log_softmax(logits, -1), actions), \
            out["value"]


@dataclass(frozen=True)
class ContinuousModuleSpec:
    """Spec for continuous-action modules (reference: rllib catalog for
    Box action spaces)."""
    observation_dim: int
    action_dim: int
    action_low: float = -1.0
    action_high: float = 1.0
    hidden: Tuple[int, ...] = (64, 64)


LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0


class GaussianPolicyModule:
    """Tanh-squashed diagonal Gaussian policy for continuous control
    (reference: rllib DefaultSACRLModule's squashed-Gaussian action dist).

    ``sample`` returns (action, log_prob) with the tanh change-of-variables
    correction; actions are affinely mapped to [low, high].
    """

    def __init__(self, spec: ContinuousModuleSpec):
        self.spec = spec
        self._scale = (spec.action_high - spec.action_low) / 2.0
        self._mid = (spec.action_high + spec.action_low) / 2.0

    def init(self, gen: torch.Generator) -> Params:
        dims = [self.spec.observation_dim, *self.spec.hidden,
                2 * self.spec.action_dim]
        return {"pi": _init_mlp(gen, dims)}

    def _dist(self, params: Params, obs: torch.Tensor):
        mean, log_std = torch.chunk(_mlp(params["pi"], obs), 2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def sample(self, params: Params, obs: torch.Tensor,
               gen: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None):
        """``eps`` (the standard-normal draws, shaped like the mean) is
        drawn from ``gen`` unless given."""
        mean, log_std = self._dist(params, obs)
        if eps is None:
            eps = torch.randn(mean.shape, generator=gen, device=mean.device)
        pre_tanh = mean + torch.exp(log_std) * eps
        # log N(x; mean, std) summed over action dims
        logp = torch.sum(-0.5 * (eps ** 2 + 2 * log_std
                                 + math.log(2 * math.pi)), dim=-1)
        # tanh squash correction: log det |d tanh / dx| with the
        # numerically stable softplus form.
        logp = logp - torch.sum(
            2.0 * (math.log(2.0) - pre_tanh - F.softplus(-2 * pre_tanh)),
            dim=-1)
        action = self._mid + self._scale * torch.tanh(pre_tanh)
        # The affine rescale also shifts the density.
        logp = logp - self.spec.action_dim * math.log(self._scale)
        return action, logp

    def forward_inference(self, params: Params,
                          obs: torch.Tensor) -> torch.Tensor:
        mean, _ = self._dist(params, obs)
        return self._mid + self._scale * torch.tanh(mean)


class TwinQModule:
    """Two independent Q(s, a) towers (clipped double-Q, reference: rllib
    SAC's twin critic)."""

    def __init__(self, spec: ContinuousModuleSpec):
        self.spec = spec

    def init(self, gen: torch.Generator) -> Params:
        dims = [self.spec.observation_dim + self.spec.action_dim,
                *self.spec.hidden, 1]
        return {"q1": _init_mlp(gen, dims), "q2": _init_mlp(gen, dims)}

    def q_values(self, params: Params, obs: torch.Tensor,
                 actions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([obs, actions], dim=-1)
        return _mlp(params["q1"], x)[..., 0], _mlp(params["q2"], x)[..., 0]


class QModule:
    """Single Q-tower for value-based algorithms (reference: rllib
    DefaultDQNRLModule without dueling/distributional extras)."""

    def __init__(self, spec: RLModuleSpec):
        self.spec = spec

    def init(self, gen: torch.Generator) -> Params:
        dims = [self.spec.observation_dim, *self.spec.hidden,
                self.spec.num_actions]
        return {"q": _init_mlp(gen, dims)}

    def q_values(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        return _mlp(params["q"], obs)

    def forward_inference(self, params: Params,
                          obs: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.q_values(params, obs), dim=-1)

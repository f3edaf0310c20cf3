"""Device-resident vectorized environments: thousands of env instances
stepped together on the card.

Counterpart of ``ray_tpu/rl/jax_env.py`` (``JaxCartPoleVector`` ->
``TorchCartPoleVector``).  The batched env state [N, 4] and the step
counters [N] live on the device; the dynamics are elementwise tensor ops
and done envs autoreset with ``torch.where`` masks, so a step is a fixed
set of kernel launches whatever N is.  ``rollout`` runs T steps of policy
forward + dynamics + autoreset with no host sync inside (JAX's
``lax.scan``, ``jax_env.py:62-85``): nothing comes back to the host until
the caller reads the stacked trajectory.

The dynamics are ``env.CartPole``'s in fp32 (the numpy env is float64):
one step from the same states agrees to rtol 1e-5, atol 1e-6; a long
rollout does not, since the dynamics are chaotic.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from .._device import DeviceLike, make_generator, resolve_device


class TorchCartPoleVector:
    """[N]-way cart-pole with device-side autoreset."""

    observation_dim = 4
    num_actions = 2

    def __init__(self, num_envs: int, max_steps: int = 500, seed: int = 0,
                 device: DeviceLike = None):
        self.num_envs = num_envs
        self.max_steps = max_steps
        self.device = resolve_device(device)
        self._gen = make_generator(self.device, seed)
        self.state: Optional[torch.Tensor] = None   # [N, 4]
        self.t: Optional[torch.Tensor] = None       # [N]

    def reset(self) -> torch.Tensor:
        self.state = _cartpole_reset(self._gen, self.num_envs)
        self.t = torch.zeros((self.num_envs,), dtype=torch.int32,
                             device=self.device)
        return self.state

    def step(self, actions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
        """actions [N] int -> (obs, reward, terminated, truncated), all
        [N].  Done envs are reset in the same step (autoreset), so the
        returned obs of a done env is its fresh episode start."""
        self.state, self.t, obs, reward, term, trunc = _cartpole_step(
            self.state, self.t, actions, self._gen, self.max_steps)
        return obs, reward, term, trunc

    @torch.no_grad()
    def rollout(self, policy_params, policy_apply: Callable, steps: int,
                gen: Optional[torch.Generator] = None):
        """Collect ``steps`` transitions for every env on the device.

        policy_apply(params, obs [N,4], gen) -> actions [N].
        Returns (obs [T,N,4], actions [T,N], rewards [T,N],
        terminated [T,N], truncated [T,N]), all on the device."""
        gen = self._gen if gen is None else gen
        if self.state is None:
            self.reset()
        n, dev = self.num_envs, self.device
        obs_buf = torch.empty((steps, n, 4), device=dev)
        act_buf = torch.empty((steps, n), dtype=torch.int64, device=dev)
        rew_buf = torch.empty((steps, n), device=dev)
        term_buf = torch.empty((steps, n), dtype=torch.bool, device=dev)
        trunc_buf = torch.empty((steps, n), dtype=torch.bool, device=dev)
        for i in range(steps):
            obs_buf[i] = self.state
            act_buf[i] = policy_apply(policy_params, self.state, gen)
            self.state, self.t, _obs, rew_buf[i], term_buf[i], \
                trunc_buf[i] = _cartpole_step(self.state, self.t,
                                              act_buf[i], gen,
                                              self.max_steps)
        return obs_buf, act_buf, rew_buf, term_buf, trunc_buf


def _cartpole_reset(gen: torch.Generator, n: int) -> torch.Tensor:
    """Uniform in [-0.05, 0.05)."""
    return torch.rand((n, 4), generator=gen, device=gen.device) * 0.1 - 0.05


def _cartpole_step(state: torch.Tensor, t: torch.Tensor,
                   actions: torch.Tensor, gen: torch.Generator,
                   max_steps: int):
    """Vectorized dynamics identical to env.CartPole.step."""
    x, x_dot, theta, theta_dot = state.unbind(1)
    force = torch.where(actions == 1, 10.0, -10.0)
    costh, sinth = torch.cos(theta), torch.sin(theta)
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
    new_state = torch.stack([x, x_dot, theta, theta_dot], dim=1)
    t = t + 1

    terminated = (torch.abs(x) > 2.4) | (torch.abs(theta)
                                         > 12 * math.pi / 180)
    truncated = (t >= max_steps) & ~terminated
    done = terminated | truncated
    reward = torch.ones_like(x)

    # Autoreset: done lanes restart with fresh initial states.
    fresh = _cartpole_reset(gen, state.shape[0])
    next_state = torch.where(done[:, None], fresh, new_state)
    t = torch.where(done, 0, t)
    return next_state, t, next_state, reward, terminated, truncated

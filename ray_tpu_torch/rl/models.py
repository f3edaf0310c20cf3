"""RL model zoo beyond MLPs: convolutional and recurrent policies.

Counterpart of ``ray_tpu/rl/models.py``, with its params trees unchanged:
the conv kernels stay ``HWIO`` (``conv{i}``, permuted to PyTorch's ``OIHW``
at use) and the observations NHWC, so JAX weights carry over 1:1 and the
flattened conv features come out in JAX's (H, W, C) order.

``padding="SAME"`` is XLA's: each spatial axis is padded by
``max((ceil(n / s) - 1) * s + k - n, 0)`` in all, ``total // 2`` before and
the rest after.  With stride 2 that is asymmetric (84 px, k 3: 0 before, 1
after), which ``F.conv2d(padding=1)`` is not, so the tower pads with
``F.pad`` first.

The GRU's ``forward_train`` is ``lax.scan`` over time as a loop over T, the
reset mask applied before each step; autograd through the loop gives JAX's
gradient.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .rl_module import categorical, take

Params = Dict[str, Any]


# --------------------------------------------------------------------- #
# CNN policy (pixel observations)
# --------------------------------------------------------------------- #

@dataclass
class CNNPolicySpec:
    obs_shape: Tuple[int, int, int]          # (H, W, C), NHWC
    num_actions: int
    channels: Sequence[int] = (16, 32)
    kernel: int = 3
    stride: int = 2
    hidden: int = 128


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class CNNPolicyModule:
    """Conv tower -> MLP head -> (logits, value) (reference analog: rllib
    VisionNetwork)."""

    def __init__(self, spec: CNNPolicySpec):
        self.spec = spec

    def init(self, gen: torch.Generator) -> Params:
        s = self.spec
        dev = gen.device
        params: Params = {}
        c_in = s.obs_shape[2]
        h, w = s.obs_shape[0], s.obs_shape[1]
        for i, c_out in enumerate(s.channels):
            fan_in = s.kernel * s.kernel * c_in
            params[f"conv{i}"] = torch.randn(
                (s.kernel, s.kernel, c_in, c_out), generator=gen,
                device=dev) * (2.0 / fan_in) ** 0.5
            c_in = c_out
            h = -(-h // s.stride)
            w = -(-w // s.stride)
        flat = h * w * c_in
        params["w_h"] = torch.randn((flat, s.hidden), generator=gen,
                                    device=dev) * (2.0 / flat) ** 0.5
        params["w_pi"] = torch.randn((s.hidden, s.num_actions),
                                     generator=gen, device=dev) * 0.01
        params["w_v"] = torch.randn((s.hidden, 1), generator=gen,
                                    device=dev) * 0.01
        return params

    def _tower(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        s = self.spec
        x = obs.to(torch.float32).permute(0, 3, 1, 2)        # NCHW
        for i in range(len(s.channels)):
            ph = same_padding(x.shape[2], s.kernel, s.stride)
            pw = same_padding(x.shape[3], s.kernel, s.stride)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            x = F.conv2d(x, params[f"conv{i}"].permute(3, 2, 0, 1),
                         stride=s.stride)
            x = torch.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # JAX's order
        return torch.relu(x @ params["w_h"])

    def forward_train(self, params: Params, obs: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        h = self._tower(params, obs)
        return {"action_logits": h @ params["w_pi"],
                "value": (h @ params["w_v"])[:, 0]}

    def forward_inference(self, params: Params,
                          obs: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.forward_train(params, obs)["action_logits"],
                            dim=-1)

    def forward_exploration(self, params: Params, obs: torch.Tensor,
                            gen: torch.Generator):
        out = self.forward_train(params, obs)
        logits = out["action_logits"]
        actions = categorical(logits, gen)
        return actions, take(torch.log_softmax(logits, -1), actions), \
            out["value"]


# --------------------------------------------------------------------- #
# Recurrent (GRU) policy
# --------------------------------------------------------------------- #

@dataclass
class RecurrentPolicySpec:
    obs_dim: int
    num_actions: int
    hidden: int = 64
    embed: Sequence[int] = field(default_factory=lambda: (64,))


class GRUPolicyModule:
    """Embedding MLP -> GRU core -> (logits, value) per step.

    ``forward_train`` consumes whole trajectories [B, T, obs];
    ``forward_step`` carries the state for env rollouts."""

    def __init__(self, spec: RecurrentPolicySpec):
        self.spec = spec

    def init(self, gen: torch.Generator) -> Params:
        s = self.spec
        dev = gen.device
        params: Params = {}
        d = s.obs_dim
        for i, width in enumerate(s.embed):
            params[f"emb{i}"] = torch.randn((d, width), generator=gen,
                                            device=dev) * (2.0 / d) ** 0.5
            d = width
        h = s.hidden
        # Fused GRU weights: [d, 3h] input and [h, 3h] recurrent
        # (reset | update | candidate).
        params["w_x"] = torch.randn((d, 3 * h), generator=gen,
                                    device=dev) * (1.0 / d) ** 0.5
        params["w_h"] = torch.randn((h, 3 * h), generator=gen,
                                    device=dev) * (1.0 / h) ** 0.5
        params["b"] = torch.zeros((3 * h,), device=dev)
        params["w_pi"] = torch.randn((h, s.num_actions), generator=gen,
                                     device=dev) * 0.01
        params["w_v"] = torch.zeros((h, 1), device=dev)
        return params

    def initial_state(self, batch: int) -> torch.Tensor:
        return torch.zeros((batch, self.spec.hidden))

    def _embed(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        x = obs.to(torch.float32)
        for i in range(len(self.spec.embed)):
            x = torch.relu(x @ params[f"emb{i}"])
        return x

    def _gates(self, params: Params, xg: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
        """One GRU step from the input projection ``xg = x @ w_x + b``."""
        n = self.spec.hidden
        rz = torch.sigmoid(xg[:, :2 * n] + h @ params["w_h"][:, :2 * n])
        r, z = rz[:, :n], rz[:, n:]
        cand = torch.tanh(xg[:, 2 * n:] + (r * h) @ params["w_h"][:, 2 * n:])
        return (1 - z) * h + z * cand

    def _cell(self, params: Params, x: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
        return self._gates(params, x @ params["w_x"] + params["b"], h)

    def forward_step(self, params: Params, obs: torch.Tensor,
                     state: torch.Tensor):
        """obs [B, obs_dim], state [B, H] -> (logits, value, state')."""
        h = self._cell(params, self._embed(params, obs), state)
        return h @ params["w_pi"], (h @ params["w_v"])[:, 0], h

    def forward_train(self, params: Params, obs_seq: torch.Tensor,
                      initial_state: torch.Tensor,
                      resets: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """obs_seq [B, T, obs_dim] -> {"action_logits" [B, T, A],
        "value" [B, T]}.  ``resets`` [B, T] bool zeroes the hidden state
        BEFORE consuming step t: training replays exactly the rollout's
        episode boundaries."""
        # The input projection of every step at once (the scan's body
        # computes the same per step).
        xg = self._embed(params, obs_seq) @ params["w_x"] + params["b"]
        h = initial_state.to(xg)
        hs = []
        for t in range(obs_seq.shape[1]):
            if resets is not None:
                h = torch.where(resets[:, t, None].bool(), 0.0, h)
            h = self._gates(params, xg[:, t], h)
            hs.append(h)
        hs = torch.stack(hs, dim=1)                       # [B, T, H]
        return {"action_logits": hs @ params["w_pi"],
                "value": (hs @ params["w_v"])[..., 0]}

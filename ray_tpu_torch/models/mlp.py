"""Small MLP for train-loop tests (counterpart of ray_tpu/models/mlp.py).

``init_mlp`` draws from a ``torch.Generator``, so its weights are not JAX's
(threefry); to feed both packages the same weights, carry JAX's through
numpy with ``models.convert.params_from_numpy``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from .._device import DeviceLike, resolve_device


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 32
    hidden: int = 64
    out_dim: int = 10
    layers: int = 2


def init_mlp(cfg: MLPConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Dict[str, Any]:
    """``w{i}`` ~ N(0, 1) / sqrt(fan_in) and ``b{i}`` = 0, fp32, on
    ``device`` (None: the generator's device, else the card)."""
    dev = generator.device if generator is not None and device is None \
        else resolve_device(device)
    params = {}
    dims = [cfg.in_dim] + [cfg.hidden] * (cfg.layers - 1) + [cfg.out_dim]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = torch.randn(a, b, generator=generator,
                                      device=dev) * (a ** -0.5)
        params[f"b{i}"] = torch.zeros(b, device=dev)
    return params


def mlp_forward(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    n = len(params) // 2
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def mlp_loss(params: Dict[str, Any],
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logp = torch.log_softmax(mlp_forward(params, batch["x"]), dim=-1)
    return -torch.mean(torch.take_along_dim(
        logp, batch["y"].long()[:, None], dim=-1))

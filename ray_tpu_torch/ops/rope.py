"""Rotary position embeddings (counterpart of ray_tpu/ops/rope.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns fp32 (cos, sin) tables of shape [max_seq_len, head_dim//2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate split halves of the channels.  x: [..., seq, head_dim].

    ``positions`` ([..., seq] int) selects rows of the tables; without it
    the first ``seq`` rows are used.
    """
    if positions is not None:
        cos = cos[positions]
        sin = sin[positions]
    else:
        cos = cos[: x.shape[-2]]
        sin = sin[: x.shape[-2]]
    # Broadcast tables over leading batch/head dims.
    while cos.dim() < x.dim():
        cos = cos[None]
        sin = sin[None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

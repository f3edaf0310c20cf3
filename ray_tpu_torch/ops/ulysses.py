"""Ulysses sequence parallelism: an all-to-all between the head and the
sequence split (counterpart of ray_tpu/ops/ulysses.py).

Each rank of the group holds a sequence block of every head.  One
``all_to_all_single`` turns that into the whole sequence of a share of the
heads, ``ops.attention.attention`` runs on it (the flash kernels on the
card, forward and backward), and a second all-to-all restores the sequence
split.  The all-to-all's backward is the inverse all-to-all.  JAX's local
function is its plain ``reference_attention``: the same function.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import attention


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of ``x``'s dim 0 to rank i; chunk i of the result from rank
    i (equal chunks)."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _SeqToHeads(torch.autograd.Function):
    """[B, h, S_l, D] split over the sequence -> [B, h/n, S, D] split over
    the heads; backward the inverse."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return _to_heads(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _to_seq(g, *ctx.args), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return _to_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _to_heads(g, *ctx.args), None, None


def _to_heads(x, group, n):
    B, h, Sl, D = x.shape
    parts = x.reshape(B, n, h // n, Sl, D).transpose(0, 1)
    got = _all_to_all(parts, group)            # [n (seq block), B, h/n, Sl, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, h // n, n * Sl, D)


def _to_seq(x, group, n):
    B, hn, S, D = x.shape
    parts = x.reshape(B, hn, n, S // n, D).permute(2, 0, 1, 3, 4)
    got = _all_to_all(parts, group)            # [n (head block), B, h/n, Sl, D]
    return got.transpose(0, 1).reshape(B, n * hn, S // n, D)


def ulysses_attention(q, k, v, *, group, causal: bool = True,
                      scale: Optional[float] = None,
                      impl: Optional[str] = None) -> torch.Tensor:
    """q/k/v: [B, H|Hkv, S_l, D], this rank's sequence block of ``group``
    (None or a group of one rank: ``attention`` on the block).  K/V heads
    are repeated to H where the group size does not divide Hkv; H must
    divide by it.  ``impl``: ``ops.attention.attention``'s."""
    import torch.distributed as dist
    n = 1 if group is None else dist.get_world_size(group)
    H, Hkv = q.shape[1], k.shape[1]
    if Hkv % n:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    if H % n:
        raise ValueError(f"heads {H} not divisible by axis size {n}")
    if n == 1:
        return attention(q, k, v, causal=causal, scale=scale, impl=impl)
    qh, kh, vh = (_SeqToHeads.apply(t, group, n) for t in (q, k, v))
    out = attention(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                    causal=causal, scale=scale, impl=impl)
    return _HeadsToSeq.apply(out, group, n)

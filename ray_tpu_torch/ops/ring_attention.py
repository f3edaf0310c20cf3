"""Ring attention: context parallelism over the sp group (counterpart of
ray_tpu/ops/ring_attention.py).

The sequence is split over the ranks of a process group, rank i holding
positions ``[i * S_l, (i + 1) * S_l)`` of q, k and v ([B, H|Hkv, S_l, D]).
K/V blocks travel one hop a step around the ring (``batch_isend_irecv``,
issued before the step's compute so the transfer overlaps it).  At step s a
rank holds the block of rank ``src = (i - s) mod n`` and runs the flash
forward (``ops.attention.flash_fwd`` with its LSE) of its query block on it:
causal on its own block, every key visible on an earlier one, nothing on a
later one (causal).  The partial outputs merge in fp32 by their LSE, so the
[S, S] score matrix never exists and a rank's memory is O(S / n).  JAX runs
the same online softmax over einsums in fp32; this is the same function,
the per-block work on the kernels.

The backward (``_Ring``, one ``autograd.Function`` around the whole ring)
runs a second ring: at each step ``ops.attention.flash_bwd`` of the query
block against the block held, with the *merged* output and LSE, so P =
exp(S - LSE) and delta = rowsum(dO * O) are the global ones.  dq
accumulates in place in fp32; the dk/dv accumulators travel with their K/V
block and are home after n hops.  GQA goes to the kernels as it is.

The per-step math (``_fwd_block``, ``_merge``, ``_bwd_block``) is apart from
the transport: ``ring_attention_local`` runs the n blocks of one sequence in
one process through the same steps (the card's smoke run holds it against
one flash call over the whole sequence).
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from .attention import flash_bwd, flash_fwd


def _visible(my: int, src: int, causal: bool) -> bool:
    return not causal or src <= my


def _fwd_block(q, k, v, my: int, src: int, causal: bool, scale: float):
    """The flash forward of query block ``my`` on key block ``src``: (out,
    fp32 LSE), or None where causal masking hides the whole block."""
    if not _visible(my, src, causal):
        return None
    return flash_fwd(q, k, v, causal=causal and src == my, scale=scale,
                     need_lse=True)


def _merge(acc: Optional[Tuple[torch.Tensor, torch.Tensor]], part):
    """Fold one block's (out, lse) into the running fp32 (out, lse)."""
    if part is None:
        return acc
    o, lse = part[0].float(), part[1]
    if acc is None:
        return o, lse
    o_acc, lse_acc = acc
    new = torch.logaddexp(lse_acc, lse)
    return (o_acc * torch.exp(lse_acc - new)[..., None]
            + o * torch.exp(lse - new)[..., None]), new


def _bwd_block(q, k, v, out, lse, dout, my: int, src: int, causal: bool,
               scale: float):
    """(dq, dk, dv) of query block ``my`` against key block ``src`` with
    the merged ``out`` and ``lse``, or None where the block is hidden."""
    if not _visible(my, src, causal):
        return None
    return flash_bwd(q, k, v, out, lse, dout, causal=causal and src == my,
                     scale=scale)


def _ring_fwd(q, blocks: Iterator[Sequence[torch.Tensor]], my: int, n: int,
              causal: bool, scale: float):
    acc = None
    for s, (k, v) in enumerate(blocks):
        acc = _merge(acc, _fwd_block(q, k, v, my, (my - s) % n, causal,
                                     scale))
    return acc[0].to(q.dtype), acc[1]


def _ring_peers(group) -> Tuple[int, int, int, int]:
    import torch.distributed as dist
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (my + 1) % n)
    prv = dist.get_global_rank(group, (my - 1) % n)
    return my, n, nxt, prv


def _shift(tensors: Sequence[torch.Tensor], nxt: int, prv: int, group):
    """Send ``tensors`` to the next rank and receive the previous rank's:
    (the receive buffers, the requests to wait on)."""
    import torch.distributed as dist
    bufs = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, b, prv, group) for b in bufs])
    return bufs, dist.batch_isend_irecv(ops)


def _p2p_blocks(tensors: Sequence[torch.Tensor], group, steps: int):
    """Yield the blocks held at steps 0 .. steps-1, each step's transfer of
    the next blocks issued before the current ones are handed out."""
    _my, _n, nxt, prv = _ring_peers(group)
    cur = list(tensors)
    for s in range(steps):
        pending = _shift(cur, nxt, prv, group) if s < steps - 1 else None
        yield cur
        if pending is not None:
            for req in pending[1]:
                req.wait()
            cur = pending[0]


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        my, n, _nxt, _prv = _ring_peers(group)
        out, lse = _ring_fwd(q, _p2p_blocks((k, v), group, n), my, n,
                             causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.args
        my, n, nxt, prv = _ring_peers(group)
        dout = dout.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        for s, (kc, vc) in enumerate(_p2p_blocks((k, v), group, n)):
            g = _bwd_block(q, kc, vc, out, lse, dout, my, (my - s) % n,
                           causal, scale)
            if g is not None:
                dq += g[0]
                dkv[0] += g[1]
                dkv[1] += g[2]
            # The accumulators follow their block one hop; after the n-th
            # they are home.
            dkv, reqs = _shift(dkv, nxt, prv, group)
            for req in reqs:
                req.wait()
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention(q, k, v, *, group, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a sequence split over ``group`` (a process group; None
    or a group of one rank: the flash kernels on the whole block).  q:
    [B, H, S_l, D], k/v: [B, Hkv, S_l, D], this rank's positions."""
    import torch.distributed as dist
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if group is None or dist.get_world_size(group) == 1:
        from .attention import flash_attention
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return _Ring.apply(q, k, v, group, causal, scale)


class _RingLocal(torch.autograd.Function):
    """The ring's steps over n blocks held by one process."""

    @staticmethod
    def forward(ctx, q, k, v, n, causal, scale):
        qs, ks, vs = (_blocks(t, n) for t in (q, k, v))
        outs, lses = [], []
        for my in range(n):
            o, lse = _ring_fwd(qs[my], ((ks[(my - s) % n], vs[(my - s) % n])
                                        for s in range(n)), my, n, causal,
                               scale)
            outs.append(o)
            lses.append(lse)
        ctx.save_for_backward(q, k, v, torch.cat(outs, 2),
                              torch.cat(lses, 2))
        ctx.args = (n, causal, scale)
        return torch.cat(outs, 2)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        n, causal, scale = ctx.args
        qs, ks, vs, os_, dos = (_blocks(t, n) for t in (q, k, v, out, dout))
        lses = [t.contiguous() for t in lse.chunk(n, 2)]
        dq = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in qs]
        dk = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in ks]
        dv = [torch.zeros_like(t) for t in dk]
        for my in range(n):
            for s in range(n):
                src = (my - s) % n
                g = _bwd_block(qs[my], ks[src], vs[src], os_[my], lses[my],
                               dos[my], my, src, causal, scale)
                if g is not None:
                    dq[my] += g[0]
                    dk[src] += g[1]
                    dv[src] += g[2]
        return (torch.cat(dq, 2).to(q.dtype), torch.cat(dk, 2).to(k.dtype),
                torch.cat(dv, 2).to(v.dtype), None, None, None)


def _blocks(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    return [b.contiguous() for b in t.chunk(n, 2)]


def ring_attention_local(q, k, v, n: int, *, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over ``n`` sequence blocks of q/k/v ([B, H|Hkv, S,
    D], S divisible by n) in this process: the ring's per-step kernel calls
    and merges with no transport, forward and (under autograd) backward."""
    if q.shape[2] % n or k.shape[2] != q.shape[2]:
        raise ValueError(f"sequence {q.shape[2]} (keys {k.shape[2]}) does "
                         f"not split into {n} blocks")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _RingLocal.apply(q, k, v, n, causal, scale)

"""Mixture-of-experts: top-k routing and capacity dispatch (counterpart of
ray_tpu/ops/moe.py).

- ``top_k_routing``: fp32 router logits, softmax, the top k experts of each
  token with their weights renormalised to sum to one.
- ``load_balancing_loss``: the Switch transformer's auxiliary loss,
  ``X * sum(mean(probs) * mean(assigned))``.
- ``capacity_dispatch`` (GShard's one-hot ``[T, X, C]`` tensors) and
  ``sorted_dispatch`` (a stable argsort of the assignments by expert, each
  assignment's slot its place in its expert's segment, slots past the
  capacity dropped): the JAX package's two dispatch plans, kept for parity.
- ``moe_layer``: SwiGLU experts over ``[X, C, E]`` slot buffers.  A token
  reaches its slots and comes back from them by gathers alone, forward and
  backward (``_Dispatch``, ``_Combine``): every slot holds at most one
  assignment and every token has exactly k, so no step sums into a shared
  row by atomics and a step on the card gives the same bits each time.  The
  k outputs of a token are summed in a fixed order.

Sharded (``MoEParallel``): the routing runs on the rank's own tokens, and
each rank gathers every token-holding rank's expert indices (int32), so the
capacity and which assignments drop are those of the whole batch, as in
JAX, where ``moe_layer`` sees the logically global ``[B, S, E]``.  A rank
computes only its own tokens' kept assignments, on its own experts (the ep
shard); the ep ranks' partial outputs are summed by the caller.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class RoutingInfo(NamedTuple):
    combine_weights: torch.Tensor  # [B, S, X] softmax weights, zero off top-k
    router_probs: torch.Tensor     # [B, S, X] full softmax (for aux loss)
    expert_index: torch.Tensor     # [B, S, k]


def _routing(x, router_w, k, router_noise, generator):
    """(RoutingInfo, the top-k weights [B, S, k])."""
    logits = torch.einsum("bse,ex->bsx", x.float(), router_w.float())
    if router_noise > 0.0 and generator is not None:
        logits = logits + router_noise * torch.randn(
            logits.shape, generator=generator, device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = probs.topk(k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)
    combine = torch.zeros_like(probs).scatter(-1, topi, topv)
    return RoutingInfo(combine, probs, topi), topv


def top_k_routing(x, router_w, k: int = 2, router_noise: float = 0.0,
                  generator: Optional[torch.Generator] = None
                  ) -> RoutingInfo:
    """x: [B, S, E]; router_w: [E, X] -> routing info (fp32)."""
    return _routing(x, router_w, k, router_noise, generator)[0]


def load_balancing_loss(info: RoutingInfo, num_experts: int) -> torch.Tensor:
    """Switch-transformer style aux loss."""
    me = info.router_probs.mean(dim=(0, 1))
    ce = (info.combine_weights > 0).float().mean(dim=(0, 1))
    return num_experts * (me * ce).sum()


def capacity_dispatch(info: RoutingInfo, num_experts: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style dispatch/combine tensors with capacity dropping:
    (dispatch [T, X, C] one-hot fp32, combine [T, X, C]) over T = B * S,
    slots given in token order, expert choice j before j + 1."""
    B, S, X = info.combine_weights.shape
    k = info.expert_index.shape[-1]
    idx = info.expert_index.reshape(B * S, k)
    weights = info.combine_weights.reshape(B * S, X)
    dev = weights.device
    counts = torch.zeros(X, dtype=torch.long, device=dev)
    dispatch = torch.zeros((B * S, X, capacity), device=dev)
    combine = torch.zeros((B * S, X, capacity), device=dev)
    for j in range(k):
        oh = F.one_hot(idx[:, j], X)                           # [T, X]
        pos = oh.cumsum(0) - 1 + counts[None, :]
        keep = (pos < capacity) & (oh > 0)
        counts = counts + (oh * keep).sum(0)
        slot = F.one_hot(pos.clamp(0, capacity - 1), capacity).float()
        d_j = slot * keep[..., None].float()
        dispatch = dispatch + d_j
        w_j = weights.gather(-1, idx[:, j:j + 1])
        combine = combine + d_j * w_j[..., None]
    return dispatch, combine


def _slots(expert_index: torch.Tensor, num_experts: int, capacity: int):
    """Sorted dispatch's index arrays over the N = T * k assignments of
    ``expert_index`` [..., k], in expert-sorted order: (order, e_s,
    slot_s, keep), ``slot_s`` equal to ``capacity`` where dropped."""
    e_flat = expert_index.reshape(-1)
    N = e_flat.numel()
    order = torch.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    counts = torch.bincount(e_flat, minlength=num_experts)
    starts = counts.cumsum(0) - counts
    slot_s = torch.arange(N, device=e_flat.device) - starts[e_s]
    keep = slot_s < capacity
    return order, e_s, torch.where(keep, slot_s, capacity), keep


def sorted_dispatch(info: RoutingInfo, num_experts: int, capacity: int):
    """Sort-based token routing (the JAX package's default plan).

    Returns (tok_s [N], e_s [N], slot_s [N], w_s [N], keep [N]) over the
    N = T * k assignments in expert-sorted order; ``slot_s`` equals
    ``capacity`` for dropped assignments."""
    B, S, X = info.combine_weights.shape
    k = info.expert_index.shape[-1]
    T = B * S
    order, e_s, slot_s, keep = _slots(info.expert_index, num_experts,
                                      capacity)
    w_flat = info.combine_weights.reshape(T, X).gather(
        -1, info.expert_index.reshape(T, k)).reshape(T * k)
    return order // k, e_s, slot_s, w_flat[order], keep


def capacity(tokens: int, k: int, capacity_factor: float,
             num_experts: int) -> int:
    """Slots an expert holds: ceil(k * tokens * capacity_factor / X)."""
    return max(int(math.ceil(k * tokens * capacity_factor / num_experts)),
               1)


class _Dispatch(torch.autograd.Function):
    """x [T, E] -> slot buffer [R, E]: row r holds the token ``src[r]``
    (T: an empty slot, zeros).  Backward: each token sums the gradients of
    its k slots (``row`` [T, k], R where dropped) in a fixed order."""

    @staticmethod
    def forward(ctx, x, src, row):
        ctx.save_for_backward(row)
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[src]

    @staticmethod
    def backward(ctx, g):
        (row,) = ctx.saved_tensors
        return torch.cat([g, g.new_zeros(1, g.shape[1])])[row].sum(1), \
            None, None


class _Combine(torch.autograd.Function):
    """Slot outputs y [R, E] -> tokens [T, E]: out[t] = sum_j w[t, j] *
    y[row[t, j]] (zeros where dropped, row R), the k terms in a fixed
    order.  Backward: slot r takes its one assignment's weighted gradient
    (``asgn`` [R]: the assignment t * k + j it holds, T * k if empty)."""

    @staticmethod
    def forward(ctx, y, w, row, asgn):
        ctx.save_for_backward(y, w, row, asgn)
        ya = torch.cat([y, y.new_zeros(1, y.shape[1])])[row]   # [T, k, E]
        return (ya * w[..., None].to(y.dtype)).sum(1)

    @staticmethod
    def backward(ctx, g):
        y, w, row, asgn = ctx.saved_tensors
        T, k = row.shape
        ya = torch.cat([y, y.new_zeros(1, y.shape[1])])[row]
        dw = (ya.float() * g.float()[:, None, :]).sum(-1)
        ga = (g[:, None, :] * w[..., None].to(g.dtype)).reshape(T * k, -1)
        dy = torch.cat([ga, ga.new_zeros(1, ga.shape[1])])[asgn]
        return dy, dw, None, None


@dataclass
class MoEParallel:
    """How a sharded step splits one MoE layer (see the module docstring).

    ``token_group``/``token_ranks``: the process group of the ranks that
    hold different tokens (dp, fsdp, sp) and its size.  ``gather_index``:
    this rank's ``[b, s, k]`` expert indices -> the whole batch's
    ``[B, S, k]``; ``local_slots``: a whole-batch ``[B, S, k]`` array ->
    this rank's ``[b, s, k]``.  ``experts``: (first, count) of the experts
    this rank holds (None: all).  ``partial_grad``: applied to the
    experts' input and to the combine weights, whose gradients from this
    rank are partial where the experts' outputs are (tp, ep): it sums
    them."""
    token_group: Any = None
    token_ranks: int = 1
    gather_index: Optional[Callable] = None
    local_slots: Optional[Callable] = None
    experts: Optional[Tuple[int, int]] = None
    partial_grad: Optional[Callable] = None


def _swiglu(xe, w_gate, w_up, w_down, eq_in, eq_out):
    gate = torch.einsum(eq_in, xe, w_gate)
    up = torch.einsum(eq_in, xe, w_up)
    return torch.einsum(eq_out, F.silu(gate) * up, w_down)


def moe_layer(x, router_w, w_gate, w_up, w_down, k: int = 2,
              generator: Optional[torch.Generator] = None,
              router_noise: float = 0.0, capacity_factor: float = 1.25,
              parallel: Optional[MoEParallel] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SwiGLU expert MLPs with top-k routing.

    x: [B, S, E]; router_w: [E, X]; w_gate/w_up: [X, E, M]; w_down:
    [X, M, E].  Returns (output [B, S, E] in x's dtype, aux loss fp32).

    ``capacity_factor`` > 0: sorted capacity dispatch, each expert taking
    at most ``capacity(T, k, capacity_factor, X)`` slots over [X, C, E]
    buffers, the assignments past it dropped (their output is zero: the
    residual stream carries them).  0: dense dispatch, every expert on every
    token, weighted by the combine matrix.

    ``parallel`` (a sharded step's, see ``MoEParallel``): x is this rank's
    tokens, the expert weights its experts' shard; capacity and drops are
    the whole batch's, the output is this rank's experts' share (summed
    over ep by the caller) and the aux loss this rank's share of the whole
    batch's (``X * sum(mean(probs) * mean(assigned))`` over every token:
    the ranks' shares sum to it)."""
    X = router_w.shape[-1]
    info, topv = _routing(x, router_w, k, router_noise, generator)
    par = parallel or MoEParallel()
    e0, n_local = par.experts or (0, X)
    partial_grad = par.partial_grad or (lambda t: t)
    B, S, E = x.shape
    T = B * S
    if capacity_factor and capacity_factor > 0.0:
        idx = info.expert_index
        if par.gather_index is not None:
            idx = par.gather_index(idx)
        C = capacity(idx.shape[0] * idx.shape[1], k, capacity_factor, X)
        order, _e_s, slot_s, _keep = _slots(idx, X, C)
        # Each assignment's slot, back in token order, then this rank's.
        slot = torch.empty_like(slot_s)
        slot[order] = slot_s
        slot = slot.reshape(idx.shape)
        if par.local_slots is not None:
            slot = par.local_slots(slot)
        slot = slot.reshape(T, k)
        e = info.expert_index.reshape(T, k)
        R = n_local * C
        mine = (slot < C) & (e >= e0) & (e < e0 + n_local)
        row = torch.where(mine, (e - e0) * C + slot, R)          # [T, k]
        # The inverse map: the assignment each slot row holds.
        asgn = torch.full((R + 1,), T * k, dtype=torch.long, device=x.device)
        asgn[row.reshape(-1)] = torch.arange(T * k, device=x.device)
        asgn = asgn[:R]
        src = torch.where(asgn < T * k, asgn // k, T)
        xe = _Dispatch.apply(partial_grad(x).reshape(T, E), src, row)
        y = _swiglu(xe.reshape(n_local, C, E), w_gate, w_up, w_down,
                    "xce,xem->xcm", "xcm,xme->xce")
        out = _Combine.apply(y.reshape(R, E), partial_grad(topv).reshape(
            T, k), row, asgn)
        out = out.reshape(B, S, E)
    else:
        comb = partial_grad(info.combine_weights)[..., e0:e0 + n_local]
        y = _swiglu(partial_grad(x), w_gate, w_up, w_down, "bse,xem->bsxm",
                    "bsxm,xme->bsxe")
        out = torch.einsum("bsxe,bsx->bse", y, comb.to(y.dtype))
    return out.to(x.dtype), _aux(info, X, par)


def _aux(info: RoutingInfo, X: int, par: MoEParallel) -> torch.Tensor:
    """load_balancing_loss, or under a token group this rank's share of the
    whole batch's: X * sum(me_local * ce_global) / ranks, since me's mean
    over the ranks is the batch's and ce carries no gradient."""
    if par.token_ranks == 1:
        return load_balancing_loss(info, X)
    import torch.distributed as dist
    me = info.router_probs.mean(dim=(0, 1))
    ce = (info.combine_weights > 0).float().mean(dim=(0, 1))
    dist.all_reduce(ce, group=par.token_group)
    ce = ce / par.token_ranks
    return X * (me * ce).sum() / par.token_ranks

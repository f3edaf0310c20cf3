"""Microbatched pipeline parallelism over the pp group (counterpart of
ray_tpu/parallel/pipeline.py).

The stacked transformer blocks are split over the pp ranks on the layer
axis, each rank holding its stage's L/pp layers.  ``pipeline_blocks`` runs
them on a GPipe schedule, written by hand over ``torch.distributed``
point-to-point calls:

- forward: stage 0 takes microbatch m of the input, every other stage
  receives it from the stage before; each stage runs its layers and sends
  the result on (``send``/``recv``); M microbatches go through in order,
  each stage keeping its inputs and outputs for the backward;
- the last stage's output reaches every pp rank (a broadcast: JAX's
  psum of the last stage's masked output), so the replicated final norm,
  lm_head and loss run on every rank, as in JAX;
- backward (``_Pipeline``, one ``autograd.Function``): the microbatches in
  reverse, the last stage starting from its own output gradient (the
  broadcast's adjoint), each stage taking its layers' gradients and
  sending the input's gradient to the stage before; stage 0's input
  gradient is broadcast back to every pp rank, so the embedding, which JAX
  replicates over pp, gets the same gradient everywhere.

A pipeline of pp stages is busy M / (M + pp - 1) of the time, as JAX's.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def _peers(group):
    import torch.distributed as dist
    n = dist.get_world_size(group)
    stage = dist.get_rank(group)
    glob = [dist.get_global_rank(group, i) for i in range(n)]
    return stage, n, glob


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, body, M, group, graph, names, *leaves):
        import torch.distributed as dist
        stage, n, glob = _peers(group)
        params = {nm: t.detach().requires_grad_(t.requires_grad)
                  for nm, t in zip(names, leaves)}
        mb_shape = (x.shape[0] // M,) + tuple(x.shape[1:])
        inputs, outputs = [], []
        with torch.set_grad_enabled(graph):
            for m, xm in enumerate(x.chunk(M)):
                if stage == 0:
                    inp = xm.detach().requires_grad_(x.requires_grad)
                else:
                    inp = torch.empty(mb_shape, dtype=x.dtype,
                                      device=x.device)
                    dist.recv(inp, glob[stage - 1], group)
                    inp.requires_grad_(True)
                y = body(params, inp)
                if stage < n - 1:
                    dist.send(y.detach().contiguous(), glob[stage + 1], group)
                inputs.append(inp)
                outputs.append(y)
        out = (torch.cat([y.detach() for y in outputs])
               if stage == n - 1 else torch.empty_like(x))
        dist.broadcast(out, glob[n - 1], group)
        ctx.graph = (inputs, outputs, params, names) if graph else None
        ctx.args = (M, group, x.requires_grad)
        return out

    @staticmethod
    def backward(ctx, dout):
        import torch.distributed as dist
        inputs, outputs, params, names = ctx.graph
        M, group, x_grad = ctx.args
        del ctx.graph
        stage, n, glob = _peers(group)
        wrt = [params[nm] for nm in names if params[nm].requires_grad]
        sums: List[torch.Tensor] = [None] * len(wrt)
        dx: List[torch.Tensor] = [None] * M
        d_last = dout.chunk(M) if stage == n - 1 else None
        for m in reversed(range(M)):
            y = outputs[m]
            if stage == n - 1:
                dy = d_last[m].contiguous()
            else:
                dy = torch.empty_like(y)
                dist.recv(dy, glob[stage + 1], group)
            need_in = stage > 0 or x_grad
            got = torch.autograd.grad(
                y, ([inputs[m]] if need_in else []) + wrt, dy,
                allow_unused=True)
            if need_in:
                d_in, got = got[0], got[1:]
                if stage > 0:
                    dist.send(d_in.contiguous(), glob[stage - 1], group)
                else:
                    dx[m] = d_in
            for i, g in enumerate(got):
                if g is not None:
                    sums[i] = g if sums[i] is None else sums[i] + g
            outputs[m] = inputs[m] = None
        grad_x = None
        if x_grad:
            grad_x = (torch.cat(dx) if stage == 0
                      else torch.empty(dout.shape, dtype=dout.dtype,
                                       device=dout.device))
            dist.broadcast(grad_x, glob[0], group)
        it = iter(sums)
        grads = [next(it) if params[nm].requires_grad else None
                 for nm in names]
        return (grad_x, None, None, None, None, None, *grads)


def pipeline_blocks(stage_params: Dict[str, torch.Tensor], x: torch.Tensor,
                    stage_body: Callable, *, num_microbatches: int,
                    group) -> torch.Tensor:
    """Run stacked transformer blocks as a microbatched pipeline.

    stage_params: this stage's blocks (each leaf [L/pp, ...]); x: [B, S, E]
    activations, the same on every pp rank; B must divide by
    ``num_microbatches``.  stage_body(stage_params, h) -> h applies one
    stage's layers.  ``group``: the pp process group, stage i its rank i.
    Returns [B, S, E], the same on every pp rank."""
    M = num_microbatches
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by microbatches "
                         f"{M}")
    names = sorted(stage_params)
    leaves = [stage_params[nm] for nm in names]
    # Keep each microbatch's graph only where a backward can follow.
    graph = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x] + leaves)
    return _Pipeline.apply(x, stage_body, M, group, graph, tuple(names),
                           *leaves)

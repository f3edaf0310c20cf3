"""Llama-family decoder-only transformer (counterpart of
ray_tpu/models/llama.py).

Parameters are a plain dict in the JAX package's layout: layers stacked on a
leading ``[L, ...]`` axis, projections as ``wq [L, E, H, D]`` and friends, so
``models.convert.params_from_numpy`` carries a JAX pytree over with no
transposes.  Activations run in ``cfg.dtype`` with weights cast at each use,
as the JAX code does; logits are fp32.

Attention dispatches to ``ops.attention``: the CUDA flash kernels on the card
(``attention_impl`` "auto" or "flash"; forward and, under autograd, the flash
backward), the plain version for "reference"; "ring" and "ulysses" run
``ops.ring_attention``/``ops.ulysses`` over a sharded step's sp group (on
one rank: the flash kernels).  Blocks with ``num_experts`` > 0 run
``ops.moe.moe_layer`` and add its load-balancing loss.  ``loss_fn`` is the
training objective, with the JAX package's remat modes as
``torch.utils.checkpoint``; ``pp_microbatches`` runs the blocks through
``parallel.pipeline`` over a sharded step's pp group.

A sharded step (``parallel.spmd``) hands the model its process groups
through ``parallel_groups``; without one, everything runs on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import DeviceLike, resolve_device
from ..ops.attention import _HEAD_DIMS as KERNEL_HEAD_DIMS
from ..ops.attention import attention as _attention
from ..ops.attention import flash_attention, reference_attention
from ..ops.moe import MoEParallel, moe_layer
from ..ops.norms import rms_norm
from ..ops.ring_attention import ring_attention
from ..ops.rope import apply_rope, rope_frequencies
from ..ops.ulysses import ulysses_attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 32
    head_dim: int = 128
    mlp_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # MoE: 0 experts = dense model.
    num_experts: int = 0
    moe_top_k: int = 2
    # 0 = dense (masked) dispatch; > 0 = capacity-based sorted dispatch
    # with this capacity factor (see ops/moe.py).
    moe_capacity_factor: float = 1.25
    # "auto"/"flash"/"flash_interpret" (the flash kernels on the card, their
    # plain versions on CPU tensors), "reference" (plain), "ring"/"ulysses"
    # (sequence-parallel attention over the sp group, the flash kernels on
    # each block).
    attention_impl: str = "auto"
    seq_axis: str = "sp"
    # False | True/"full" | "mlp_only" | "dots" | "dots_nobatch" (see
    # _block_fn).
    remat: Any = True
    # Pipeline parallelism: number of microbatches (0 = off).
    pp_microbatches: int = 0
    loss_chunks: int = 0

    def replace(self, **kw) -> "LlamaConfig":
        return dataclasses.replace(self, **kw)


def llama_tiny() -> LlamaConfig:
    return LlamaConfig(vocab_size=512, hidden=128, layers=2, heads=4,
                       kv_heads=2, head_dim=32, mlp_dim=256, max_seq_len=256)


def llama_125m() -> LlamaConfig:
    return LlamaConfig(vocab_size=32000, hidden=768, layers=12, heads=12,
                       kv_heads=12, head_dim=64, mlp_dim=2048,
                       max_seq_len=2048)


def llama_1b() -> LlamaConfig:
    return LlamaConfig(vocab_size=32000, hidden=2048, layers=16, heads=16,
                       kv_heads=8, head_dim=128, mlp_dim=5504,
                       max_seq_len=2048)


def llama_7b() -> LlamaConfig:
    return LlamaConfig()  # defaults are 7B


def check_supported(cfg: LlamaConfig) -> None:
    """Raise for a config the JAX model refuses before it runs."""
    if cfg.attention_impl not in _ATTENTION_IMPLS:
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


_ATTENTION_IMPLS = ("auto", "flash", "flash_interpret", "reference", "ring",
                    "ulysses")


def check_device_supported(cfg: LlamaConfig, device: torch.device) -> None:
    """Raise, when an engine or a training step is built, for a config the
    card's kernels do not take: on a CUDA device every attention_impl but
    "reference" runs the flash and paged kernels, which take head_dim 32,
    64 and 128 (the JAX package runs any head_dim, off the TPU through its
    plain attention)."""
    if device.type != "cuda" or cfg.attention_impl == "reference":
        return
    if cfg.head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"head_dim={cfg.head_dim}: the card's attention kernels take "
            f"head_dim in {KERNEL_HEAD_DIMS}; use attention_impl="
            f"\"reference\" (plain attention) for this config on the card")


def attention_impl(cfg: LlamaConfig) -> Optional[str]:
    """The ``ops.attention`` impl for ``cfg``: None (kernel; also for
    "ring"/"ulysses", whose blocks run the kernels) or "reference" (plain
    version).  "flash_interpret" is the kernel path, as
    in JAX, where it runs the Pallas kernels' bodies on the CPU: here the
    kernels' plain versions run on CPU tensors and the kernels on CUDA
    ones."""
    return "reference" if cfg.attention_impl == "reference" else None


def param_logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Tree (matching init_params) of logical axis tuples: the names
    ``parallel.sharding``'s rules map onto mesh axes."""
    block: Dict[str, Any] = {
        "attn_norm": ("layers", None),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "mlp_norm": ("layers", None),
    }
    if cfg.num_experts:
        block.update({
            "router": ("layers", "embed", None),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        })
    else:
        block.update({
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        })
    return {
        "embed": ("vocab", "embed"),
        "blocks": block,
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


@dataclass(frozen=True)
class ParallelGroups:
    """The process groups a sharded step runs the model over (None: that
    axis has one rank).

    ``tp``: Megatron blocks, each rank holding its heads' share of
    wq/wk/wv/wo and its mlp columns' share of w_gate/w_up/w_down (of every
    expert's); each branch's input sums its gradient over the group in the
    backward, its output sums over the group in the forward.  ``ep``: each
    rank holds its share of the experts; their outputs sum over the group
    as tp's do.  ``sp``: the sequence is split over the group (ring,
    Ulysses, or K/V gathered for the other attention impls).  ``pp``: the
    blocks are split over the group on the layer axis
    (``parallel.pipeline``).  ``moe``: ``ops.moe.MoEParallel`` for routing
    over the whole batch."""
    tp: Any = None
    ep: Any = None
    sp: Any = None
    pp: Any = None
    moe: Optional[MoEParallel] = None


_GROUPS = ParallelGroups()


@contextlib.contextmanager
def parallel_groups(groups: ParallelGroups):
    """Run the model over ``groups`` inside this context."""
    global _GROUPS
    old, _GROUPS = _GROUPS, groups
    try:
        yield
    finally:
        _GROUPS = old


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the groups."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class _Sum(torch.autograd.Function):
    """Sum over the groups in the forward; identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist
        y = x.contiguous().clone()
        for group in groups:
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_grad(h: torch.Tensor, *groups) -> torch.Tensor:
    groups = tuple(g for g in groups if g is not None)
    return _SumGrad.apply(h, groups) if groups else h


def _sum(y: torch.Tensor, *groups) -> torch.Tensor:
    groups = tuple(g for g in groups if g is not None)
    return _Sum.apply(y, groups) if groups else y


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                param_dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes and scale: a standard
    normal truncated to [-2, 2], times 1/sqrt(fan_in); norms are ones.
    ``generator`` must live on ``device``.  (The numbers differ from
    ``jax.random``'s; parity tests carry JAX's weights over instead.)"""
    check_supported(cfg)
    dev = resolve_device(device)
    L, E, H, Hkv, D, M = (cfg.layers, cfg.hidden, cfg.heads, cfg.kv_heads,
                          cfg.head_dim, cfg.mlp_dim)

    def trunc(shape, fan_in):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return t.mul_(1.0 / math.sqrt(fan_in)).to(param_dtype)

    def ones(shape):
        return torch.ones(shape, dtype=param_dtype, device=dev)

    blocks = {
        "attn_norm": ones((L, E)),
        "wq": trunc((L, E, H, D), E),
        "wk": trunc((L, E, Hkv, D), E),
        "wv": trunc((L, E, Hkv, D), E),
        "wo": trunc((L, H, D, E), H * D),
        "mlp_norm": ones((L, E)),
    }
    if cfg.num_experts:
        X = cfg.num_experts
        blocks.update({
            "router": trunc((L, E, X), E),
            "w_gate": trunc((L, X, E, M), E),
            "w_up": trunc((L, X, E, M), E),
            "w_down": trunc((L, X, M, E), M),
        })
    else:
        blocks.update({
            "w_gate": trunc((L, E, M), E),
            "w_up": trunc((L, E, M), E),
            "w_down": trunc((L, M, E), M),
        })
    return {
        "embed": trunc((cfg.vocab_size, E), E),
        "blocks": blocks,
        "final_norm": ones((E,)),
        "lm_head": trunc((E, cfg.vocab_size), E),
    }


def layers(params: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every layer's parameters (views of the stacked block tensors), from
    one ``unbind(0)`` per stacked tensor.  Under autograd its backward is a
    single ``stack`` (the counterpart of the gradient of JAX's
    ``lax.scan``); per-layer ``select`` views would each add a zero tensor
    the size of the whole stack."""
    blocks = params["blocks"]
    names = list(blocks)
    return [dict(zip(names, per))
            for per in zip(*(blocks[n].unbind(0) for n in names))]


class _MmF32(torch.autograd.Function):
    """bf16 x [N, E] @ bf16 w [E, V] with an fp32 result on the card
    (``torch.mm(..., out_dtype=torch.float32)``, which has no derivative of
    its own).  The backward is the two products with the incoming fp32
    gradient rounded to w's dtype, as a bf16 matrix unit takes it, so the
    weight is never copied to fp32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)
        dx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return dx, dw


def logits_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., E] @ w [E, V] accumulated and returned in fp32, without
    casting ``w``.  On the card a bf16 ``w`` multiplies in bf16 with an fp32
    result (``torch.mm(..., out_dtype=torch.float32)``), so neither a 4-byte
    copy of the largest matrix nor bf16 rounding of the logits happens.  On
    the CPU both sides are cast to fp32 first: the same function, since bf16
    values are exact in fp32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if w.dtype == torch.float32:
        out = x2.float() @ w
    elif x2.is_cuda:
        out = _MmF32.apply(x2.to(w.dtype), w)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*lead, w.shape[-1])


def mlp(cfg: LlamaConfig, layer: Dict[str, Any],
        h: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP. h: [B, S, E] -> [B, S, E]."""
    dt = cfg.dtype
    gate = torch.einsum("bse,em->bsm", h, layer["w_gate"].to(dt))
    up = torch.einsum("bse,em->bsm", h, layer["w_up"].to(dt))
    return torch.einsum("bsm,me->bse", F.silu(gate) * up,
                        layer["w_down"].to(dt))


class _GatherSeq(torch.autograd.Function):
    """[B, h, S_l, D] split over the sp group -> the whole [B, h, S, D];
    backward: the gradients summed over the group, this rank's block."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.args = (group, dist.get_rank(group), x.shape[2])
        return torch.cat(parts, 2)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        group, rank, sl = ctx.args
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return g[:, :, rank * sl:(rank + 1) * sl].contiguous(), None


def _attend(cfg: LlamaConfig, q, k, v):
    """q: [B, H, S, D], k/v: [B, Hkv, S, D] (this rank's heads and, under
    a sharded step's sp group, its block of the sequence) -> [B, H, S, D].

    "ring"/"ulysses" run over the sp group; the other impls, where the
    sequence is split, attend to the whole sequence's K/V gathered over
    the group from the block's own position on (as GSPMD computes JAX's
    plain attention of a sequence-sharded batch)."""
    sp = _GROUPS.sp
    impl = cfg.attention_impl
    if impl == "ring":
        return ring_attention(q, k, v, group=sp, causal=True)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, group=sp, causal=True)
    if sp is None:
        return _attention(q, k, v, causal=True, impl=attention_impl(cfg))
    import torch.distributed as dist
    offset = dist.get_rank(sp) * q.shape[2]
    k, v = _GatherSeq.apply(k, sp), _GatherSeq.apply(v, sp)
    if impl == "reference":
        return reference_attention(q, k, v, causal=True, q_offset=offset)
    return flash_attention(q, k, v, causal=True, q_offset=offset)


def _attn_half(cfg: LlamaConfig, cos, sin, positions, x, layer):
    """Attention residual branch. x: [B, S, E] -> [B, S, E]."""
    dt = cfg.dtype
    tp = _GROUPS.tp
    h = _sum_grad(rms_norm(x, layer["attn_norm"], cfg.norm_eps), tp)
    q = torch.einsum("bse,ehd->bhsd", h, layer["wq"].to(dt))
    k = torch.einsum("bse,ehd->bhsd", h, layer["wk"].to(dt))
    v = torch.einsum("bse,ehd->bhsd", h, layer["wv"].to(dt))
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    attn = _attend(cfg, q.contiguous(), k.contiguous(), v.contiguous())
    attn_out = torch.einsum("bhsd,hde->bse", attn, layer["wo"].to(dt))
    return x + _sum(attn_out, tp)


def _mlp_half(cfg: LlamaConfig, x, layer):
    """MLP/MoE residual branch. x: [B, S, E] -> ([B, S, E], fp32 aux loss:
    the MoE load-balancing loss, 0 for a dense block).

    MoE under tp and ep: the routing runs on every rank from the whole
    normed input (its gradient is whole), the experts on the rank's share
    (their input's gradient and the combine weights' sum over tp and ep),
    and the output sums over tp and ep."""
    G = _GROUPS
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    if not cfg.num_experts:
        out = _sum(mlp(cfg, layer, _sum_grad(h, G.tp)), G.tp)
        return x + out, torch.zeros((), dtype=torch.float32,
                                    device=x.device)
    dt = cfg.dtype
    par = G.moe or MoEParallel()
    if G.tp is not None or G.ep is not None:
        par = dataclasses.replace(
            par, partial_grad=lambda t: _sum_grad(t, G.tp, G.ep))
    out, aux = moe_layer(h, layer["router"].to(dt), layer["w_gate"].to(dt),
                         layer["w_up"].to(dt), layer["w_down"].to(dt),
                         k=cfg.moe_top_k,
                         capacity_factor=cfg.moe_capacity_factor,
                         parallel=par)
    return x + _sum(out, G.tp, G.ep), aux


def _block(cfg: LlamaConfig, cos, sin, positions, x, layer):
    """One transformer block. x: [B, S, E] -> (x, aux loss)."""
    return _mlp_half(cfg, _attn_half(cfg, cos, sin, positions, x, layer),
                     layer)


def _remat(fn):
    """``fn`` recomputed in the backward instead of keeping its
    activations (JAX's ``jax.checkpoint`` with ``nothing_saveable``)."""
    return partial(checkpoint, fn, use_reentrant=False,
                   preserve_rng_state=False)


_aten = torch.ops.aten
_PLAIN_PRODUCTS = (_aten.mm.default, _aten.addmm.default)
_BATCHED_PRODUCTS = (_aten.bmm.default, _aten.baddbmm.default)


def remat_policy(mode: str):
    """The selective-checkpoint policy of remat ``mode`` (JAX's
    ``checkpoint_dots`` and ``checkpoint_dots_with_no_batch_dims``): save
    the output of every matrix product, or of those without batch dims;
    recompute everything else in the backward.

    ``torch.einsum`` lowers a projection ("bse,ehd->bhsd") to a ``bmm``
    whose batch is 1 after its reshape, so "dots_nobatch" counts a bmm of
    batch 1 as a plain product; plain attention's products ("bhqd,bhkd")
    have batch B * H.  The flash kernels are one C entry each, inside
    ``_Flash``, and no aten product: neither policy saves them, and the
    forward kernel runs again in the backward, as a ``pallas_call`` is no
    ``dot_general`` to JAX's policies."""
    batched_too = mode == "dots"

    def policy(ctx, op, *args, **kwargs):
        save = op in _PLAIN_PRODUCTS or (op in _BATCHED_PRODUCTS and (
            batched_too
            or args[op is _aten.baddbmm.default].shape[0] == 1))
        return (CheckpointPolicy.MUST_SAVE if save
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _remat_saving_dots(fn, mode: str):
    """``fn`` under ``torch.utils.checkpoint`` with ``remat_policy(mode)``:
    the saved products are kept, the rest recomputed in the backward."""
    return partial(checkpoint, fn, use_reentrant=False,
                   preserve_rng_state=False,
                   context_fn=partial(create_selective_checkpoint_contexts,
                                      remat_policy(mode)))


def _block_fn(cfg: LlamaConfig, cos, sin, positions):
    """The per-layer function for ``cfg.remat``: False keeps every
    activation; True/"full" recomputes the whole block in the backward;
    "mlp_only" keeps the attention half's residuals (the flash kernel's
    q/k/v/out/LSE: the quadratic part is never recomputed) and recomputes
    only the MLP half; "dots"/"dots_nobatch" recompute the block but keep
    its matrix products' outputs (``remat_policy``)."""
    block = partial(_block, cfg, cos, sin, positions)
    if not torch.is_grad_enabled() or cfg.remat is False:
        return block
    if cfg.remat is True or cfg.remat == "full":
        return _remat(block)
    if cfg.remat == "mlp_only":
        mlp_half = _remat(partial(_mlp_half, cfg))
        return lambda x, layer: mlp_half(
            _attn_half(cfg, cos, sin, positions, x, layer), layer)
    if cfg.remat in ("dots", "dots_nobatch"):
        return _remat_saving_dots(block, cfg.remat)
    raise ValueError(f"unknown remat mode {cfg.remat!r}")


def _forward_hidden(params: Dict[str, Any], tokens: torch.Tensor,
                    cfg: LlamaConfig,
                    positions: Optional[torch.Tensor] = None):
    """tokens: [B, S] int -> (final hidden [B, S, E], the MoE aux loss
    summed over layers, fp32); forward_with_aux applies the lm_head on
    top.

    ``positions``: absolute positions [S] (defaults to arange; a rank
    holding a block of the sequence passes its block's positions)."""
    check_supported(cfg)
    dt = cfg.dtype
    # Cast, then gather (as JAX does): under autograd the embedding's
    # gradient is then scatter-added in the compute dtype.
    x = params["embed"].to(dt)[tokens]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=x.device)
    block = _block_fn(cfg, cos, sin, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.pp_microbatches:
        x = _pipeline(cfg, params["blocks"], x, block)
    else:
        for layer in layers(params):
            x, a = block(x, layer)
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def _pipeline(cfg: LlamaConfig, blocks: Dict[str, torch.Tensor], x, block):
    """The blocks as a GPipe pipeline over the pp group, with the JAX
    model's refusals."""
    from ..parallel.pipeline import pipeline_blocks
    pp = _GROUPS.pp
    if pp is None:
        raise ValueError(
            "cfg.pp_microbatches > 0 needs a global mesh with pp > 1")
    if cfg.num_experts:
        raise NotImplementedError("MoE + pipeline parallelism")
    if cfg.attention_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            "sequence-parallel attention inside a pipeline stage")
    import torch.distributed as dist
    stages = dist.get_world_size(pp)
    if cfg.layers % stages:
        raise ValueError(f"layers ({cfg.layers}) must divide evenly over pp "
                         f"stages ({stages})")

    def stage_body(stage_blocks, h):
        for layer in layers({"blocks": stage_blocks}):
            h = block(h, layer)[0]
        return h

    return pipeline_blocks(blocks, x, stage_body,
                           num_microbatches=cfg.pp_microbatches, group=pp)


def forward_with_aux(params: Dict[str, Any], tokens: torch.Tensor,
                     cfg: LlamaConfig,
                     positions: Optional[torch.Tensor] = None):
    """tokens: [B, S] int -> (fp32 logits [B, S, vocab], MoE aux loss).

    ``positions``: absolute positions [S] (defaults to arange)."""
    x, aux = _forward_hidden(params, tokens, cfg, positions)
    return logits_f32(x, params["lm_head"].to(cfg.dtype)), aux


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    return forward_with_aux(params, tokens, cfg, positions)[0]


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position NLL as LSE(logits) - logit[target] (the logsumexp form
    of the JAX loss: no second [B, S, vocab] log-softmax array)."""
    logits = logits.float()
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - tgt


def _chunked_nll_sum(x, lm_head, targets, mask, num_chunks: int, dt):
    """Masked next-token NLL sum with the lm_head applied per sequence
    chunk, each chunk recomputed in the backward: peak logits memory is one
    chunk's [B, S/c, vocab] fp32 slab instead of the full tensor."""
    S = x.shape[1]
    if S % num_chunks:
        raise ValueError(f"sequence {S} not divisible by loss_chunks="
                         f"{num_chunks}")
    c = S // num_chunks

    def chunk_nll(xc, tc, mc):
        return (_nll(logits_f32(xc, lm_head.to(dt)), tc) * mc).sum()

    if torch.is_grad_enabled():
        chunk_nll = _remat(chunk_nll)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    # split (not per-chunk slices): its backward is one cat.
    for xc, tc, mc in zip(x.split(c, dim=1), targets.split(c, dim=1),
                          mask.split(c, dim=1)):
        total = total + chunk_nll(xc, tc, mc)
    return total


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy (fp32 scalar), plus ``0.01 * aux / layers``
    for an MoE model (JAX's weight of the load-balancing loss).  batch:
    tokens [B, S] int, optional loss_mask [B, S] and loss_denom (gradient
    accumulation passes the full batch's token count), and optional
    targets [B, S]: the next tokens, where the caller split the rows'
    positions (a sequence-parallel step builds targets and the default
    mask on the whole row first); default: the row shifted by one."""
    tokens = batch["tokens"]
    targets = batch.get("targets")
    if targets is None:
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                            dim=1)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.cat([torch.ones_like(tokens[:, 1:]),
                          torch.zeros_like(tokens[:, :1])], dim=1)
    mask = mask.float()
    denom = batch.get("loss_denom")
    if denom is None:
        denom = mask.sum().clamp_min(1.0)
    if cfg.loss_chunks:
        x, aux = _forward_hidden(params, tokens, cfg, positions)
        nll_sum = _chunked_nll_sum(x, params["lm_head"], targets, mask,
                                   cfg.loss_chunks, cfg.dtype)
    else:
        logits, aux = forward_with_aux(params, tokens, cfg, positions)
        nll_sum = (_nll(logits, targets) * mask).sum()
    loss = nll_sum / denom
    if cfg.num_experts:
        loss = loss + 0.01 * aux / cfg.layers
    return loss


def num_params(cfg: LlamaConfig) -> int:
    L, E, H, Hkv, D, M, V = (cfg.layers, cfg.hidden, cfg.heads, cfg.kv_heads,
                             cfg.head_dim, cfg.mlp_dim, cfg.vocab_size)
    per_layer = E * H * D + 2 * E * Hkv * D + H * D * E + 2 * E
    if cfg.num_experts:
        per_layer += E * cfg.num_experts + 3 * cfg.num_experts * E * M
    else:
        per_layer += 3 * E * M
    return V * E + L * per_layer + E + E * V

"""Llama-family decoder-only transformer (counterpart of
ray_tpu/models/llama.py).

Parameters are a plain dict in the JAX package's layout: layers stacked on a
leading ``[L, ...]`` axis, projections as ``wq [L, E, H, D]`` and friends, so
``models.convert.params_from_numpy`` carries a JAX pytree over with no
transposes.  Activations run in ``cfg.dtype`` with weights cast at each use,
as the JAX code does; logits are fp32.

Attention dispatches to ``ops.attention``: the CUDA flash kernels on the card
(``attention_impl`` "auto" or "flash"; forward and, under autograd, the flash
backward), the plain version for "reference".  ``loss_fn`` is the training
objective, with the JAX package's remat modes as ``torch.utils.checkpoint``.
Dense models only: ring/Ulysses attention, MoE and pipeline parallelism raise
``NotImplementedError`` naming the slice they come with.
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
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_frequencies


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
    # MoE: 0 experts = dense model (the only kind this slice runs).
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # "auto"/"flash"/"flash_interpret" (the flash kernels on the card, their
    # plain versions on CPU tensors), "reference" (plain); "ring"/"ulysses"
    # come with a later slice.
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
    """Raise for the parts of the JAX model this slice does not port."""
    if cfg.attention_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} (sequence-parallel "
            "attention) comes with a later slice of the port: ROADMAP "
            "Queue 1 item 7")
    if cfg.attention_impl not in ("auto", "flash", "flash_interpret",
                                  "reference"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "mixture-of-experts layers come with a later slice of the port: "
            "ROADMAP Queue 1 item 7 (ops/moe.py)")
    if cfg.pp_microbatches > 0:
        raise NotImplementedError(
            "pipeline parallelism comes with a later slice of the port: "
            "ROADMAP Queue 1 item 7 (parallel/pipeline.py)")


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
    """The ``ops.attention`` impl for ``cfg``: None (kernel) or
    "reference" (plain version).  "flash_interpret" is the kernel path, as
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
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }
    return {
        "embed": ("vocab", "embed"),
        "blocks": block,
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


#: The tensor-parallel process group the blocks run over, or None (see
#: ``tensor_parallel``).
_TP_GROUP = None


@contextlib.contextmanager
def tensor_parallel(group):
    """Run the blocks Megatron-style over ``group`` (the mesh's tp axis)
    inside this context: the caller passes each rank its heads' share of
    wq/wk/wv/wo and its mlp columns' share of w_gate/w_up/w_down.  Each
    branch's input then sums its gradient over the group in the backward,
    and its output sums over the group in the forward.  Attention needs no
    communication: the heads are the rank's own.  None: one rank, no
    communication (the default)."""
    global _TP_GROUP
    old, _TP_GROUP = _TP_GROUP, group
    try:
        yield
    finally:
        _TP_GROUP = old


class _SumGradOverTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverTP(torch.autograd.Function):
    """Sum over the group in the forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp_in(h: torch.Tensor) -> torch.Tensor:
    return h if _TP_GROUP is None else _SumGradOverTP.apply(h, _TP_GROUP)


def _tp_out(y: torch.Tensor) -> torch.Tensor:
    return y if _TP_GROUP is None else _SumOverTP.apply(y, _TP_GROUP)


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
        "w_gate": trunc((L, E, M), E),
        "w_up": trunc((L, E, M), E),
        "w_down": trunc((L, M, E), M),
    }
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


def _attn_half(cfg: LlamaConfig, cos, sin, positions, x, layer):
    """Attention residual branch. x: [B, S, E] -> [B, S, E]."""
    dt = cfg.dtype
    h = _tp_in(rms_norm(x, layer["attn_norm"], cfg.norm_eps))
    q = torch.einsum("bse,ehd->bhsd", h, layer["wq"].to(dt))
    k = torch.einsum("bse,ehd->bhsd", h, layer["wk"].to(dt))
    v = torch.einsum("bse,ehd->bhsd", h, layer["wv"].to(dt))
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    attn = _attention(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=True, impl=attention_impl(cfg))
    attn_out = torch.einsum("bhsd,hde->bse", attn, layer["wo"].to(dt))
    return x + _tp_out(attn_out)


def _mlp_half(cfg: LlamaConfig, x, layer):
    """MLP residual branch. x: [B, S, E] -> [B, S, E]."""
    h = _tp_in(rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
    return x + _tp_out(mlp(cfg, layer, h))


def _block(cfg: LlamaConfig, cos, sin, positions, x, layer):
    """One transformer block. x: [B, S, E]."""
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
    """tokens: [B, S] int -> (final hidden [B, S, E], aux loss 0);
    forward_with_aux applies the lm_head on top."""
    check_supported(cfg)
    dt = cfg.dtype
    # Cast, then gather (as JAX does): under autograd the embedding's
    # gradient is then scatter-added in the compute dtype.
    x = params["embed"].to(dt)[tokens]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=x.device)
    block = _block_fn(cfg, cos, sin, positions)
    for layer in layers(params):
        x = block(x, layer)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_with_aux(params: Dict[str, Any], tokens: torch.Tensor,
                     cfg: LlamaConfig,
                     positions: Optional[torch.Tensor] = None):
    """tokens: [B, S] int -> (fp32 logits [B, S, vocab], aux loss 0).

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
    """Next-token cross-entropy (fp32 scalar).  batch: tokens [B, S] int,
    optional loss_mask [B, S] and loss_denom (gradient accumulation passes
    the full batch's token count)."""
    tokens = batch["tokens"]
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
        x, _aux = _forward_hidden(params, tokens, cfg, positions)
        nll_sum = _chunked_nll_sum(x, params["lm_head"], targets, mask,
                                   cfg.loss_chunks, cfg.dtype)
    else:
        logits, _aux = forward_with_aux(params, tokens, cfg, positions)
        nll_sum = (_nll(logits, targets) * mask).sum()
    return nll_sum / denom


def num_params(cfg: LlamaConfig) -> int:
    L, E, H, Hkv, D, M, V = (cfg.layers, cfg.hidden, cfg.heads, cfg.kv_heads,
                             cfg.head_dim, cfg.mlp_dim, cfg.vocab_size)
    per_layer = E * H * D + 2 * E * Hkv * D + H * D * E + 2 * E
    if cfg.num_experts:
        per_layer += E * cfg.num_experts + 3 * cfg.num_experts * E * M
    else:
        per_layer += 3 * E * M
    return V * E + L * per_layer + E + E * V

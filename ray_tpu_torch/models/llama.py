"""Llama-family decoder-only transformer (counterpart of
ray_tpu/models/llama.py).

Parameters are a plain dict in the JAX package's layout: layers stacked on a
leading ``[L, ...]`` axis, projections as ``wq [L, E, H, D]`` and friends, so
``models.convert.params_from_numpy`` carries a JAX pytree over with no
transposes.  Activations run in ``cfg.dtype`` with weights cast at each use,
as the JAX code does; logits are fp32.

Attention dispatches to ``ops.attention``: the CUDA flash forward on the card
(``attention_impl`` "auto" or "flash"), the plain version for "reference".
Dense models only in this slice: ring/Ulysses attention, MoE and pipeline
parallelism raise ``NotImplementedError`` naming the slice they come with.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
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
    # "auto"/"flash" (the flash kernel on the card), "reference" (plain);
    # "ring"/"ulysses" come with a later slice.
    attention_impl: str = "auto"
    seq_axis: str = "sp"
    # Rematerialization mode of the training step (training slice).
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
            "Queue 1 item 9")
    if cfg.attention_impl not in ("auto", "flash", "reference"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "mixture-of-experts layers come with a later slice of the port: "
            "ROADMAP Queue 1 item 9 (ops/moe.py)")
    if cfg.pp_microbatches > 0:
        raise NotImplementedError(
            "pipeline parallelism comes with a later slice of the port: "
            "ROADMAP Queue 1 item 9 (parallel/pipeline.py)")


def attention_impl(cfg: LlamaConfig) -> Optional[str]:
    """The ``ops.attention`` impl for ``cfg``: None (kernel) or
    "reference" (plain version)."""
    return "reference" if cfg.attention_impl == "reference" else None


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


def layer_params(params: Dict[str, Any], li: int) -> Dict[str, Any]:
    """Layer ``li``'s slice of the stacked block parameters (views)."""
    return {k: v[li] for k, v in params["blocks"].items()}


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
        out = torch.mm(x2.to(w.dtype), w, out_dtype=torch.float32)
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
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = torch.einsum("bse,ehd->bhsd", h, layer["wq"].to(dt))
    k = torch.einsum("bse,ehd->bhsd", h, layer["wk"].to(dt))
    v = torch.einsum("bse,ehd->bhsd", h, layer["wv"].to(dt))
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    attn = _attention(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=True, impl=attention_impl(cfg))
    attn_out = torch.einsum("bhsd,hde->bse", attn, layer["wo"].to(dt))
    return x + attn_out


def forward_with_aux(params: Dict[str, Any], tokens: torch.Tensor,
                     cfg: LlamaConfig,
                     positions: Optional[torch.Tensor] = None):
    """tokens: [B, S] int -> (fp32 logits [B, S, vocab], aux loss 0).

    ``positions``: absolute positions [S] (defaults to arange)."""
    check_supported(cfg)
    dt = cfg.dtype
    x = params["embed"][tokens].to(dt)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=x.device)
    for li in range(params["blocks"]["wq"].shape[0]):
        layer = layer_params(params, li)
        x = _attn_half(cfg, cos, sin, positions, x, layer)
        x = x + mlp(cfg, layer, rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_f32(x, params["lm_head"].to(dt))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    return forward_with_aux(params, tokens, cfg, positions)[0]


def num_params(cfg: LlamaConfig) -> int:
    L, E, H, Hkv, D, M, V = (cfg.layers, cfg.hidden, cfg.heads, cfg.kv_heads,
                             cfg.head_dim, cfg.mlp_dim, cfg.vocab_size)
    per_layer = E * H * D + 2 * E * Hkv * D + H * D * E + 2 * E
    if cfg.num_experts:
        per_layer += E * cfg.num_experts + 3 * cfg.num_experts * E * M
    else:
        per_layer += 3 * E * M
    return V * E + L * per_layer + E + E * V

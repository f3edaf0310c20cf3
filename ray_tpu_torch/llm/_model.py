"""Llama inference forward passes with a paged KV cache (counterpart of
ray_tpu/llm/_model.py).

- ``prefill``: run a (padded) prompt through the model, returning the last
  valid position's logits and the per-layer K/V to seed the cache.  Its
  attention goes through ``ops.attention``, so on the card it runs the flash
  forward kernel.
- ``write_prefill``: scatter a prefilled prompt's K/V into every layer's
  pages.
- ``prefill_chunk``: one chunk of a long prompt, attending over the pages
  written so far (plain PyTorch over gathered pages, as the JAX code does).
- ``decode_step``: one token per active slot through the paged decode kernel.
- ``decode_chunk``: ``steps`` decode steps with sampling on the device; the
  host synchronises once, when it reads the returned [steps, B] tokens.

Weights are the training parameters unchanged.  ``cfg.attention_impl ==
"reference"`` selects the plain versions of both kernels (the checks hold the
kernel path against it on the card).

In place where JAX donates: the KV pages are updated with ``index_put_``,
the counterpart of the donated ``.at[].set``.  Duplicate writes to reserved
page 0 (padding rows, inactive slots) are allowed: page 0 is never read.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ..models.llama import (LlamaConfig, attention_impl, layers,
                            logits_f32, mlp)
from ..ops.attention import attention
from ..ops.norms import rms_norm
from ..ops.paged_attention import (NEG_INF, _exact_path, combine_kv,
                                   paged_decode_attention)
from ..ops.rope import rope_frequencies


def _rope_tables(cfg: LlamaConfig, device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    return rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                            device=device)


def _rope_batched(x, cos, sin, positions):
    """x: [B, H, S, D]; positions: [B, S] (per-sequence absolute)."""
    c = cos[positions][:, None]          # [B, 1, S, D/2]
    s = sin[positions][:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def _project_qkv(cfg, layer, h, positions, rope):
    """h: [B, S, E]; positions: [B, S]."""
    dt = cfg.dtype
    q = torch.einsum("bse,ehd->bhsd", h, layer["wq"].to(dt))
    k = torch.einsum("bse,ehd->bhsd", h, layer["wk"].to(dt))
    v = torch.einsum("bse,ehd->bhsd", h, layer["wv"].to(dt))
    cos, sin = rope
    return (_rope_batched(q, cos, sin, positions),
            _rope_batched(k, cos, sin, positions), v)


def _embed(params, tokens, dt):
    # Gather, then cast: the same values as casting the table first, without
    # a per-call copy of the whole [vocab, E] table.
    return params["embed"][tokens].to(dt)


def prefill(params: Dict[str, Any], tokens: torch.Tensor, length: int,
            cfg: LlamaConfig):
    """tokens: [1, S_pad]; length: valid prompt length (host int).

    Returns (fp32 logits at the last valid position [vocab],
             k [L, S_pad, Hkv, D], v [L, S_pad, Hkv, D])."""
    dt = cfg.dtype
    _B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    rope = _rope_tables(cfg, tokens.device)
    x = _embed(params, tokens, dt)
    ks, vs = [], []
    for layer in layers(params):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, layer, h, positions[None, :], rope)
        # Causal masking suffices: queries at/after `length` are padding
        # whose logits are never read, and valid queries only see valid
        # (earlier) key positions.
        attn = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=True, impl=attention_impl(cfg))
        x = x + torch.einsum("bhsd,hde->bse", attn, layer["wo"].to(dt))
        x = x + mlp(cfg, layer, rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
        # [S, Hkv, D] per layer for the cache.
        ks.append(k[0].transpose(0, 1))
        vs.append(v[0].transpose(0, 1))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = min(max(int(length) - 1, 0), S - 1)
    logits = logits_f32(x[0, last], params["lm_head"])
    return logits, torch.stack(ks), torch.stack(vs)


def write_prefill(kv_pages, ks, vs, page_ids, offs):
    """Scatter a prefilled prompt's K/V into every layer's pages, in place.

    kv_pages: per-layer tuple of combined [NP, page, 2*Hkv, D] tensors;
    ks/vs: [L, S_pad, Hkv, D] from prefill; page_ids/offs: [S_pad] (positions
    past the real prompt length point at reserved page 0).  Returns the
    tuple."""
    page_ids = page_ids.long()
    offs = offs.long()
    for li, kv in enumerate(kv_pages):
        kv[page_ids, offs] = combine_kv(ks[li], vs[li]).to(kv.dtype)
    return tuple(kv_pages)


def prefill_chunk(params: Dict[str, Any], kv_pages, tokens: torch.Tensor,
                  start: int, length: int, block_table: torch.Tensor,
                  cfg: LlamaConfig, page_size: int):
    """Incremental (chunked) prefill: run ``length`` prompt tokens that begin
    at absolute position ``start`` through the model, writing their K/V into
    this sequence's pages and attending over ALL cache positions
    ``[0, start+length)``.

    tokens: [1, C] chunk-bucket-padded; start/length: host ints;
    block_table: [P] page ids for this sequence.  Returns (fp32 logits at the
    chunk's last valid position [vocab], kv_pages)."""
    dt = cfg.dtype
    dev = tokens.device
    _B, C = tokens.shape
    P = block_table.shape[0]
    S = P * page_size
    Hkv, D = cfg.kv_heads, cfg.head_dim
    group = cfg.heads // Hkv
    idx = torch.arange(C, device=dev)
    positions = start + idx                       # [C] absolute
    total = start + length
    valid = idx < length
    # Rope table lookups clamp; writes for padding rows land on reserved
    # page 0 (never referenced by any block table).
    rope_pos = positions.clamp(max=cfg.max_seq_len - 1)
    bt = block_table.long()
    page_ids = torch.where(valid, bt[(positions // page_size).clamp(0, P - 1)],
                           0)
    offs = torch.where(valid, positions % page_size, 0)
    kv_pos = torch.arange(S, device=dev)
    mask = (kv_pos[None, :] <= positions[:, None]) & (kv_pos[None, :] < total)
    rope = _rope_tables(cfg, dev)
    x = _embed(params, tokens, dt)                # [1, C, E]
    for kv, layer in zip(kv_pages, layers(params)):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, layer, h, rope_pos[None, :], rope)
        # Write this chunk's K/V first, then gather the WHOLE sequence back
        # from pages: chunk-internal causality rides the same mask as
        # cross-chunk context.
        kv[page_ids, offs] = combine_kv(k[0].transpose(0, 1),
                                        v[0].transpose(0, 1)).to(kv.dtype)
        pages = kv[bt]                            # [P, page, 2Hkv, D]
        kh = pages[:, :, 0::2, :].reshape(S, Hkv, D).transpose(0, 1)
        vh = pages[:, :, 1::2, :].reshape(S, Hkv, D).transpose(0, 1)
        if group > 1:
            kh = kh.repeat_interleave(group, dim=0)
            vh = vh.repeat_interleave(group, dim=0)
        scores = torch.einsum("hcd,hsd->hcs", q[0].float(),
                              kh.float()) / math.sqrt(D)
        scores = scores.masked_fill(~mask[None], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("hcs,hsd->hcd", probs.to(vh.dtype), vh)
        attn_out = torch.einsum("hcd,hde->ce", attn, layer["wo"].to(dt))
        x = x + attn_out[None]
        x = x + mlp(cfg, layer, rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = min(max(int(length) - 1, 0), C - 1)
    logits = logits_f32(x[0, last], params["lm_head"])
    return logits, tuple(kv_pages)


def decode_step(params: Dict[str, Any], kv_pages, tokens: torch.Tensor,
                positions: torch.Tensor, block_tables: torch.Tensor,
                active: torch.Tensor, cfg: LlamaConfig, page_size: int):
    """One decode step for every slot.

    tokens: [B] last sampled token per slot; positions: [B] int32 their
    position; block_tables: [B, P] int32 page ids; active: [B] bool.
    Returns (fp32 logits [B, vocab], kv_pages updated in place).

    Each layer's cache takes ONE scatter per step whose [2*Hkv, D] window is
    contiguous at a leading (page, offset) index."""
    dt = cfg.dtype
    dev = tokens.device
    P = block_tables.shape[1]
    x = _embed(params, tokens, dt)[:, None, :]            # [B, 1, E]
    seq_lens = torch.where(active, positions + 1, 0).to(torch.int32)
    slot_page = (positions // page_size).long()
    in_table = slot_page < P
    page_idx = block_tables.gather(
        1, slot_page.clamp(max=P - 1)[:, None])[:, 0].long()
    # Inactive slots, and positions past the table's reach (pipelined
    # overgeneration), park their write on reserved page 0 (never read).
    page_idx = torch.where(active & in_table, page_idx, 0)
    page_off = torch.where(active, positions % page_size, 0).long()
    # Table lookups clamp, as JAX's gathers do.
    rope_pos = positions.clamp(max=cfg.max_seq_len - 1).long()
    rope = _rope_tables(cfg, dev)
    plain = attention_impl(cfg) == "reference"
    for kv, layer in zip(kv_pages, layers(params)):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, layer, h, rope_pos[:, None], rope)
        kv[page_idx, page_off] = combine_kv(k[:, :, 0, :],
                                            v[:, :, 0, :]).to(kv.dtype)
        q1 = q[:, :, 0, :].contiguous()
        if plain:
            attn = _exact_path(q1, kv, block_tables, seq_lens, page_size)
        else:
            attn = paged_decode_attention(q1, kv, block_tables, seq_lens,
                                          page_size)
        attn_out = torch.einsum("bhd,hde->be", attn, layer["wo"].to(dt))
        x = x + attn_out[:, None, :]
        x = x + mlp(cfg, layer, rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # bf16 reads with fp32 accumulation and output (see logits_f32).
    logits = logits_f32(x[:, 0, :], params["lm_head"])
    return logits, tuple(kv_pages)


def sample_tokens(logits: torch.Tensor, temperature: float, top_k: int,
                  generator: torch.Generator) -> torch.Tensor:
    """On-device sampling: argmax when ``temperature <= 0``, else top-k
    filtered categorical draws from ``generator``.  Returns int32 [B].

    The draw is Gumbel-max: argmax(logits / T - log E), E ~ Exp(1) from
    ``generator``, which is the categorical distribution of
    softmax(logits / T) over the kept tokens and needs no host sync
    (``torch.multinomial`` checks its probabilities on the host)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    noise = torch.empty_like(logits).exponential_(generator=generator)
    return (logits - noise.log()).argmax(dim=-1).to(torch.int32)


def decode_chunk(params: Dict[str, Any], kv_pages, tokens: torch.Tensor,
                 positions: torch.Tensor, block_tables: torch.Tensor,
                 active: torch.Tensor, generator: torch.Generator,
                 cfg: LlamaConfig, page_size: int, steps: int,
                 temperature: float, top_k: int):
    """``steps`` decode iterations with ON-DEVICE sampling and no host
    synchronisation inside: the caller syncs once, when it reads the
    returned tokens (the counterpart of the JAX ``lax.scan``).

    tokens/positions/active: [B] as in decode_step.  Returns
    (sampled [steps, B] int32, new positions, kv_pages).  Stop tokens are
    enforced by the HOST after the chunk (bounded overgeneration)."""
    toks, pos = tokens, positions
    out = []
    for _ in range(steps):
        logits, kv_pages = decode_step(params, kv_pages, toks, pos,
                                       block_tables, active, cfg, page_size)
        nxt = sample_tokens(logits, temperature, top_k, generator)
        toks = torch.where(active, nxt, toks)
        pos = torch.where(active, pos + 1, pos)
        out.append(toks)
    return torch.stack(out), pos, kv_pages

"""Paged decode attention over a block-table KV cache (counterpart of
ray_tpu/ops/paged_attention.py).

Cache layout (per layer): ONE combined tensor

    kv_pages : [total_pages, page_size, 2 * num_kv_heads, head_dim]

with K at even and V at odd combined-head indices (k_h0, v_h0, k_h1, ...),
the JAX package's layout, so caches and prefill handoffs interchange with it.

- ``paged_decode_attention`` (also named ``paged_decode``, the kernel's name)
  wraps the CUDA kernel of ``csrc/paged_decode.cu``, which replaces the
  ragged paged attention kernel the JAX package takes from Pallas's library
  on the TPU: each (slot, KV head) walks only its live pages, with online
  softmax in fp32.  On CPU tensors it takes the plain version; on CUDA
  tensors it launches the kernel or raises.
- ``_exact_path`` is the plain version, a torch copy of the JAX one: gather
  every page of the block table and run dense masked attention.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)


def combine_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Interleave per-head K and V ([..., Hkv, D] each) into the
    combined-head layout [..., 2*Hkv, D] the kernel reads."""
    stacked = torch.stack([k, v], dim=-2)          # [..., Hkv, 2, D]
    return stacked.reshape(*k.shape[:-2], 2 * k.shape[-2], k.shape[-1])


def _exact_path(q, kv_pages, block_table, seq_lens,
                page_size: int) -> torch.Tensor:
    """Plain version: gather each sequence's pages and run dense masked
    attention.  Materializes [B, H, S_max, D]."""
    B, H, D = q.shape
    Hkv = kv_pages.shape[2] // 2
    P = block_table.shape[1]
    group = H // Hkv
    pages = kv_pages[block_table.long()]          # [B, P, page, 2Hkv, D]
    k = pages[:, :, :, 0::2, :].reshape(B, P * page_size, Hkv, D)
    v = pages[:, :, :, 1::2, :].reshape(B, P * page_size, Hkv, D)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(),
                          k.float()) / math.sqrt(D)
    kv_pos = torch.arange(P * page_size, device=q.device)
    mask = kv_pos[None, :] < seq_lens[:, None]           # [B, S_max]
    scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", probs, v.float())
    return out.to(q.dtype)


def _check_paged(q, kv_pages, block_table, seq_lens, page_size) -> None:
    dev = q.device
    for name, t in (("q", q), ("kv_pages", kv_pages),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"paged_decode: {name} must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} must be 16-byte "
                             f"aligned")
    if q.dtype not in _DTYPE_CODE or kv_pages.dtype != q.dtype:
        raise ValueError(f"paged_decode takes q and kv_pages of one dtype, "
                         f"bfloat16 or float32; got {q.dtype} / "
                         f"{kv_pages.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged_decode: block_table and seq_lens must be "
                         "int32")
    if q.dim() != 3 or kv_pages.dim() != 4:
        raise ValueError(f"paged_decode: q [B, H, D] and kv_pages "
                         f"[NP, page, 2*Hkv, D] expected; got "
                         f"{tuple(q.shape)} / {tuple(kv_pages.shape)}")
    B, H, D = q.shape
    if kv_pages.shape[1] != page_size or kv_pages.shape[3] != D \
            or kv_pages.shape[2] % 2:
        raise ValueError(f"paged_decode: kv_pages {tuple(kv_pages.shape)} "
                         f"does not match page_size={page_size}, D={D}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode takes head_dim in {_HEAD_DIMS}, "
                         f"not {D}")
    Hkv = kv_pages.shape[2] // 2
    if H % Hkv or H // Hkv not in _GROUPS:
        raise ValueError(f"paged_decode takes H/Hkv in {_GROUPS}; got "
                         f"H={H}, Hkv={Hkv}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_decode: block_table [B, P] and seq_lens "
                         f"[B] expected for B={B}; got "
                         f"{tuple(block_table.shape)} / "
                         f"{tuple(seq_lens.shape)}")


def paged_decode_attention(q, kv_pages, block_table, seq_lens,
                           page_size: int) -> torch.Tensor:
    """One decode step of attention over the paged cache.

    q: [B, H, D] (one new token per slot); kv_pages: [NP, page, 2*Hkv, D]
    combined; block_table: [B, P] int32 page ids; seq_lens: [B] int32
    sequence length INCLUDING the new token (0 = inactive slot, whose
    output is zeros).  Returns [B, H, D] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  ``paged_decode_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return _exact_path(q, kv_pages, block_table, seq_lens, page_size)
    _check_paged(q, kv_pages, block_table, seq_lens, page_size)
    B, H, D = q.shape
    Hkv = kv_pages.shape[2] // 2
    out = torch.empty_like(q)
    fn = _build.function("paged_decode", "rt_paged_decode", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), kv_pages.data_ptr(), block_table.data_ptr(),
                  seq_lens.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
                  B, H, Hkv, D, block_table.shape[1], page_size,
                  1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    _build.check("paged_decode", code, "paged_decode launch")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
#: The kernel's own name: the same function, and the same launch count.
paged_decode = paged_decode_attention

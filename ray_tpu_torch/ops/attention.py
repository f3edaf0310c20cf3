"""Causal (GQA) attention: a hand-written CUDA flash forward and its plain
PyTorch version (counterpart of ray_tpu/ops/attention.py).

- ``reference_attention`` is the plain version, a torch copy of the JAX
  ``reference_attention``: fp32 scores, masked softmax, probabilities cast to
  V's dtype for the second product.
- ``flash_fwd`` wraps the CUDA kernel of ``csrc/flash_fwd.cu``, which replaces
  the Pallas ``_fwd_kernel``: online softmax with an fp32 accumulator, the
  [Sq, Sk] score matrix never in device memory, causal tiles above the
  diagonal (shifted by ``q_offset``) skipped, optional fp32 LSE [B, H, Sq].
  Unlike the TPU kernel it masks the ragged edge, so any Sq and Sk work and
  nothing is padded.  On CPU tensors it takes the plain version; on CUDA
  tensors it launches the kernel or raises.
- ``flash_attention`` is the forward-only entry point: the backward kernels
  come with the training slice, so CUDA inputs that require grad raise.
- ``attention`` dispatches: the kernel path by default, the plain version
  for ``impl="reference"``.

Layouts are the JAX package's: q [B, H, Sq, D], k/v [B, Hkv, Sk, D].
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _scores(q, k, causal: bool, scale: float, q_offset: int):
    """fp32 masked scores [B, H, Sq, Sk] with K repeated over GQA groups."""
    H, Sq = q.shape[1], q.shape[2]
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = scores.masked_fill(~mask[None, None], NEG_INF)
    return scores


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Plain attention. q: [B, H, Sq, D]; k/v: [B, Hkv, Sk, D].

    ``q_offset`` shifts query positions for causal masking (a query block
    that starts mid-sequence)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    probs = torch.softmax(_scores(q, k, causal, scale, q_offset), dim=-1)
    H, Hkv = q.shape[1], k.shape[1]
    if Hkv != H:
        v = v.repeat_interleave(H // Hkv, dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _flash_plain(q, k, v, causal, scale, q_offset, need_lse):
    out = reference_attention(q, k, v, causal=causal, scale=scale,
                              q_offset=q_offset)
    lse = None
    if need_lse:
        lse = torch.logsumexp(_scores(q, k, causal, scale, q_offset), dim=-1)
    return out, lse


def _check_flash(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_fwd: {name} must be on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_fwd: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_fwd: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_fwd: {name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_fwd takes bfloat16 or float32, not "
                         f"{q.dtype}")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd takes head_dim in {_HEAD_DIMS}, not {D}")
    if H % k.shape[1]:
        raise ValueError(f"H={H} not divisible by Hkv={k.shape[1]}")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("flash_fwd: empty sequence")


def flash_fwd(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              q_offset: int = 0, need_lse: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Flash attention forward.  q: [B, H, Sq, D]; k/v: [B, Hkv, Sk, D].

    Returns (out [B, H, Sq, D] in q's dtype, fp32 LSE [B, H, Sq] or None).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 or fp32, D in {64, 128}) or raise.  ``flash_fwd.launches``
    counts kernel launches."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal, scale, q_offset, need_lse)
    _check_flash(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    fn = _build.function("flash_fwd", "rt_flash_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if lse is not None else None,
                  _DTYPE_CODE[q.dtype], B, H, Hkv, Sq, Sk, D, float(scale),
                  int(causal), int(q_offset),
                  torch.cuda.current_stream().cuda_stream)
    _build.check("flash_fwd", code, "flash_fwd launch")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention, forward only.  q: [B, H, Sq, D]; k/v: [B, Hkv, Sk, D].

    The backward kernels come with the training slice: CUDA inputs that
    require grad raise instead of silently taking the plain version."""
    if q.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "backward kernels come with the training slice")
    return flash_fwd(q, k, v, causal=causal, scale=scale,
                     q_offset=q_offset)[0]


def attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """Dispatching entry point: the flash kernel (``impl`` None, "auto" or
    "flash"; the plain version on CPU tensors) or the plain version
    (``impl="reference"``)."""
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if impl in (None, "auto", "flash"):
        return flash_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")

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
- ``flash_bwd`` wraps the two CUDA kernels of ``csrc/flash_bwd.cu``, which
  replace the Pallas ``_dq_kernel`` and ``_dkv_kernel``: P is recomputed from
  the forward's fp32 LSE, the bf16 dq kernel computes delta = rowsum(dO * O)
  in fp32 itself and hands it to the dk/dv kernel (fp32 takes a plain
  reduction outside, as JAX does), and dK/dV come out already summed over
  each KV head's query heads.  ``_flash_bwd_plain`` is its plain version.
- ``flash_attention`` ties the two together in ``_Flash``, a
  ``torch.autograd.Function``: forward with LSE, backward through
  ``flash_bwd``.  Without a gradient to take it runs the forward alone.
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
_HEAD_DIMS = (32, 64, 128)


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
            raise ValueError(f"flash attention: {name} must be on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash attention: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} must be 16-byte "
                             "aligned")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention takes bfloat16 or float32, not "
                         f"{q.dtype}")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention takes head_dim in {_HEAD_DIMS}, "
                         f"not {D}")
    if H % k.shape[1]:
        raise ValueError(f"H={H} not divisible by Hkv={k.shape[1]}")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("flash attention: empty sequence")


_SM_COUNT = {}


def _sm_count(device) -> int:
    """The card's SM count, asked once per device."""
    n = _SM_COUNT.get(device)
    if n is None:
        n = _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def flash_fwd(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              q_offset: int = 0, need_lse: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Flash attention forward.  q: [B, H, Sq, D]; k/v: [B, Hkv, Sk, D].

    Returns (out [B, H, Sq, D] in q's dtype, fp32 LSE [B, H, Sq] or None).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 or fp32, D in {32, 64, 128}) or raise.  ``flash_fwd.launches``
    counts kernel launches, ``flash_fwd.launches_by_thread`` them by the
    launching thread's name."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal, scale, q_offset, need_lse)
    _check_flash(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    # Scratch for the bf16 kernel's tile counter.  It is persistent: one
    # block per SM takes 128-row query tiles until none is left.  Where
    # every tile has a block of its own it needs none, and its allocation
    # would add to an eager call's host cost at small shapes.  launch_bf16
    # (csrc/flash_fwd.cu) decides the same way and refuses a launch that
    # needs a counter and was given none.
    counter = None
    if (q.dtype == torch.bfloat16
            and B * H * -(-Sq // 128) > _sm_count(q.device)):
        counter = torch.empty(1, dtype=torch.int32, device=q.device)
    fn = _build.function("flash_fwd", "rt_flash_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if lse is not None else None,
                  _DTYPE_CODE[q.dtype], B, H, Hkv, Sq, Sk, D, float(scale),
                  int(causal), int(q_offset),
                  counter.data_ptr() if counter is not None else None,
                  torch.cuda.current_stream().cuda_stream)
    _build.check("flash_fwd", code, "flash_fwd launch")
    _build.count_launch(flash_fwd)
    return out, lse


flash_fwd.launches = 0
flash_fwd.launches_by_thread = {}


def _flash_bwd_plain(q, k, v, out, lse, dout, causal, scale, q_offset):
    """The backward pair's math in plain torch: P = exp(S - LSE) from the
    saved fp32 LSE, delta = rowsum(dO * O), dS = P * (dP - delta) * scale;
    P and dS are rounded to the inputs' dtype before the second products
    (the kernels' and the TPU's bf16 operands), which accumulate in fp32.
    dK/dV are summed over each KV head's query heads."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    kr = k.repeat_interleave(group, dim=1) if group > 1 else k
    vr = v.repeat_interleave(group, dim=1) if group > 1 else v
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        p = p.masked_fill(~(qpos[:, None] >= kpos[None, :]), 0.0)
    delta = (dout.float() * out.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), vr.float())
    ds = p * (dp - delta[..., None]) * scale
    p = p.to(q.dtype).float()
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout.float())
    if group > 1:
        dk = dk.reshape(B, Hkv, group, Sk, D).sum(2)
        dv = dv.reshape(B, Hkv, group, Sk, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, like_q, fp32_rows) -> None:
    """The kernels' inputs: q, k, v, then (name, tensor) pairs shaped and
    typed like q (dout, out) and fp32 [B, H, Sq] ones (lse, delta)."""
    _check_flash(q, k, v)
    for name, t in like_q:
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash_bwd: {name} must be contiguous, 16-byte "
                             f"aligned {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}")
    for name, t in fp32_rows:
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash_bwd: {name} must be contiguous fp32 "
                             f"{tuple(q.shape[:3])} on {q.device}")


def _bwd_fn(symbol: str):
    return _build.function("flash_bwd", symbol, (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]))


def flash_bwd_dq(q, k, v, out, dout, lse, *, causal, scale, q_offset):
    """Launch the dq kernel from CUDA tensors (raises on anything else):
    (dQ [B, H, Sq, D] in q's dtype, delta = rowsum(dO * O) fp32 [B, H, Sq]
    for ``flash_bwd_dkv``).  bf16: the kernel computes delta itself; fp32:
    a plain reduction before the launch.  ``flash_bwd_dq.launches``
    counts."""
    _check_bwd(q, k, v, (("dout", dout), ("out", out)), (("lse", lse),))
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    else:
        delta = (dout.float() * out.float()).sum(-1)
    with torch.cuda.device(q.device):
        code = _bwd_fn("rt_flash_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, Hkv, Sq, Sk, D, float(scale),
            int(causal), int(q_offset),
            torch.cuda.current_stream().cuda_stream)
    _build.check("flash_bwd", code, "flash_bwd dq launch")
    _build.count_launch(flash_bwd_dq)
    return dq, delta


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal, scale, q_offset):
    """Launch the dk/dv kernel: (dK, dV) [B, Hkv, Sk, D] in k's dtype,
    summed over each KV head's query heads, from CUDA tensors (raises on
    anything else).  ``flash_bwd_dkv.launches`` counts."""
    _check_bwd(q, k, v, (("dout", dout),), (("lse", lse), ("delta", delta)))
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = _bwd_fn("rt_flash_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, Hkv, Sq, Sk, D, float(scale),
            int(causal), int(q_offset),
            torch.cuda.current_stream().cuda_stream)
    _build.check("flash_bwd", code, "flash_bwd dk/dv launch")
    _build.count_launch(flash_bwd_dkv)
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches_by_thread = {}
flash_bwd_dkv.launches_by_thread = {}


def flash_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
              scale: Optional[float] = None, q_offset: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward.  q/out/dout: [B, H, Sq, D]; k/v:
    [B, Hkv, Sk, D]; lse: the forward's fp32 [B, H, Sq].

    Returns (dq, dk, dv) in the inputs' dtypes, dk/dv summed over each KV
    head's query heads.  CPU tensors take the plain version; CUDA tensors
    launch the dq and dk/dv kernels (bf16 or fp32, D in {32, 64, 128}) or
    raise."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, out, lse, dout, causal, scale,
                                q_offset)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset)
    dq, delta = flash_bwd_dq(q, k, v, out, dout, lse, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """flash_fwd (with LSE) forward, flash_bwd backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale,
                             q_offset=q_offset, need_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, q_offset = ctx.args
        # The gradient of the output projection arrives strided.
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(),
                               causal=causal, scale=scale, q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention with a flash backward.  q: [B, H, Sq, D]; k/v:
    [B, Hkv, Sk, D].  Where no gradient is taken only the forward runs
    (no LSE)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, scale, q_offset)
    return flash_fwd(q, k, v, causal=causal, scale=scale,
                     q_offset=q_offset)[0]


def attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """Dispatching entry point: the flash kernel (``impl`` None, "auto",
    "flash" or "flash_interpret"; the plain version on CPU tensors) or the
    plain version (``impl="reference"``)."""
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if impl in (None, "auto", "flash", "flash_interpret"):
        return flash_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")

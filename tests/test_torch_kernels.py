"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (a CUDA kernel
has no interpret mode).  On the card:

    python -m pytest -m gpu tests/test_torch_kernels.py -q

Tolerances (max abs error vs the plain version on the same inputs): fp32
1e-4 (another summation order, exp2 vs exp); bf16 2e-2 (P and O rounded to
bf16: one ulp at |x| ~ 2 is 2**-6).  The flash forward is also held to the
worst row's ||out - ref|| / ||ref|| (``ROW_REL_TOL``): a long row's output
is small, so the absolute limit alone would let a wrong tile there pass.
The backward's are relative to each gradient's largest magnitude
(``BWD_TOL``) and per row (``BWD_ROW_REL_TOL``).
"""

from __future__ import annotations

import ctypes
import importlib
import math

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import paged_attention as paged

attn = importlib.import_module("ray_tpu_torch.ops.attention")

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ROW_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    """Decided per test, never at import: workers must collect the same
    tests whether or not they see a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,causal,q_offset", [
    (1, 16, 8, 256, 256, True, 0),
    (2, 4, 4, 1000, 1000, True, 0),
    (1, 8, 2, 77, 300, False, 0),
    (1, 16, 8, 128, 640, True, 512),
    (3, 8, 1, 33, 33, True, 0),
    # The bf16 kernel's 128-row query and 128-key tiles at their edges.
    (1, 4, 2, 129, 129, True, 0),          # one row past a tile
    (2, 8, 4, 1, 300, True, 299),          # one query row
    (1, 8, 4, 300, 400, True, 100),        # ragged, diagonal off a tile
    (2, 16, 16, 2048, 2048, True, 0),      # the training shape at B=2
    (1, 8, 1, 1000, 1000, True, 0),        # GQA 8/1
])
def test_flash_fwd_matches_plain(cuda, dtype, D, B, H, Hkv, Sq, Sk, causal,
                                 q_offset):
    gen = torch.Generator(device="cuda").manual_seed(Sq * 7 + D)
    q = _randn(gen, B, H, Sq, D, dtype=dtype)
    k = _randn(gen, B, Hkv, Sk, D, dtype=dtype)
    v = _randn(gen, B, Hkv, Sk, D, dtype=dtype)
    before = attn.flash_fwd.launches
    out, lse = attn.flash_fwd(q, k, v, causal=causal, q_offset=q_offset,
                              need_lse=True)
    assert attn.flash_fwd.launches == before + 1
    ref = attn.reference_attention(q, k, v, causal=causal, q_offset=q_offset)
    ref_lse = torch.logsumexp(attn._scores(q, k, causal, 1 / math.sqrt(D),
                                           q_offset), dim=-1)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    row_rel = ((out.float() - ref.float()).norm(dim=-1)
               / ref.float().norm(dim=-1)).max().item()
    assert row_rel <= ROW_REL_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def _wgmma_check(form, a, a32, b, n):
    """One wgmma of the flash forward's operand form ``form`` through the
    test-only entry point of csrc/flash_fwd.cu."""
    c = torch.empty(64, 128 if form == 0 else n, device="cuda")
    fn = _build.function("flash_fwd", "rt_wgmma_check", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    code = fn(form, a.data_ptr() if a is not None else None,
              a32.data_ptr() if a32 is not None else None, b.data_ptr(),
              c.data_ptr(), n, torch.cuda.current_stream().cuda_stream)
    _build.check("flash_fwd", code, "rt_wgmma_check")
    torch.cuda.synchronize()
    return c


# bf16 products are exact in fp32; the sums over n <= 128 terms of size ~1
# differ from torch.matmul's only in order.
WGMMA_TOL = 1e-3


@pytest.mark.parametrize("n", [64, 128])
def test_wgmma_k_major_descriptors_match_matmul(cuda, n):
    """S = Q K^T's form: A [64, n] and B [128, n] both K-major in 128-byte
    swizzled shared memory (TMA), stepped over n in k16 slices."""
    gen = torch.Generator(device="cuda").manual_seed(n)
    a = _randn(gen, 64, n, dtype=torch.bfloat16)
    b = _randn(gen, 128, n, dtype=torch.bfloat16)
    c = _wgmma_check(0, a, None, b, n)
    ref = torch.matmul(a.float(), b.float().T)
    assert (c - ref).abs().max().item() <= WGMMA_TOL


@pytest.mark.parametrize("n", [64, 128])
def test_wgmma_mn_major_transposed_descriptor_matches_matmul(cuda, n):
    """O += P V's form: A from registers (fp32 accumulator fragments
    packed to bf16, as P is), B = V [128 keys, n] MN-major through the
    transposed descriptor."""
    gen = torch.Generator(device="cuda").manual_seed(100 + n)
    a32 = torch.randn(64, 128, generator=gen, device="cuda")
    b = _randn(gen, 128, n, dtype=torch.bfloat16)
    c = _wgmma_check(1, None, a32, b, n)
    ref = torch.matmul(a32.bfloat16().float(), b.float())
    assert (c - ref).abs().max().item() <= WGMMA_TOL


def _paged_case(B, H, Hkv, D, page, lens, P, dtype, seed):
    """q, kv_pages over shuffled pages, a [B, P] block table naming each
    slot's pages, int32 seq_lens (lens past P * page reach the table's
    end)."""
    rng = np.random.default_rng(seed)
    NP = B * P + 1
    bt = rng.permutation(np.arange(1, NP))[:B * P].reshape(B, P)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv = _randn(gen, NP, page, 2 * Hkv, D, dtype=dtype)
    q = _randn(gen, B, H, D, dtype=dtype)
    return (q, kv, torch.from_numpy(bt.astype(np.int32)).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def _paged_errs(out, ref, sl):
    """(max abs error, worst row's ||out - ref|| / ||ref||) over the live
    slots, and whether the inactive slots' rows are zeros."""
    live = sl > 0
    a, b = out[live].float(), ref[live].float()
    rel = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
    zeros = bool((out[~live] == 0).all())
    return (a - b).abs().max().item(), rel, zeros


# Page 16, a table of 8 pages (reach 128): lengths 1, a page, a page + 1,
# either side of the boundary of a forced 3-way split's 2-page runs (32,
# 64), the reach, past it, and an inactive slot.
EDGE_LENS = [1, 16, 17, 31, 32, 33, 63, 64, 65, 128, 200, 0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,Hkv,D", [
    (16, 8, 128), (8, 8, 64), (8, 2, 64), (16, 2, 128), (32, 4, 128),
    (8, 1, 64), (4, 4, 128), (16, 4, 64), (4, 2, 32), (8, 8, 32),
    (8, 1, 32)])
@pytest.mark.parametrize("splits", [1, 3, None])
def test_paged_decode_matches_plain(cuda, monkeypatch, dtype, H, Hkv, D,
                                    splits):
    """The kernel at a forced split count (None: the split rule's) against
    the plain version, at the edge lengths, in two calls of half the slots
    each (so that a forced layout's B * Hkv * splits stays within the
    workspace, BLOCKS_PER_SM blocks an SM)."""
    if splits is not None:
        monkeypatch.setattr(paged, "_splits", lambda *_a: splits)
        monkeypatch.setattr(paged, "_LAUNCH", {})
    q, kv, bt, sl = _paged_case(len(EDGE_LENS), H, Hkv, D, 16, EDGE_LENS,
                                8, dtype, seed=H + Hkv + D)
    half = len(EDGE_LENS) // 2
    assert half * Hkv * (splits or 1) <= \
        paged.BLOCKS_PER_SM * paged._sm_count(q.device)
    before = paged.paged_decode.launches
    out = torch.cat([paged.paged_decode(q[s].clone(), kv, bt[s].clone(),
                                        sl[s].clone(), 16)
                     for s in (slice(0, half), slice(half, None))])
    assert paged.paged_decode.launches == before + 2
    ref = paged._exact_path(q, kv, bt, sl, 16)
    torch.cuda.synchronize()
    err, rel, zeros = _paged_errs(out, ref, sl)
    assert out.dtype == dtype and err <= TOL[dtype] \
        and rel <= ROW_REL_TOL[dtype] and zeros, (err, rel, zeros)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,lens", [
    # The engine's table width (P = 128) with serving's lengths.
    (32, 16, 8, "256-384"),
    # Long context: one slot at llama_1b's max_seq_len, 32 splits.
    (1, 16, 8, "2048"),
    (4, 16, 8, "1000-2048"),
    # The 7B preset's heads (G 1).
    (8, 32, 32, "512-1024"),
    # P = 128 with short lengths: most of the table is dead width.
    (6, 16, 8, "1-40"),
])
def test_paged_decode_at_the_engine_width(cuda, dtype, B, H, Hkv, lens):
    lo, _, hi = lens.partition("-")
    rng = np.random.default_rng(B)
    ln = rng.integers(int(lo), int(hi or lo) + 1, size=B).tolist()
    q, kv, bt, sl = _paged_case(B, H, Hkv, 128, 16, ln, 128, dtype, seed=B)
    out = paged.paged_decode(q, kv, bt, sl, 16)
    ref = paged._exact_path(q, kv, bt, sl, 16)
    torch.cuda.synchronize()
    err, rel, _ = _paged_errs(out, ref, sl)
    assert err <= TOL[dtype] and rel <= ROW_REL_TOL[dtype], (err, rel)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_one_live_slot_of_the_engines(cuda, dtype):
    """The tensors the engine sends with one request live: its 32 slots at
    P = 128, one at llama_1b's max_seq_len, 31 inactive (one split)."""
    lens = [0] * 32
    lens[7] = 2048
    q, kv, bt, sl = _paged_case(32, 16, 8, 128, 16, lens, 128, dtype,
                                seed=77)
    out = paged.paged_decode(q, kv, bt, sl, 16)
    ref = paged._exact_path(q, kv, bt, sl, 16)
    torch.cuda.synchronize()
    err, rel, zeros = _paged_errs(out, ref, sl)
    assert err <= TOL[dtype] and rel <= ROW_REL_TOL[dtype] and zeros, \
        (err, rel, zeros)


def test_paged_decode_is_deterministic(cuda):
    """The partials merge in split order: two calls are bit-equal."""
    q, kv, bt, sl = _paged_case(4, 16, 8, 128, 16, [2048, 900, 17, 0], 128,
                                torch.bfloat16, seed=5)
    assert paged._splits(q.device, 4, 8, 128) > 1
    a = paged.paged_decode(q, kv, bt, sl, 16)
    b = paged.paged_decode(q, kv, bt, sl, 16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_paged_decode_after_a_call_of_another_shape(cuda):
    """Each call leaves the arrival counters at 0, and every split layout
    uses the one workspace allocated for the device: calls of other shapes
    in turn stay right, and the workspace is never replaced."""
    cases = [(2, 8, 8, 64, [64, 65]), (1, 16, 8, 128, [2048]),
             (32, 16, 8, 128, [300] * 32), (3, 32, 4, 128, [700, 0, 2000]),
             (1, 16, 8, 128, [1500])]
    first = None
    for i, (B, H, Hkv, D, lens) in enumerate(cases * 2):
        q, kv, bt, sl = _paged_case(B, H, Hkv, D, 16, lens, 128,
                                    torch.bfloat16, seed=50 + i)
        out = paged.paged_decode(q, kv, bt, sl, 16)
        ref = paged._exact_path(q, kv, bt, sl, 16)
        torch.cuda.synchronize()
        err, rel, zeros = _paged_errs(out, ref, sl)
        assert err <= TOL[torch.bfloat16] and rel <= ROW_REL_TOL[
            torch.bfloat16] and zeros, (i, err, rel)
        ws, blocks = paged._WORKSPACE[
            (q.device, torch.cuda.current_stream().cuda_stream)]
        first = first or (ws, ws.data_ptr())
        assert ws is first[0] and ws.data_ptr() == first[1]
        counters = ws[:blocks // 2].view(torch.int32)
        assert int(counters.abs().sum()) == 0


def test_paged_decode_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.randn(2, 8, 128, device="cuda", dtype=torch.bfloat16)
    kv = torch.randn(5, 16, 4, 128, device="cuda", dtype=torch.bfloat16)
    bt = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    sl = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="page_size"):
        paged.paged_decode(q, kv, bt, sl, 8)
    with pytest.raises(ValueError, match="page_size >= 1"):
        paged.paged_decode(q, kv[:, :0], bt, sl, 0)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        paged.paged_decode(q.half(), kv.half(), bt, sl, 16)
    with pytest.raises(ValueError, match="one dtype"):
        paged.paged_decode(q, kv.float(), bt, sl, 16)
    with pytest.raises(ValueError, match="head_dim"):
        paged.paged_decode(q[..., :16].contiguous(),
                           kv[..., :16].contiguous(), bt, sl, 16)
    with pytest.raises(ValueError, match="contiguous"):
        paged.paged_decode(q.transpose(0, 1).contiguous().transpose(0, 1),
                           kv, bt, sl, 16)
    with pytest.raises(ValueError, match="must be on"):
        paged.paged_decode(q, kv, bt.cpu(), sl, 16)
    with pytest.raises(ValueError, match="seq_lens"):
        paged.paged_decode(q, kv, bt, sl[:1], 16)
    with pytest.raises(ValueError, match="1 page"):
        paged.paged_decode(q, kv, bt[:, :0], sl, 16)
    # The C entry refuses a split layout the workspace cannot hold, and
    # splits > 1 without a workspace.
    ws, blocks = paged._workspace(q.device,
                                  torch.cuda.current_stream().cuda_stream)
    prepare = _build.function("paged_decode", "rt_paged_decode_prepare",
                              [ctypes.c_void_p])
    for ptr, B in ((ws.data_ptr(), blocks // 4 + 1), (None, 1)):
        launch = paged._Launch(ptr, blocks, 1, B, 8, 2, 128, 128, 16, 2)
        assert prepare(ctypes.addressof(launch)) != 0
    launch = paged._Launch(ws.data_ptr(), blocks, 1, blocks // 4, 8, 2, 128,
                           128, 16, 2)
    assert prepare(ctypes.addressof(launch)) == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 4, 64, 16, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_fwd(q, q, q)
    q = torch.randn(1, 4, 64, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        attn.flash_fwd(q, q, q)
    q = torch.randn(1, 64, 4, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attn.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="must be on"):
        attn.flash_fwd(q.contiguous(), q.contiguous().cpu(),
                       q.contiguous())
    qd = torch.randn(2, 6, 64, device="cuda")
    kv = torch.randn(5, 16, 4, 64, device="cuda")    # Hkv = 2: group 3
    bt = torch.zeros(2, 1, dtype=torch.int32, device="cuda")
    sl = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="H/Hkv"):
        paged.paged_decode(qd, kv, bt, sl, 16)
    with pytest.raises(ValueError, match="int32"):
        paged.paged_decode(qd[:, :4].contiguous(), kv, bt.long(), sl, 16)


def _grad_err(got, ref):
    """Max abs error relative to the reference's largest magnitude: dK and
    dV sum over every query (and the GQA group), so their scale grows with
    S and an absolute bound would mean different things at each shape."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-6)).item()


# Relative to the gradient's largest magnitude: fp32 sums in another order
# (1e-4); bf16 rounds P, dS and the outputs to bf16 (2**-8 = 4e-3 per
# rounding; 2e-2 leaves room for the few P entries that round apart).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The worst row's ||got - ref|| / ||ref|| (per query row of dq, per key row
# of dk and dv), a row's ||ref|| taken as at least BWD_ROW_FLOOR of the
# largest row's: chip_smoke.py's TOL_BWD_ROW_REL and its reasons.
BWD_ROW_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_ROW_FLOOR = 1e-3


def _row_rel_err(got, ref):
    a, b = got.float(), ref.float()
    norm = b.norm(dim=-1)
    least = max(BWD_ROW_FLOOR * norm.max().item(), 1e-30)
    return ((a - b).norm(dim=-1) / norm.clamp_min(least)).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,causal,q_offset", [
    (1, 16, 16, 256, 256, True, 0),
    (1, 16, 8, 1000, 1000, True, 0),
    (1, 8, 2, 256, 256, False, 0),
    (2, 4, 2, 77, 300, False, 0),
    (1, 16, 8, 128, 640, True, 512),
    (3, 8, 1, 33, 33, True, 0),
    # The bf16 kernels' tiles at their edges: 64-key and 128-row tiles of
    # the dq kernel, 128-key and 64-row tiles of the dk/dv kernel.  (Sk = 1
    # is left out: there dK = 0 exactly and only rounding residue remains.)
    (2, 4, 2, 1, 129, True, 128),          # one query row
    (1, 8, 2, 63, 63, True, 0),
    (1, 8, 2, 65, 65, True, 0),
    (1, 4, 4, 127, 127, True, 0),
    (1, 8, 2, 129, 129, True, 0),
    (1, 8, 2, 1000, 1000, True, 0),        # GQA 8/2
    (1, 8, 2, 65, 129, True, 64),          # q_offset, Sq != Sk
    (1, 4, 2, 127, 1000, True, 873),
    (2, 4, 1, 129, 63, False, 0),
    (1, 4, 2, 1000, 65, False, 0),
])
def test_flash_bwd_matches_plain(cuda, dtype, D, B, H, Hkv, Sq, Sk, causal,
                                 q_offset):
    gen = torch.Generator(device="cuda").manual_seed(Sq * 11 + D)
    q = _randn(gen, B, H, Sq, D, dtype=dtype)
    k = _randn(gen, B, Hkv, Sk, D, dtype=dtype)
    v = _randn(gen, B, Hkv, Sk, D, dtype=dtype)
    dout = _randn(gen, B, H, Sq, D, dtype=dtype)
    out, lse = attn.flash_fwd(q, k, v, causal=causal, q_offset=q_offset,
                              need_lse=True)
    before = (attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches)
    got = attn.flash_bwd(q, k, v, out, lse, dout, causal=causal,
                         q_offset=q_offset)
    assert (attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    ref = attn._flash_bwd_plain(q, k, v, out, lse, dout, causal,
                                1 / math.sqrt(D), q_offset)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert _grad_err(g, r) <= BWD_TOL[dtype], (name, _grad_err(g, r))
        assert _row_rel_err(g, r) <= BWD_ROW_REL_TOL[dtype], (
            name, _row_rel_err(g, r))


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_bwd_is_deterministic(cuda, D):
    """No atomics: two calls on the same inputs give bit-equal dq, dk and
    dv (GQA, so the dk/dv kernel sums over a group)."""
    gen = torch.Generator(device="cuda").manual_seed(D)
    q = _randn(gen, 2, 16, 1000, D, dtype=torch.bfloat16)
    k = _randn(gen, 2, 4, 1000, D, dtype=torch.bfloat16)
    v = _randn(gen, 2, 4, 1000, D, dtype=torch.bfloat16)
    dout = _randn(gen, 2, 16, 1000, D, dtype=torch.bfloat16)
    out, lse = attn.flash_fwd(q, k, v, need_lse=True)
    first = attn.flash_bwd(q, k, v, out, lse, dout)
    second = attn.flash_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


RING_BLOCKS = 4


class _Ctx:
    """Stands in for autograd's context to call a Function's forward and
    backward directly."""

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_ring_steps_match_plain(cuda, dtype, D, causal):
    """Ring attention over 4 blocks of one sequence
    (ops.ring_attention.ring_attention_local: the diagonal block causal,
    earlier blocks full, the partials merged by LSE; the backward through
    flash_bwd with the merged output and LSE).

    Each backward step's kernel calls against their plain version on the
    same inputs (the block's q, k, v and dO, the merged O and LSE), as
    test_flash_bwd_matches_plain holds one call.  The merged output, and
    the gradients summed over the steps, against the same steps on CPU
    copies (each call's plain version); the sums to the largest gradient
    (BWD_TOL) and not row by row: a causal row that sees few keys has dq
    near 0 as a sum of steps' terms that cancel, and keeps each term's
    rounding.  Through autograd: one kernel launch a visible block and
    direction, and the same gradients."""
    from ray_tpu_torch.ops.ring_attention import ring_attention_local
    ring = importlib.import_module("ray_tpu_torch.ops.ring_attention")
    gen = torch.Generator(device="cuda").manual_seed(D + causal)
    B, H, Hkv, S, n = 2, 8, 4, 1024, RING_BLOCKS
    q = _randn(gen, B, H, S, D, dtype=dtype)
    k = _randn(gen, B, Hkv, S, D, dtype=dtype)
    v = _randn(gen, B, Hkv, S, D, dtype=dtype)
    dout = _randn(gen, B, H, S, D, dtype=dtype)
    scale = 1 / math.sqrt(D)
    card, plain = _Ctx(), _Ctx()
    out = ring._RingLocal.forward(card, q, k, v, n, causal, scale)
    ref = ring._RingLocal.forward(plain, q.cpu(), k.cpu(), v.cpu(), n,
                                  causal, scale).cuda()
    card.args = plain.args = (n, causal, scale)
    plain.saved_tensors = tuple(t.cpu() for t in card.saved_tensors)
    got = ring._RingLocal.backward(card, dout)[:3]
    want = [g.cuda() for g in
            ring._RingLocal.backward(plain, dout.cpu())[:3]]
    _q, _k, _v, o_merged, lse_merged = card.saved_tensors
    blocks = [ring._blocks(t, n) for t in (q, k, v, o_merged, dout)]
    lses = [t.contiguous() for t in lse_merged.chunk(n, 2)]
    for my in range(n):
        for src in range(n):
            if not ring._visible(my, src, causal):
                continue
            args = (blocks[0][my], blocks[1][src], blocks[2][src],
                    blocks[3][my], lses[my], blocks[4][my])
            step = attn.flash_bwd(*args, causal=causal and src == my,
                                  scale=scale)
            step_ref = attn._flash_bwd_plain(*args, causal and src == my,
                                             scale, 0)
            for name, g, r in zip(("dq", "dk", "dv"), step, step_ref):
                assert _grad_err(g, r) <= BWD_TOL[dtype], (my, src, name)
                assert _row_rel_err(g, r) <= BWD_ROW_REL_TOL[dtype], (
                    my, src, name, _row_rel_err(g, r))
    before = (attn.flash_fwd.launches, attn.flash_bwd_dq.launches,
              attn.flash_bwd_dkv.launches)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ring_attention_local(*ts, n, causal=causal)
    through = torch.autograd.grad(o, ts, dout)
    visible = n * (n + 1) // 2 if causal else n * n
    assert (attn.flash_fwd.launches - before[0],
            attn.flash_bwd_dq.launches - before[1],
            attn.flash_bwd_dkv.launches - before[2]) == (visible,) * 3
    torch.cuda.synchronize()
    assert torch.equal(o, out)
    assert all(torch.equal(a, b) for a, b in zip(through, got))
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert _row_rel_err(out, ref) <= ROW_REL_TOL[dtype]
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype, name
        assert _grad_err(g, r) <= BWD_TOL[dtype], (name, _grad_err(g, r))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_ring_earlier_block_by_q_offset_equals_full(cuda, dtype, D):
    """An earlier ring block is every key visible: causal with q_offset =
    (my - src) * S_l (here 2 blocks back, at the ring's block length)
    gives what causal=False gives, forward and backward."""
    gen = torch.Generator(device="cuda").manual_seed(3 * D)
    B, H, Hkv, Sl = 2, 8, 4, 512
    q = _randn(gen, B, H, Sl, D, dtype=dtype)
    k = _randn(gen, B, Hkv, Sl, D, dtype=dtype)
    v = _randn(gen, B, Hkv, Sl, D, dtype=dtype)
    dout = _randn(gen, B, H, Sl, D, dtype=dtype)
    full = attn.flash_fwd(q, k, v, causal=False, need_lse=True)
    shifted = attn.flash_fwd(q, k, v, causal=True, q_offset=2 * Sl,
                             need_lse=True)
    g_full = attn.flash_bwd(q, k, v, *full, dout, causal=False)
    g_shifted = attn.flash_bwd(q, k, v, *full, dout, causal=True,
                               q_offset=2 * Sl)
    torch.cuda.synchronize()
    assert (shifted[0].float() - full[0].float()).abs().max().item() \
        <= TOL[dtype]
    assert (shifted[1] - full[1]).abs().max().item() <= TOL[torch.float32]
    for name, a, b in zip(("dq", "dk", "dv"), g_shifted, g_full):
        assert _grad_err(a, b) <= BWD_TOL[dtype], (name, _grad_err(a, b))


def test_moe_layer_is_deterministic(cuda):
    """The MoE layer's dispatch and combine are gathers both ways (no
    atomics): two forward and backward passes give equal bits."""
    from ray_tpu_torch.ops.moe import moe_layer
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, E, X, M = 2, 512, 256, 8, 512
    shapes = ((B, S, E), (E, X), (X, E, M), (X, E, M), (X, M, E))
    arrays = [_randn(gen, *sh, dtype=torch.bfloat16) * 0.1 for sh in shapes]
    runs = []
    for _ in range(2):
        ts = [a.clone().requires_grad_(True) for a in arrays]
        out, aux = moe_layer(*ts, k=2, capacity_factor=1.25)
        grads = torch.autograd.grad((out.float() ** 2).sum() + aux, ts)
        runs.append((out, aux) + grads)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_grad_goes_through_the_kernels(cuda, dtype):
    """autograd through flash_attention launches the forward once and each
    backward kernel once, and equals autograd through the plain attention."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = _randn(gen, 2, 8, 200, 64, dtype=dtype)
    k = _randn(gen, 2, 4, 200, 64, dtype=dtype)
    v = _randn(gen, 2, 4, 200, 64, dtype=dtype)
    # A strided upstream gradient, as the output projection's arrives.
    dout = _randn(gen, 2, 200, 8, 64, dtype=dtype).transpose(1, 2)
    counts = lambda: (attn.flash_fwd.launches, attn.flash_bwd_dq.launches,
                      attn.flash_bwd_dkv.launches)
    before = counts()
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(attn.flash_attention(*qkv), qkv, dout)
    assert counts() == tuple(n + 1 for n in before)
    qkv = [t.float().clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(attn.reference_attention(*qkv), qkv,
                              dout.float())
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        assert _grad_err(g, r) <= BWD_TOL[dtype]
    with torch.no_grad():
        attn.flash_attention(q, k, v)
    assert counts()[0] == before[0] + 2 and counts()[1] == before[1] + 1


def _bwd_wgmma_check(form, a, a32, b, n):
    """One wgmma of the flash backward's operand form ``form`` through the
    test-only entry point of csrc/flash_bwd.cu."""
    c = torch.empty(64, 64 if form == 0 else n, device="cuda")
    fn = _build.function("flash_bwd", "rt_bwd_wgmma_check", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    code = fn(form, a.data_ptr() if a is not None else None,
              a32.data_ptr() if a32 is not None else None, b.data_ptr(),
              c.data_ptr(), n, torch.cuda.current_stream().cuda_stream)
    _build.check("flash_bwd", code, "rt_bwd_wgmma_check")
    torch.cuda.synchronize()
    return c


@pytest.mark.parametrize("n", [64, 128])
def test_bwd_wgmma_ss_n64_descriptors_match_matmul(cuda, n):
    """S^T = K Q^T's form (and S = Q K^T's): SS m64n64k16, A the second
    64 rows of a [128, n] tile and B a [64, n] tile, both K-major."""
    gen = torch.Generator(device="cuda").manual_seed(200 + n)
    a = _randn(gen, 128, n, dtype=torch.bfloat16)
    b = _randn(gen, 64, n, dtype=torch.bfloat16)
    c = _bwd_wgmma_check(0, a, None, b, n)
    ref = torch.matmul(a[64:].float(), b.float().T)
    assert (c - ref).abs().max().item() <= WGMMA_TOL


@pytest.mark.parametrize("n", [64, 128])
def test_bwd_wgmma_rs_mn_major_64_rows_matches_matmul(cuda, n):
    """dV += P^T dO's form (and dQ += dS K's): A from registers (a 64 x 64
    accumulator packed to bf16), B [64, n] MN-major."""
    gen = torch.Generator(device="cuda").manual_seed(300 + n)
    a32 = torch.randn(64, 64, generator=gen, device="cuda")
    b = _randn(gen, 64, n, dtype=torch.bfloat16)
    c = _bwd_wgmma_check(1, None, a32, b, n)
    ref = torch.matmul(a32.bfloat16().float(), b.float())
    assert (c - ref).abs().max().item() <= WGMMA_TOL


@pytest.mark.parametrize("n", [64, 128])
def test_bwd_wgmma_one_tile_k_major_then_mn_major_matches_matmul(cuda, n):
    """dK += dS^T Q reads the Q tile that S^T = K Q^T read: the same
    swizzled [64, n] tile K-major, then MN-major."""
    gen = torch.Generator(device="cuda").manual_seed(400 + n)
    a = _randn(gen, 128, n, dtype=torch.bfloat16) * 0.25
    b = _randn(gen, 64, n, dtype=torch.bfloat16)
    c = _bwd_wgmma_check(2, a, None, b, n)
    s = torch.matmul(a[64:].float(), b.float().T)
    ref = torch.matmul(s.bfloat16().float(), b.float())
    # s rounds to bf16 in both; a sum of n products may round apart.
    assert ((c - ref).abs().max() / ref.abs().max()).item() <= 1e-2


def test_flash_bwd_refuses_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 4, 64, 64, device="cuda")
    out, lse = attn.flash_fwd(q, q, q, need_lse=True)
    with pytest.raises(ValueError, match="lse"):
        attn.flash_bwd(q, q, q, out, lse.double(), q)
    with pytest.raises(ValueError, match="dout"):
        attn.flash_bwd(q, q, q, out, lse, q.bfloat16())
    with pytest.raises(ValueError, match="out"):
        attn.flash_bwd(q, q, q, out[:, :2], lse, q)
    delta = torch.zeros_like(lse)
    with pytest.raises(ValueError, match="must be on"):
        attn.flash_bwd_dq(q, q.cpu(), q, q, q, lse, causal=True,
                          scale=0.125, q_offset=0)
    with pytest.raises(ValueError, match="delta"):
        attn.flash_bwd_dkv(q, q, q, q, lse, delta[:, :2], causal=True,
                           scale=0.125, q_offset=0)


def test_engine_greedy_through_kernels_equals_plain_path(cuda):
    from ray_tpu_torch.llm import InferenceEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    cfg = LlamaConfig(vocab_size=256, hidden=128, layers=2, heads=4,
                      kv_heads=2, head_dim=64, mlp_dim=256, max_seq_len=128,
                      dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    prompts = [[3, 17, 92, 5, 41], list(range(1, 40))]
    outs = []
    for c in (cfg, cfg.replace(attention_impl="reference")):
        eng = InferenceEngine(params, c, device="cuda", max_slots=2,
                              page_size=16, num_pages=32,
                              prefill_buckets=(64,))
        outs.append(eng.generate(prompts, SamplingParams(max_tokens=10)))
    assert outs[0] == outs[1]


def _paged_pair(seed):
    """Two different paged inputs the split rule splits (the workspace is
    used), at llama_1b's heads."""
    rng = np.random.default_rng(seed)
    return [_paged_case(4, 16, 8, 128, 16,
                        rng.integers(1000, 2049, size=4).tolist(), 128,
                        torch.bfloat16, seed=seed + i) for i in range(2)]


def test_paged_decode_on_two_streams_never_shares_a_workspace(cuda):
    """Launches in flight on two streams at once: each stream has its own
    workspace, and both outputs equal the plain version every time."""
    a, b = _paged_pair(300)
    assert paged._splits(a[0].device, 4, 8, 128) > 1
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    refs = [paged._exact_path(*x, 16) for x in (a, b)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(20):
        for s, x in zip(streams, (a, b)):
            with torch.cuda.stream(s):
                outs.append(paged.paged_decode(*x, 16))
    torch.cuda.synchronize()
    ws = [paged._WORKSPACE[(a[0].device, s.cuda_stream)][0]
          for s in streams]
    assert ws[0].data_ptr() != ws[1].data_ptr()
    for i, out in enumerate(outs):
        err, rel, _ = _paged_errs(out, refs[i % 2], (a, b)[i % 2][3])
        assert err <= TOL[torch.bfloat16] and rel <= ROW_REL_TOL[
            torch.bfloat16], (i, err, rel)


@pytest.mark.parametrize("streams", [1, 2])
def test_paged_first_launch_from_two_threads(cuda, monkeypatch, streams):
    """Two threads make their first paged launch of one shape at once (as
    two serving replicas' first decodes do), on one stream or on two:
    both outputs equal the plain version, and each (stream, shape) key has
    exactly one prepared launch and each stream one workspace, the first
    made (a replaced entry would be freed while its maker still passes its
    address to the kernel)."""
    import threading
    monkeypatch.setattr(paged, "_LAUNCH", {})
    monkeypatch.setattr(paged, "_WORKSPACE", {})
    a, b = _paged_pair(700)
    assert paged._splits(a[0].device, 4, 8, 128) > 1
    pool = [torch.cuda.Stream() for _ in range(streams)]
    for s in pool:
        s.wait_stream(torch.cuda.current_stream())
    barrier = threading.Barrier(2)
    outs = [None, None]
    errors = []

    def first_launch(i, x):
        try:
            with torch.cuda.stream(pool[i % streams]):
                barrier.wait(timeout=60)
                outs[i] = paged.paged_decode(*x, 16)
                torch.cuda.current_stream().synchronize()
        except Exception as exc:  # reported below, in the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=first_launch, args=(i, x))
               for i, x in enumerate((a, b))]
    try:
        for t in threads:
            t.start()
    finally:
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for out, x in zip(outs, (a, b)):
        err, rel, _ = _paged_errs(out, paged._exact_path(*x, 16), x[3])
        assert err <= TOL[torch.bfloat16] and rel <= ROW_REL_TOL[
            torch.bfloat16], (err, rel)
    keys = list(paged._LAUNCH)
    assert len(keys) == len(set(keys)) == streams
    assert sorted(k[1] for k in keys) == sorted(s.cuda_stream for s in pool)
    assert len(paged._WORKSPACE) == streams
    for key, (launch, addr) in paged._LAUNCH.items():
        assert launch.ws == paged._WORKSPACE[key[:2]][0].data_ptr()
        assert addr == ctypes.addressof(launch)


def test_a_captured_paged_graph_beside_an_eager_call(cuda):
    """A CUDA graph of paged_decode replayed on one stream while an eager
    call runs on another: both right."""
    a, b = _paged_pair(400)
    side, other = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up on the capture stream
        paged.paged_decode(*a, 16)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out_a = paged.paged_decode(*a, 16)
    other.wait_stream(torch.cuda.current_stream())
    outs_b = []
    for _ in range(10):
        graph.replay()
        with torch.cuda.stream(other):
            outs_b.append(paged.paged_decode(*b, 16))
    torch.cuda.synchronize()
    for out, x in [(out_a, a)] + [(o, b) for o in outs_b]:
        err, rel, _ = _paged_errs(out, paged._exact_path(*x, 16), x[3])
        assert err <= TOL[torch.bfloat16] and rel <= ROW_REL_TOL[
            torch.bfloat16], (err, rel)


def test_a_capture_never_allocates_the_workspace(cuda):
    """A capture on a stream that has no workspace yet raises and says how
    to warm up; it allocates nothing."""
    a, _b = _paged_pair(500)
    fresh = torch.cuda.Stream(priority=-1)
    key = (a[0].device, fresh.cuda_stream)
    paged._WORKSPACE.pop(key, None)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture stream before"):
        with torch.cuda.graph(graph, stream=fresh):
            paged.paged_decode(*a, 16)
    assert key not in paged._WORKSPACE
    torch.cuda.synchronize()


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 40)])
def test_decode_chunk_has_no_host_sync(cuda, temperature, top_k):
    """Eight decode steps with on-device sampling: torch's sync debug mode
    reports no synchronizing call inside the chunk."""
    import warnings

    from ray_tpu_torch.llm import _model
    from ray_tpu_torch.models.llama import llama_tiny, init_params
    cfg = llama_tiny().replace(dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         param_dtype=torch.bfloat16, device="cuda")
    P = 4
    kv = tuple(torch.zeros((P + 1, 16, 2 * cfg.kv_heads, cfg.head_dim),
                           dtype=cfg.dtype, device="cuda")
               for _ in range(cfg.layers))
    bt = torch.arange(1, P + 1, dtype=torch.int32, device="cuda")[None]
    tok = torch.tensor([5], dtype=torch.int32, device="cuda")
    pos = torch.tensor([20], dtype=torch.int32, device="cuda")
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    _model.decode_chunk(params, kv, tok, pos, bt, active, gen, cfg, 16, 8,
                        temperature, top_k)            # warm-up
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out, _p, _kv = _model.decode_chunk(
                params, kv, tok, pos, bt, active, gen, cfg, 16, 8,
                temperature, top_k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, syncs
    assert out.shape == (8, 1)


def test_llama_tiny_serves_and_trains_through_the_d32_kernels(cuda):
    """The JAX preset llama_tiny (head_dim 32) through the engine and one
    training step on the card, kernels against the plain path."""
    from ray_tpu_torch.llm import InferenceEngine, SamplingParams
    from ray_tpu_torch.models.llama import init_params, llama_tiny
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    cfg = llama_tiny().replace(dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    prompts = [[3, 17, 92, 5, 41], list(range(1, 40))]
    before = (attn.flash_fwd.launches, paged.paged_decode.launches)
    outs = []
    for c in (cfg, cfg.replace(attention_impl="reference")):
        eng = InferenceEngine(params, c, device="cuda", max_slots=2,
                              page_size=16, num_pages=32,
                              prefill_buckets=(64,))
        outs.append(eng.generate(prompts, SamplingParams(max_tokens=10)))
    assert outs[0] == outs[1]
    assert attn.flash_fwd.launches > before[0]
    assert paged.paged_decode.launches > before[1]
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32)}
    losses = []
    for c in (cfg.replace(remat=False),
              cfg.replace(remat=False, attention_impl="reference")):
        init_fn, step_fn, place = make_lm_train_step(c, build_mesh())
        p, o = init_fn(torch.Generator(device="cuda").manual_seed(1))
        losses.append(step_fn(p, o, place(batch))[2])
    for k in ("loss", "grad_norm"):
        a, b = losses[0][k].item(), losses[1][k].item()
        assert abs(a - b) <= 1e-5 * abs(b), (k, a, b)
    odd = cfg.replace(head_dim=16)
    with pytest.raises(ValueError, match='attention_impl="reference"'):
        InferenceEngine(params, odd, device="cuda")
    with pytest.raises(ValueError, match='attention_impl="reference"'):
        make_lm_train_step(odd, build_mesh())


# ----------------------------------------------------------------------- RL
# ray_tpu_torch.rl has no kernel of its own: these hold its algorithms on
# the card to the same algorithms on the CPU (chip_smoke.py's rl_exact
# cases, TF32 off as the ``cuda`` fixture sets it, and cuDNN's too) and
# count its host syncs.

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rl_offline_data(tmp_path_factory):
    return _chip_smoke()._rl_offline_data(
        str(tmp_path_factory.mktemp("rl")))


@pytest.fixture
def no_tf32(cuda):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("name", ["PPO", "DQN", "SAC", "TQC", "IMPALA",
                                  "APPO", "BC", "MARWIL", "CQL", "IQL",
                                  "MultiAgentPPO"])
def test_rl_update_on_the_card_matches_cpu(no_tf32, rl_offline_data, name):
    cs = _chip_smoke()
    p_err, m_err = cs.rl_card_vs_cpu(name, rl_offline_data)
    assert p_err <= cs.RL_TOL and m_err <= cs.RL_TOL, (p_err, m_err)


def test_rl_cnn_and_gru_on_the_card_match_cpu(no_tf32):
    cs = _chip_smoke()
    errs = cs.rl_models_card_vs_cpu()
    assert all(v <= cs.RL_TOL for v in errs.values()), errs


def test_torch_cartpole_on_the_card_matches_numpy_env(cuda):
    res = _chip_smoke().rl_cartpole_card_vs_numpy()
    assert res["state_mismatches"] == 0, res
    assert res["terminated_mismatches"] == 0 and res["rewards_all_one"]


def test_rl_host_syncs(cuda):
    """One host sync an env step in the runner (plus one for the bootstrap
    values of a sample), one a learner update, none inside a device
    rollout."""
    from ray_tpu_torch.rl import (DiscretePolicyModule, EnvRunner,
                                  RLModuleSpec, StatelessGuess,
                                  TorchCartPoleVector, TorchLearner)
    from ray_tpu_torch.rl.ppo import ppo_loss
    cs = _chip_smoke()
    runner = EnvRunner(lambda: StatelessGuess(4), num_envs=4,
                       device="cuda")
    batch, syncs = cs._rl_syncs(lambda: runner.sample(16))
    assert syncs == 17
    learner = TorchLearner(DiscretePolicyModule(RLModuleSpec(4, 4)),
                           ppo_loss, device="cuda")
    n = 64
    mb = {"obs": batch["obs"].reshape(n, 4),
          "actions": batch["actions"].reshape(n),
          "logp_old": batch["logp"].reshape(n),
          "advantages": np.ones(n, np.float32),
          "value_targets": np.zeros(n, np.float32),
          "clip_param": np.array([0.2], np.float32),
          "vf_coeff": np.array([0.5], np.float32),
          "ent_coeff": np.array([0.01], np.float32)}
    _m, syncs = cs._rl_syncs(lambda: learner.update(mb))
    assert syncs == 1
    vec = TorchCartPoleVector(256, seed=0, device="cuda")
    policy = lambda p, obs, g: torch.randint(0, 2, (obs.shape[0],),
                                             generator=g, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _traj, syncs = cs._rl_syncs(lambda: vec.rollout(None, policy, 16, gen))
    assert syncs == 0


def test_llama_fed_from_a_dataset_equals_from_memory(cuda, tmp_path):
    """Two steps of llama_tiny (bf16, full remat, the flash kernels) fed
    from a Dataset: raw token shards through read tasks, rows, the
    two-stage shuffle over the port's task workers, ``iter_batches`` and
    ``device_put_iterator``; the same losses, bit for bit, as the same
    host batches placed from memory (``chip_smoke.fed_vs_memory``, the
    helper of the ``data_train`` phase)."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)      # task workers import chip_smoke
    import chip_smoke as cs
    import ray_tpu_torch as rtt
    from ray_tpu_torch.models.llama import llama_tiny
    cfg = llama_tiny().replace(dtype=torch.bfloat16, remat=True,
                               attention_impl="flash")
    row = cfg.max_seq_len + 1
    cs.write_token_corpus(str(tmp_path), 2, 16, row, cfg.vocab_size, 1)
    rtt.init(num_cpus=2)
    try:
        res = cs.fed_vs_memory(cfg, cs.token_pipeline(str(tmp_path), row),
                               4, 2, 1e-3)
    finally:
        rtt.shutdown()
    assert res["losses_fed"] == res["losses_memory"]
    assert all(math.isfinite(x) for x in res["losses_fed"])
    assert res["launches"]["flash_fwd"] == 2 * 2 * cfg.layers
    assert res["launches"]["flash_bwd_dq"] == 2 * cfg.layers
    assert res["launches"]["flash_bwd_dkv"] == 2 * cfg.layers


def test_num_tpus_task_sees_one_card_and_launches_flash(cuda):
    """A ``num_tpus=1`` task is pinned to one card (``CUDA_VISIBLE_DEVICES``
    holds the card it was granted) and launches the flash forward at the
    serving shape, held against the plain version in the worker
    (``chip_smoke.sched_card_task``, the ``sched_cards`` phase's task)."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)      # task workers import chip_smoke
    import chip_smoke as cs
    import ray_tpu_torch as rtt
    rtt.init(num_cpus=2)
    try:
        assert rtt.cluster_resources()["GPU"] == torch.cuda.device_count()
        r = rtt.get(rtt.remote(num_tpus=1)(cs.sched_card_task).remote(0),
                    timeout=300)
        assert rtt.available_resources()["GPU"] == \
            rtt.cluster_resources()["GPU"]
    finally:
        rtt.shutdown()
    assert r["device_count"] == 1 and r["visible"] is not None
    assert r["launches"] == 1
    assert r["max_abs_err"] <= cs.TOL["bfloat16"]

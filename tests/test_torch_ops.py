"""ray_tpu_torch ops against the JAX package's, on the CPU.

Same inputs, made from numpy seeds, go through the JAX function and its port;
on CPU tensors each kernel wrapper takes its plain version, which is what
these tests hold to JAX (the kernels themselves are held to the plain
versions on the card: tests/test_torch_kernels.py).  Tolerances: fp32 1e-5,
bf16 2e-2 (one bf16 ulp at |x| ~ 2 is 2**-6).
"""

from __future__ import annotations

import ast
import importlib
import math
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.ops import norms as j_norms
from ray_tpu.ops import paged_attention as j_paged
from ray_tpu.ops import rope as j_rope
from ray_tpu_torch import _device
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import norms as t_norms
from ray_tpu_torch.ops import paged_attention as t_paged
from ray_tpu_torch.ops import rope as t_rope

# Both ops packages re-export their ``attention`` function under the
# submodule's name, so the modules come from importlib.
j_attn = importlib.import_module("ray_tpu.ops.attention")
t_attn = importlib.import_module("ray_tpu_torch.ops.attention")

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tt(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _jj(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


class TestNorms:
    @pytest.mark.parametrize("shape", [(4, 16), (2, 3, 128)])
    def test_rms_norm_f32(self, shape):
        x, w = _rand(0, *shape), _rand(1, shape[-1])
        np.testing.assert_allclose(
            _np(t_norms.rms_norm(_tt(x), _tt(w), 1e-5)),
            _np(j_norms.rms_norm(_jj(x), _jj(w), 1e-5)), **F32)

    def test_rms_norm_bf16_io(self):
        x, w = _rand(2, 4, 64), _rand(3, 64)
        out = t_norms.rms_norm(_tt(x, torch.bfloat16), _tt(w))
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(
            _np(out), _np(j_norms.rms_norm(_jj(x, jnp.bfloat16), _jj(w))),
            **BF16)


class TestRope:
    @pytest.mark.parametrize("head_dim,length", [(32, 64), (128, 2048)])
    def test_tables(self, head_dim, length):
        tc, ts = t_rope.rope_frequencies(head_dim, length, 10000.0)
        jc, js = j_rope.rope_frequencies(head_dim, length, 10000.0)
        assert tc.dtype == torch.float32 and tc.shape == (length,
                                                          head_dim // 2)
        # cos/sin of arguments up to ~2047 rad: the two libraries' fp32
        # range reductions differ by an ulp of the argument.
        np.testing.assert_allclose(_np(tc), _np(jc), atol=2e-4)
        np.testing.assert_allclose(_np(ts), _np(js), atol=2e-4)

    def test_apply_rope_implicit_positions(self):
        cos, sin = j_rope.rope_frequencies(16, 64)
        x = _rand(4, 2, 3, 10, 16)
        np.testing.assert_allclose(
            _np(t_rope.apply_rope(_tt(x), _tt(cos), _tt(sin))),
            _np(j_rope.apply_rope(_jj(x), cos, sin)), **F32)

    def test_apply_rope_explicit_positions(self):
        cos, sin = j_rope.rope_frequencies(16, 64)
        x = _rand(5, 1, 2, 10, 16)
        pos = np.array([3, 9, 17, 4, 0, 63, 1, 2, 30, 31])
        np.testing.assert_allclose(
            _np(t_rope.apply_rope(_tt(x), _tt(cos), _tt(sin),
                                  torch.from_numpy(pos))),
            _np(j_rope.apply_rope(_jj(x), cos, sin, jnp.asarray(pos))),
            **F32)

    def test_apply_rope_bf16(self):
        cos, sin = j_rope.rope_frequencies(32, 16)
        x = _rand(6, 1, 4, 16, 32)
        out = t_rope.apply_rope(_tt(x, torch.bfloat16), _tt(cos), _tt(sin))
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(
            _np(out), _np(j_rope.apply_rope(_jj(x, jnp.bfloat16), cos, sin)),
            **BF16)


def _qkv(seed, B=1, H=4, Hkv=4, Sq=64, Sk=64, D=32):
    return (_rand(seed, B, H, Sq, D), _rand(seed + 1, B, Hkv, Sk, D),
            _rand(seed + 2, B, Hkv, Sk, D))


ATTN_CASES = [
    # (H, Hkv, Sq, Sk, causal, q_offset)
    (4, 4, 64, 64, True, 0),
    (4, 4, 64, 64, False, 0),
    (8, 2, 64, 64, True, 0),
    (4, 2, 32, 128, True, 96),
    (4, 2, 40, 72, False, 0),
]


class TestAttention:
    @pytest.mark.parametrize("H,Hkv,Sq,Sk,causal,q_offset", ATTN_CASES)
    def test_reference_matches_jax(self, H, Hkv, Sq, Sk, causal, q_offset):
        q, k, v = _qkv(10, 2, H, Hkv, Sq, Sk)
        np.testing.assert_allclose(
            _np(t_attn.reference_attention(_tt(q), _tt(k), _tt(v),
                                           causal=causal,
                                           q_offset=q_offset)),
            _np(j_attn.reference_attention(_jj(q), _jj(k), _jj(v),
                                           causal=causal,
                                           q_offset=q_offset)), **F32)

    @pytest.mark.parametrize("H,Hkv,Sq,Sk,causal,q_offset",
                             [c for c in ATTN_CASES if c[2] % 32 == 0
                              and c[3] % 32 == 0])
    def test_flash_plain_matches_jax_flash_kernel(self, H, Hkv, Sq, Sk,
                                                  causal, q_offset):
        """The port's flash_fwd (plain on CPU) against the Pallas kernel
        in interpret mode, LSE included."""
        q, k, v = _qkv(20, 1, H, Hkv, Sq, Sk)
        out, lse = t_attn.flash_fwd(_tt(q), _tt(k), _tt(v), causal=causal,
                                    q_offset=q_offset, need_lse=True)
        j_out, j_lse = j_attn._flash_forward(
            _jj(q), _jj(k), _jj(v), causal, 1.0 / math.sqrt(32), 32, 32,
            q_offset, True, need_lse=True)
        np.testing.assert_allclose(_np(out), _np(j_out), atol=2e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(_np(lse), _np(j_lse), atol=2e-5,
                                   rtol=1e-4)
        assert lse.dtype == torch.float32 and lse.shape == (1, H, Sq)

    def test_bf16_io(self):
        q, k, v = _qkv(30, 1, 8, 2, 64, 64)
        out = t_attn.flash_attention(_tt(q, torch.bfloat16),
                                     _tt(k, torch.bfloat16),
                                     _tt(v, torch.bfloat16))
        assert out.dtype == torch.bfloat16
        want = j_attn.reference_attention(_jj(q, jnp.bfloat16),
                                          _jj(k, jnp.bfloat16),
                                          _jj(v, jnp.bfloat16))
        np.testing.assert_allclose(_np(out), _np(want), **BF16)

    def test_dispatcher(self):
        q, k, v = (_tt(a) for a in _qkv(40, 1, 4, 2, 32, 32))
        ref = t_attn.reference_attention(q, k, v)
        for impl in (None, "auto", "flash", "reference"):
            torch.testing.assert_close(t_attn.attention(q, k, v, impl=impl),
                                       ref)
        with pytest.raises(ValueError):
            t_attn.attention(q, k, v, impl="ring")

    def test_cpu_takes_plain_version_without_launching(self):
        q, k, v = (_tt(a) for a in _qkv(50, 1, 4, 4, 16, 16))
        before = t_attn.flash_fwd.launches
        out, lse = t_attn.flash_fwd(q, k, v)
        assert lse is None and out.shape == q.shape
        assert t_attn.flash_fwd.launches == before

    def test_cpu_grad_flows_through_plain_version(self):
        q, k, v = (_tt(a).requires_grad_() for a in _qkv(60, 1, 4, 2, 16,
                                                          16))
        t_attn.flash_attention(q, k, v).sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()

    @pytest.mark.parametrize("H,Hkv,Sq,Sk,causal,q_offset",
                             [c for c in ATTN_CASES if c[2] % 32 == 0
                              and c[3] % 32 == 0])
    def test_flash_bwd_plain_matches_jax_backward_kernels(
            self, H, Hkv, Sq, Sk, causal, q_offset):
        """The port's flash_bwd (plain on CPU) against the Pallas dq and
        dk/dv kernels in interpret mode, both fed the JAX forward's own out
        and LSE.  fp32; 1e-4 absolute (another summation order)."""
        q, k, v = _qkv(70, 2, H, Hkv, Sq, Sk)
        dout = _rand(73, 2, H, Sq, 32)
        scale = 1.0 / math.sqrt(32)
        j_out, j_lse = j_attn._flash_forward(
            _jj(q), _jj(k), _jj(v), causal, scale, 32, 32, q_offset, True,
            need_lse=True)
        want = j_attn._flash_backward(
            _jj(q), _jj(k), _jj(v), j_out, j_lse, _jj(dout), causal, scale,
            32, 32, q_offset, True)
        before = (t_attn.flash_bwd_dq.launches, t_attn.flash_bwd_dkv.launches)
        got = t_attn.flash_bwd(_tt(q), _tt(k), _tt(v), _tt(j_out),
                               _tt(j_lse), _tt(dout), causal=causal,
                               q_offset=q_offset)
        assert (t_attn.flash_bwd_dq.launches,
                t_attn.flash_bwd_dkv.launches) == before
        for g, w, shape in zip(got, want, (q.shape, k.shape, v.shape)):
            assert g.dtype == torch.float32 and g.shape == shape
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                                 (True, 32)])
    def test_flash_attention_grad_matches_jax_grad(self, causal, q_offset):
        """autograd through the port's flash_attention (the _Flash
        Function; plain on CPU) against jax.vjp of the Pallas flash
        attention in interpret mode.  fp32, 1e-4 absolute."""
        q, k, v = _qkv(80, 1, 4, 2, 32, 64)
        dout = _rand(83, 1, 4, 32, 32)

        def j_fn(q, k, v):
            return j_attn.flash_attention(q, k, v, causal=causal,
                                          q_offset=q_offset, block_q=32,
                                          block_k=32, interpret=True)

        _out, vjp = jax.vjp(j_fn, _jj(q), _jj(k), _jj(v))
        want = vjp(_jj(dout))
        qkv = [_tt(a).requires_grad_() for a in (q, k, v)]
        out = t_attn.flash_attention(*qkv, causal=causal, q_offset=q_offset)
        assert out.grad_fn is not None and "_Flash" in type(
            out.grad_fn).__name__
        got = torch.autograd.grad(out, qkv, _tt(dout))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


class TestPaged:
    def test_combine_kv(self):
        k, v = _rand(70, 3, 5, 2, 8), _rand(71, 3, 5, 2, 8)
        np.testing.assert_array_equal(
            _np(t_paged.combine_kv(_tt(k), _tt(v))),
            _np(j_paged.combine_kv(_jj(k), _jj(v))))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_matches_jax(self, dtype):
        B, H, Hkv, D, page, P = 5, 8, 2, 16, 4, 6
        rng = np.random.default_rng(80)
        NP = B * P + 1
        bt = rng.permutation(np.arange(1, NP))[:B * P].reshape(B, P)
        bt = bt.astype(np.int32)
        lens = np.array([1, 24, 0, 13, 7], np.int32)   # slot 2 inactive
        kv = _rand(81, NP, page, 2 * Hkv, D)
        q = _rand(82, B, H, D)
        tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                    else (torch.bfloat16, jnp.bfloat16))
        got = t_paged.paged_decode_attention(
            _tt(q, tdt), _tt(kv, tdt), torch.from_numpy(bt),
            torch.from_numpy(lens), page)
        want = j_paged.paged_decode_attention(
            _jj(q, jdt), _jj(kv, jdt), jnp.asarray(bt), jnp.asarray(lens),
            page)
        assert got.dtype == tdt and got.shape == (B, H, D)
        tol = F32 if dtype == "float32" else BF16
        np.testing.assert_allclose(_np(got), _np(want), **tol)

    # Page 4, a table of 8 pages (reach 32): 1, a page, a page + 1, either
    # side of the 2-page runs' boundaries (8, 16), the reach, past it, and
    # an inactive slot.
    EDGE_LENS = [1, 4, 5, 7, 8, 9, 15, 16, 17, 32, 50, 0]

    @pytest.mark.parametrize("splits", range(1, 33))
    def test_split_path_matches_jax(self, splits):
        """The kernel's split-and-merge, in plain torch, against the JAX
        package's paged_decode_attention (its _exact_path on the CPU) at
        1e-5 over the live slots; inactive slots give zeros."""
        lens = np.array(self.EDGE_LENS, np.int32)
        B, H, Hkv, D, page, P = len(lens), 8, 2, 16, 4, 8
        rng = np.random.default_rng(90)
        NP = B * P + 1
        bt = rng.permutation(np.arange(1, NP))[:B * P].reshape(B, P)
        bt = bt.astype(np.int32)
        kv, q = _rand(91, NP, page, 2 * Hkv, D), _rand(92, B, H, D)
        got = t_paged._split_path(_tt(q), _tt(kv), torch.from_numpy(bt),
                                  torch.from_numpy(lens), page, splits)
        want = j_paged.paged_decode_attention(
            _jj(q), _jj(kv), jnp.asarray(bt), jnp.asarray(lens), page)
        live = lens > 0
        np.testing.assert_allclose(_np(got)[live], _np(want)[live], **F32)
        assert not _np(got)[~live].any()

    @pytest.mark.parametrize("B,Hkv,P", [
        (32, 8, 128), (1, 8, 128), (4, 8, 128), (8, 32, 128), (64, 8, 128),
        (1, 1, 1), (1, 8, 3), (2, 2, 5), (1, 1, 4096), (16, 1, 64),
        (4096, 2, 128)])
    @pytest.mark.parametrize("sms", [132, 114, 16])
    def test_split_rule(self, B, Hkv, P, sms):
        """Never more splits than a table's runs of MIN_PAGES_PER_SPLIT
        pages (so never more than its pages) or than MAX_SPLITS; where
        neither caps it, the grid covers the SMs; a split grid has at most
        BLOCKS_PER_SM blocks for each SM (the workspace's size), so at
        most half as many (slot, KV head) pairs (its counters)."""
        n = t_paged.decode_splits(B, Hkv, P, sms)
        cap = min(t_paged.MAX_SPLITS,
                  max(1, P // t_paged.MIN_PAGES_PER_SPLIT))
        assert 1 <= n <= cap and n <= P
        if n < cap:
            assert B * Hkv * n >= sms
        if n > 1:
            assert B * Hkv * n <= t_paged.BLOCKS_PER_SM * sms
            assert 2 * B * Hkv <= t_paged.BLOCKS_PER_SM * sms

    @pytest.mark.parametrize("sms", [132, 114, 16])
    def test_workspace_holds_every_split_layout(self, monkeypatch, sms):
        """The workspace is allocated once per (device, stream), and
        every layout the split rule makes fits in it: its (slot, KV head)
        counters, then its partials of G * (D + 2) floats a block.  Two
        streams never share one."""
        dev = torch.device("cpu")
        monkeypatch.setattr(t_paged, "_SM_COUNT", {dev: sms})
        monkeypatch.setattr(t_paged, "_WORKSPACE", {})
        ws, blocks = t_paged._workspace(dev, 1)
        assert t_paged._workspace(dev, 1)[0] is ws
        assert t_paged._workspace(dev, 2)[0] is not ws
        assert blocks == t_paged.BLOCKS_PER_SM * sms
        assert ws.dtype == torch.float32 and not ws.any()
        for B in range(1, 300):
            for Hkv in (1, 2, 4, 8, 32):
                for P in (1, 3, 8, 64, 128, 4096):
                    n = t_paged.decode_splits(B, Hkv, P, sms)
                    if n == 1:
                        continue
                    assert B * Hkv <= blocks // 2
                    for G in t_paged._GROUPS:
                        for D in t_paged._HEAD_DIMS:
                            assert (blocks // 2 + B * Hkv * n * G * (D + 2)
                                    <= ws.numel())

    def test_workspace_first_use_from_many_threads(self, monkeypatch):
        """Eight threads released by one barrier make the first call on
        one stream at once: every thread gets the same workspace (a second
        one inserted over it would be freed while its maker still passes
        its address to the kernel).  ``_sm_count`` sleeps, so the threads
        overlap inside the creation."""
        import threading
        import time as _time
        dev = torch.device("cpu")
        monkeypatch.setattr(t_paged, "_WORKSPACE", {})

        def slow_sm_count(_device):
            _time.sleep(0.01)
            return 16
        monkeypatch.setattr(t_paged, "_sm_count", slow_sm_count)
        barrier = threading.Barrier(8)
        got = [None] * 8

        def first_use(i):
            barrier.wait(timeout=30)
            got[i] = t_paged._workspace(dev, 7)[0]

        threads = [threading.Thread(target=first_use, args=(i,))
                   for i in range(8)]
        try:
            for t in threads:
                t.start()
        finally:
            for t in threads:
                t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert all(g is got[0] for g in got) and got[0] is not None
        assert list(t_paged._WORKSPACE) == [(dev, 7)]

    def test_launch_counts_lose_nothing_between_threads(self):
        """count_launch under 16 threads with a short switch interval:
        the total and the per-thread counts are exact."""
        import sys
        import threading

        def fake():
            pass
        fake.launches = 0
        fake.launches_by_thread = {}
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)

        def work():
            for _ in range(2000):
                _build.count_launch(fake)

        threads = [threading.Thread(target=work, name=f"counter-{i}")
                   for i in range(16)]
        try:
            for t in threads:
                t.start()
        finally:
            for t in threads:
                t.join(timeout=60)
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert fake.launches == 16 * 2000
        assert fake.launches_by_thread == {f"counter-{i}": 2000
                                           for i in range(16)}

    def test_split_ranges_and_empty_partials(self):
        """Ranges are page-aligned, disjoint and in order, cover each slot's
        reach min(len, P*page) and nothing else; a split whose range is
        empty gives m = -inf, l = 0 and acc = 0."""
        page, P, splits = 4, 16, 8
        lens = torch.tensor([3, 0, 40, 64, 99], dtype=torch.int32)
        lo, hi = t_paged.split_ranges(lens, P, page, splits)
        for b, n in enumerate(lens.tolist()):
            reach, covered = min(n, P * page), []
            for s in range(splits):
                assert lo[s, b] % page == 0
                if hi[s, b] > lo[s, b]:
                    covered += range(int(lo[s, b]), int(hi[s, b]))
            assert covered == list(range(reach))
        q, kv = _tt(_rand(93, 5, 4, 8)), _tt(_rand(94, 81, page, 4, 8))
        bt = torch.arange(1, 81, dtype=torch.int32).view(5, P)
        m, l, acc = t_paged._split_partials(q, kv, bt, lens, page, splits)
        empty = (hi <= lo)
        assert empty[1:, 0].all() and empty[:, 1].all()
        assert not empty[:, 3].any()
        assert torch.isinf(m[empty]).all() and (m[empty] < 0).all()
        assert not l[empty].any() and not acc[empty].any()
        assert (l[~empty] > 0).all()

    def test_paged_decode_is_the_same_wrapper(self):
        assert t_paged.paged_decode is t_paged.paged_decode_attention
        assert isinstance(t_paged.paged_decode.launches, int)


class TestDevice:
    def test_default_is_cuda_and_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _device.resolve_device()
        with pytest.raises(RuntimeError):
            _device.resolve_device("cuda")

    def test_cpu_when_asked(self):
        assert _device.resolve_device("cpu") == torch.device("cpu")
        g1 = _device.make_generator("cpu", 3)
        g2 = _device.make_generator("cpu", 3)
        assert torch.equal(torch.rand(4, generator=g1),
                           torch.rand(4, generator=g2))

    def test_other_devices_refused(self):
        with pytest.raises(ValueError):
            _device.resolve_device("meta")


class TestBuild:
    def test_library_named_by_source_hash(self):
        p = _build.library_path("flash_fwd")
        assert p.parent == _build.BUILD_DIR
        assert p.name.startswith("flash_fwd-") and p.suffix == ".so"
        assert p == _build.library_path("flash_fwd")
        assert set(_build.SOURCES) == {
            f.stem for f in _build.CSRC_DIR.glob("*.cu")}

    def test_header_edit_changes_every_library_path(self, monkeypatch,
                                                    tmp_path):
        """A header in csrc/ may be included by any source: editing it
        must rename (and so rebuild) every library."""
        for name in ("a", "b"):
            (tmp_path / f"{name}.cu").write_text(f"// {name}\n")
        (tmp_path / "common.cuh").write_text("// v1\n")
        monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
        before = {n: _build.library_path(n) for n in ("a", "b")}
        assert before == {n: _build.library_path(n) for n in ("a", "b")}
        (tmp_path / "common.cuh").write_text("// v2\n")
        after = {n: _build.library_path(n) for n in ("a", "b")}
        assert all(after[n] != before[n] for n in ("a", "b"))
        (tmp_path / "a.cu").write_text("// a, edited\n")
        assert _build.library_path("a") != after["a"]
        assert _build.library_path("b") == after["b"]

    def test_no_nvcc_raises(self, monkeypatch):
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.setattr(_build.shutil, "which", lambda _n: None)
        monkeypatch.setattr(_build.os.path, "exists", lambda _p: False)
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc_path()


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_ray_tpu():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "flash_fwd_ab.py",
              REPO / "flash_bwd_ab.py", REPO / "paged_decode_ab.py",
              REPO / "sharded_smoke.py"]
    assert len(files) > 10
    assert {"moe.py", "ring_attention.py", "ulysses.py", "pipeline.py",
            "_actor.py", "backends.py", "_object_store.py", "remote.py",
            "controller.py", "batching.py", "multiplex.py",
            "compiled_dag.py", "syncdebug.py", "capture.py", "recompile.py",
            "rules_torch.py", "_scheduler.py", "_resources.py",
            "_runtime_env.py", "_cgroup.py", "_memory_monitor.py",
            "_config.py", "_ids.py", "cuda.py", "accelerator.py",
            "decisions.py", "tuner.py", "searchers.py", "schedulers.py",
            "scaling_policy.py", "gpu.py", "lockdebug.py", "_sanitizer.py",
            "rules_user.py", "rules_internal.py", "rules_dataflow.py",
            "rules_concurrency.py", "metrics.py", "actor_pool.py",
            "queue.py", "_checkpoint.py", "exceptions.py",
            "_serialization.py", "_protocol.py", "_controller.py",
            "_persist.py", "_cluster.py", "_client.py", "head.py"} <= \
        {f.name for f in files}
    # The workflow tombstone is walked too (its import raises ImportError).
    assert REPO / "ray_tpu_torch" / "workflow" / "__init__.py" in files
    for f in files:
        # Whole-word roots: ray_tpu_torch is the port itself.  optax, chex
        # and flax each import JAX; the port reads bf16 without ml_dtypes;
        # the card's machine has no cloudpickle (actors pickle by
        # reference), no aiohttp (the HTTP ingress is the standard
        # library's) and no grpcio.
        bad = {r for r in _imported_roots(f)
               if r in ("jax", "jaxlib", "ray_tpu", "optax", "chex", "flax",
                        "ml_dtypes", "cloudpickle", "aiohttp", "grpc")}
        assert not bad, f"{f.relative_to(REPO)} imports {bad}"

"""ray_tpu_torch.llm against ray_tpu.llm, on the CPU.

The inference programs (prefill, write_prefill, prefill_chunk, decode_step,
decode_chunk) run on the same weights and caches in both packages: fp32
logits agree at 1e-4, pages (other than reserved page 0, which both sides
scribble on) at 1e-5, greedy tokens exactly.  The engine cases of
tests/test_llm.py rerun on the port, and the port's engine streams must
equal the JAX engine's on the same weights.  Sampled decoding cannot match
jax.random, so it gets invariant checks.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.llm import InferenceEngine as JEngine
from ray_tpu.llm import SamplingParams as JSamplingParams
from ray_tpu.llm import _model as j_model
from ray_tpu.models import llama as j_llama
from ray_tpu_torch.llm import (InferenceEngine, LLMServer, SamplingParams,
                               build_llm_deployment)
from ray_tpu_torch.llm import _model as t_model
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as t_llama

DIMS = dict(vocab_size=128, hidden=32, layers=2, heads=4, kv_heads=2,
            head_dim=8, mlp_dim=64, max_seq_len=128)
J_CFG = j_llama.LlamaConfig(**DIMS, dtype=jnp.float32, remat=False,
                            attention_impl="reference")
CFG = t_llama.LlamaConfig(**DIMS, dtype=torch.float32)
LOGITS = dict(atol=1e-4, rtol=1e-4)
PAGES = dict(atol=1e-5, rtol=1e-5)
ENGINE = dict(device="cpu", max_slots=2, page_size=8, num_pages=64)


@pytest.fixture(scope="module")
def jax_params():
    return j_llama.init_params(J_CFG, jax.random.key(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")


def naive_greedy(params, prompt, max_new):
    """Gold: the port's full forward re-run per token."""
    toks, out = list(prompt), []
    for _ in range(max_new):
        logits = t_llama.forward(params, torch.tensor([toks]), CFG)
        nxt = int(logits[0, len(toks) - 1].argmax())
        out.append(nxt)
        toks.append(nxt)
    return out


def _pages(seed, NP, page):
    """Random per-layer caches, the same numbers for both packages."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((NP, page, 2 * DIMS["kv_heads"],
                                 DIMS["head_dim"])).astype(np.float32)
            for _ in range(DIMS["layers"])]
    return (tuple(jnp.asarray(a) for a in arrs),
            tuple(torch.from_numpy(a.copy()) for a in arrs))


def _assert_pages(t_pages, j_pages):
    for t, j in zip(t_pages, j_pages):
        np.testing.assert_allclose(t.numpy()[1:], np.asarray(j)[1:], **PAGES)


class TestModelParity:
    def test_prefill(self, jax_params, params):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :11] = np.random.default_rng(1).integers(0, 128, 11)
        jl, jk, jv = j_model.prefill(jax_params, jnp.asarray(toks),
                                     jnp.asarray(11), J_CFG)
        tl, tk, tv = t_model.prefill(params, torch.from_numpy(toks).long(),
                                     11, CFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **PAGES)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **PAGES)
        assert tk.shape == (DIMS["layers"], 16, DIMS["kv_heads"],
                            DIMS["head_dim"])

    def test_write_prefill(self):
        rng = np.random.default_rng(2)
        ks = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
        vs = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
        page_ids = np.array([3, 3, 3, 3, 5, 5, 5, 0, 0, 0, 0, 0], np.int32)
        offs = np.arange(12, dtype=np.int32) % 4
        j_pages, t_pages = _pages(3, 8, 4)
        j_out = j_model.write_prefill(j_pages, jnp.asarray(ks),
                                      jnp.asarray(vs), jnp.asarray(page_ids),
                                      jnp.asarray(offs))
        t_out = t_model.write_prefill(t_pages, torch.from_numpy(ks),
                                      torch.from_numpy(vs),
                                      torch.from_numpy(page_ids),
                                      torch.from_numpy(offs))
        assert t_out[0] is t_pages[0]          # in place
        _assert_pages(t_out, j_out)

    def test_prefill_chunk(self, jax_params, params):
        j_pages, t_pages = _pages(4, 10, 8)
        bt = np.array([2, 7, 4, 0], np.int32)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :6] = np.random.default_rng(5).integers(0, 128, 6)
        jl, j_out = j_model.prefill_chunk(
            jax_params, j_pages, jnp.asarray(toks), jnp.asarray(9),
            jnp.asarray(6), jnp.asarray(bt), J_CFG, 8)
        tl, t_out = t_model.prefill_chunk(
            params, t_pages, torch.from_numpy(toks).long(), 9, 6,
            torch.from_numpy(bt), CFG, 8)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        _assert_pages(t_out, j_out)

    def _decode_inputs(self):
        tokens = np.array([5, 77, 1], np.int32)
        positions = np.array([9, 17, 3], np.int32)
        bt = np.array([[2, 6, 0], [1, 3, 8], [4, 0, 0]], np.int32)
        active = np.array([True, True, False])
        return tokens, positions, bt, active

    def test_decode_step(self, jax_params, params):
        tokens, positions, bt, active = self._decode_inputs()
        j_pages, t_pages = _pages(6, 9, 8)
        jl, j_out = j_model.decode_step(
            jax_params, j_pages, jnp.asarray(tokens), jnp.asarray(positions),
            jnp.asarray(bt), jnp.asarray(active), J_CFG, 8)
        tl, t_out = t_model.decode_step(
            params, t_pages, torch.from_numpy(tokens),
            torch.from_numpy(positions), torch.from_numpy(bt),
            torch.from_numpy(active), CFG, 8)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        _assert_pages(t_out, j_out)

    def test_decode_chunk_greedy(self, jax_params, params):
        tokens, positions, bt, active = self._decode_inputs()
        j_pages, t_pages = _pages(7, 9, 8)
        j_toks, j_pos, j_out = j_model.decode_chunk(
            jax_params, j_pages, jnp.asarray(tokens), jnp.asarray(positions),
            jnp.asarray(bt), jnp.asarray(active), jax.random.key(0), J_CFG,
            8, 4, 0.0, 0)
        t_toks, t_pos, t_out = t_model.decode_chunk(
            params, t_pages, torch.from_numpy(tokens),
            torch.from_numpy(positions), torch.from_numpy(bt),
            torch.from_numpy(active), torch.Generator().manual_seed(0), CFG,
            8, 4, 0.0, 0)
        np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
        np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
        _assert_pages(t_out, j_out)

    def test_prefill_bf16(self):
        jcfg = J_CFG.replace(dtype=jnp.bfloat16)
        jp = j_llama.init_params(jcfg, jax.random.key(1),
                                 param_dtype=jnp.bfloat16)
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")
        toks = np.random.default_rng(8).integers(0, 128, (1, 16))
        jl, _jk, _jv = j_model.prefill(jp, jnp.asarray(toks),
                                       jnp.asarray(16), jcfg)
        tl, tk, _tv = t_model.prefill(tp, torch.from_numpy(toks), 16,
                                      CFG.replace(dtype=torch.bfloat16))
        assert tk.dtype == torch.bfloat16
        want = np.asarray(jl)
        # bf16 bound scaled to the logits (see tests/test_torch_llama.py).
        assert np.abs(tl.numpy() - want).max() <= 2e-2 * np.abs(want).max()


class TestEngine:
    """tests/test_llm.py's engine cases, on the port."""

    def test_greedy_matches_full_forward(self, params):
        eng = InferenceEngine(params, CFG, **ENGINE,
                              prefill_buckets=(16, 64))
        prompt = [3, 17, 92, 5, 41]
        got = eng.generate([prompt], SamplingParams(max_tokens=8))[0]
        assert got == naive_greedy(params, prompt, 8)

    def test_chunked_decode_matches_per_step(self, params):
        prompts = [[3, 17, 92, 5, 41], [7, 9, 23, 6]]
        eng = InferenceEngine(params, CFG, **ENGINE, prefill_buckets=(16,))
        ids = [eng.add_request(p, SamplingParams(max_tokens=9))
               for p in prompts]
        done, guard = {}, 0
        while eng.has_work():
            for r in eng.step_chunk(4):
                done[r.request_id] = r.output_tokens
            guard += 1
            assert guard < 100
        assert [done[i] for i in ids] == [naive_greedy(params, p, 9)
                                          for p in prompts]

    def test_pipelined_decode_matches_per_step(self, params):
        prompts = [[3, 17, 92, 5, 41], [7, 9, 23, 6], [11, 4], [8, 8, 2]]
        eng = InferenceEngine(params, CFG, **ENGINE, prefill_buckets=(16,))
        ids = [eng.add_request(p, SamplingParams(max_tokens=9))
               for p in prompts]
        done = {r.request_id: r.output_tokens
                for r in eng.run_pipelined(4, max_chunks=200)}
        assert [done[i] for i in ids] == [naive_greedy(params, p, 9)
                                          for p in prompts]

    def test_continuous_batching_matches_sequential(self, params):
        prompts = [[7, 9, 23], [4, 4, 8, 15, 16, 23, 42], [99], [1, 2]]
        eng = InferenceEngine(params, CFG, **ENGINE,
                              prefill_buckets=(16, 64))
        batch = eng.generate(prompts, SamplingParams(max_tokens=6))
        for p, got in zip(prompts, batch):
            assert got == naive_greedy(params, p, 6)

    def test_pages_freed_after_generation(self, params):
        eng = InferenceEngine(params, CFG, **dict(ENGINE, num_pages=32),
                              prefill_buckets=(16,))
        free0 = eng.pool.num_free
        eng.generate([[5, 6, 7]] * 3, SamplingParams(max_tokens=4))
        assert eng.pool.num_free == free0

    def test_kv_memory_backpressure(self, params):
        eng = InferenceEngine(params, CFG, **dict(ENGINE, max_slots=4,
                                                  num_pages=8),
                              prefill_buckets=(16,))
        outs = eng.generate([[i + 1, i + 2] for i in range(5)],
                            SamplingParams(max_tokens=4))
        assert all(len(o) == 4 for o in outs)

    def test_too_long_prompt_rejected(self, params):
        eng = InferenceEngine(params, CFG, **ENGINE, prefill_buckets=(16,),
                              max_seq_len=32)
        outs = eng.generate([list(range(1, 40)), [5, 6]],
                            SamplingParams(max_tokens=4))
        assert outs[0] == []
        assert len(outs[1]) == 4

    def test_stop_tokens(self, params):
        eng = InferenceEngine(params, CFG, **dict(ENGINE, max_slots=1),
                              prefill_buckets=(16,))
        prompt = [3, 17, 92, 5, 41]
        full = naive_greedy(params, prompt, 8)
        got = eng.generate([prompt], SamplingParams(
            max_tokens=8, stop_token_ids=(full[2],)))[0]
        assert got == full[:3]

    def test_default_device_needs_a_card(self, params, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InferenceEngine(params, CFG)

    def test_unsupported_config_raises(self, params):
        """The engine serves dense blocks only, as the JAX engine's model
        does (ray_tpu/llm/_model.py's _mlp)."""
        with pytest.raises(ValueError, match="dense blocks only"):
            InferenceEngine(params, CFG.replace(num_experts=4),
                            device="cpu")

    def test_sequence_parallel_config_serves_as_dense(self, params):
        """A ring or Ulysses training config serves on one device through
        the same attention as the dense one."""
        prompt = [3, 17, 92, 5, 41]
        want = InferenceEngine(params, CFG, **ENGINE).generate(
            [prompt], SamplingParams(max_tokens=6))[0]
        for impl in ("ring", "ulysses"):
            eng = InferenceEngine(params, CFG.replace(attention_impl=impl),
                                  **ENGINE)
            assert eng.generate([prompt],
                                SamplingParams(max_tokens=6))[0] == want


PROMPTS = [[3, 17, 92, 5, 41], [7, 9, 23, 6], [11, 4], [8, 8, 2],
           list(range(20, 50))]


class TestEngineMatchesJax:
    @staticmethod
    def _run(engine_cls, sp_cls, p, mode, **kw):
        eng = engine_cls(p, J_CFG if engine_cls is JEngine else CFG, **kw)
        if mode == "generate":
            return eng.generate(PROMPTS, sp_cls(max_tokens=7))
        ids = [eng.add_request(pr, sp_cls(max_tokens=9)) for pr in PROMPTS]
        done = {r.request_id: r.output_tokens
                for r in eng.run_pipelined(4, max_chunks=500)}
        return [done[i] for i in ids]

    @pytest.mark.parametrize("mode,kw", [
        ("generate", dict(max_slots=2, page_size=8, num_pages=64,
                          prefill_buckets=(16, 64))),
        ("pipelined", dict(max_slots=2, page_size=8, num_pages=64,
                           prefill_buckets=(16,))),
        # Chunked prefill (30-token prompt over 8-token chunks) and a pool
        # small enough to force recompute preemption.
        ("pipelined", dict(max_slots=4, page_size=4, num_pages=12,
                           prefill_buckets=(8,), prefill_chunk=8)),
    ])
    def test_streams_equal_jax_engine(self, jax_params, params, mode, kw):
        want = self._run(JEngine, JSamplingParams, jax_params, mode, **kw)
        got = self._run(InferenceEngine, SamplingParams, params, mode,
                        device="cpu", **kw)
        assert got == want


class TestSampling:
    def test_top_k_support(self):
        logits = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (4, 50)).astype(np.float32))
        top3 = torch.topk(logits, 3, dim=-1).indices
        gen = torch.Generator().manual_seed(0)
        for _ in range(50):
            tok = t_model.sample_tokens(logits, 1.5, 3, gen)
            assert tok.dtype == torch.int32
            assert (top3 == tok[:, None].long()).any(dim=-1).all()

    def test_gumbel_max_draws_follow_the_top_k_softmax(self):
        """A chi-square test over a vocab of 8 at temperature 0.8 and top-k
        5, fixed seed: 40,000 draws against softmax(logits / T) over the
        kept tokens.  The limit is the 1e-4 tail of chi-square with 4
        degrees of freedom, and no draw falls outside the top 5."""
        logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0, -3.0, 1.5, 0.7]])
        n, temp, k = 40_000, 0.8, 5
        gen = torch.Generator().manual_seed(11)
        toks = t_model.sample_tokens(logits.expand(n, 8), temp, k, gen)
        counts = torch.bincount(toks.long(), minlength=8).double()
        keep = torch.topk(logits[0], k).indices
        probs = torch.zeros(8, dtype=torch.float64)
        probs[keep] = torch.softmax(logits[0, keep].double() / temp, dim=0)
        assert counts[probs == 0].sum() == 0
        expected = probs[keep] * n
        chi2 = float(((counts[keep] - expected) ** 2 / expected).sum())
        assert chi2 < 23.51, chi2

    def test_top_k_one_is_greedy(self, params):
        prompt = [3, 17, 92, 5, 41]
        eng = InferenceEngine(params, CFG, **ENGINE, prefill_buckets=(16,))
        rid = eng.add_request(prompt, SamplingParams(
            max_tokens=8, temperature=0.7, top_k=1))
        done = {r.request_id: r.output_tokens
                for r in eng.run_pipelined(4)}
        assert done[rid] == naive_greedy(params, prompt, 8)

    def test_sampled_streams_reproduce_per_seed(self, params):
        def run(seed):
            eng = InferenceEngine(params, CFG, **ENGINE,
                                  prefill_buckets=(16,),
                                  generator=torch.Generator().manual_seed(
                                      seed))
            ids = [eng.add_request(p, SamplingParams(
                max_tokens=12, temperature=1.0)) for p in PROMPTS[:2]]
            done = {r.request_id: r.output_tokens
                    for r in eng.run_pipelined(4)}
            return [done[i] for i in ids]

        a, b = run(7), run(7)
        assert a == b and all(len(s) == 12 for s in a)
        assert all(0 <= t < DIMS["vocab_size"] for s in a for t in s)


class TestServer:
    def test_call_stream_close(self, params):
        server = LLMServer(lambda: (params, CFG),
                           dict(ENGINE, prefill_buckets=(16,)))
        try:
            prompt = [3, 17, 92, 5, 41]
            want = naive_greedy(params, prompt, 6)
            results = [None, None]

            def call(i):
                results[i] = server({"prompt_tokens": prompt,
                                     "max_tokens": 6})

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            items = list(server.stream({"prompt_tokens": prompt,
                                        "max_tokens": 6}))
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            for res in results:
                assert res == {"output_tokens": want,
                               "finish_reason": "length"}
            assert [it["token"] for it in items if "token" in it] == want
            assert items[-1] == {"finish_reason": "length", "num_tokens": 6}
            assert server.generate_batch([prompt], max_tokens=6) == [want]
        finally:
            server.close()
        assert not server._thread.is_alive()
        assert server.engine.pool.num_free == ENGINE["num_pages"] - 1

    def test_deployment_needs_the_serve_runtime(self, params):
        with pytest.raises(NotImplementedError, match="later slice"):
            build_llm_deployment(lambda: (params, CFG))

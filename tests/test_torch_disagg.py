"""ray_tpu_torch.llm.disagg against ray_tpu.llm.disagg, on the CPU.

The tiny fp32 config of tests/test_llm_fleet.py (reference attention),
with JAX's weights carried over by ``models/convert.params_from_numpy``:

- the port's ``PrefillWorker`` and JAX's on one prompt: the same first
  token, K/V within 1e-5, the same trimmed length;
- handoffs both ways: a JAX-made ``KVHandoff`` imported into the port's
  engine, and a port-made one (``.numpy()``) into JAX's, each continuing
  with exactly the greedy stream of local admission;
- ``DisaggServer`` in each mode: streams equal to JAX's ``DisaggServer``;
- the engine's telemetry: on a scripted run, the same metric names and the
  same ``tokens_total{kind}`` / ``requests_finished_total{reason}`` counts
  as JAX's engine;
- the admission logic (``TestDeadlineFeasibility``) and
  ``decode_full_returns_none``, parametrised over both packages;
- the port's shed, class budget and saturation cases with the JAX tests'
  own bounds, and the refusals that name ROADMAP item 6.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.llm import InferenceEngine as JEngine
from ray_tpu.llm import SamplingParams as JSamplingParams
from ray_tpu.llm.disagg import DisaggServer as JDisaggServer
from ray_tpu.llm.disagg import PrefillWorker as JPrefillWorker
from ray_tpu.models import llama as j_llama
from ray_tpu_torch.llm import InferenceEngine, SamplingParams
from ray_tpu_torch.llm.disagg import (AdmissionConfig, DisaggServer,
                                      KVHandoff, OverloadError,
                                      PrefillWorker, RequestClass,
                                      ServeLoadSpec, build_disagg_deployment,
                                      export_handoff, import_handoff,
                                      run_open_loop)
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.util import telemetry, tracing

DIMS = dict(vocab_size=128, hidden=32, layers=2, heads=4, kv_heads=2,
            head_dim=8, mlp_dim=64, max_seq_len=128)
J_CFG = j_llama.LlamaConfig(**DIMS, dtype=jnp.float32, remat=False,
                            attention_impl="reference")
CFG = t_llama.LlamaConfig(**DIMS, dtype=torch.float32,
                          attention_impl="reference")
KV_TOL = dict(atol=1e-5, rtol=1e-5)
ENGINE_OPTS = {"max_slots": 2, "page_size": 8, "num_pages": 64,
               "prefill_buckets": (16,)}
PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(scope="module")
def jax_params():
    return j_llama.init_params(J_CFG, jax.random.key(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")


def _side(pkg, jax_params, params):
    """(disagg module, engine class, SamplingParams, params, cfg, device
    kwargs) of one package."""
    disagg = importlib.import_module(f"{pkg}.llm.disagg")
    llm = importlib.import_module(f"{pkg}.llm")
    if pkg == "ray_tpu":
        return disagg, llm.InferenceEngine, llm.SamplingParams, \
            jax_params, J_CFG, {}
    return disagg, llm.InferenceEngine, llm.SamplingParams, params, CFG, \
        {"device": "cpu"}


def naive_greedy(params, prompt, max_new):
    """Gold: the port's full forward re-run per token."""
    toks, out = list(prompt), []
    for _ in range(max_new):
        logits = t_llama.forward(params, torch.tensor([toks]), CFG)
        nxt = int(logits[0, len(toks) - 1].argmax())
        out.append(nxt)
        toks.append(nxt)
    return out


def _drain(eng):
    done = {}
    guard = 0
    while eng.has_work():
        for r in eng.step():
            done[r.request_id] = r.output_tokens
        guard += 1
        assert guard < 5000
    return done


class TestPrefillWorkerParity:
    @pytest.mark.parametrize("n,buckets", [(11, (16,)), (5, (64,)),
                                           (24, (16, 64)), (40, (64,))])
    def test_matches_jax(self, jax_params, params, n, buckets):
        """Same first token, K/V within 1e-5, the same trimmed length
        (the prompt's pages rounded up to a power of two)."""
        prompt = np.random.default_rng(n).integers(1, 128, n).tolist()
        jh = JPrefillWorker(jax_params, J_CFG, prefill_buckets=buckets,
                            page_size=8).prefill(
            prompt, JSamplingParams(max_tokens=4))
        th = PrefillWorker(params, CFG, device="cpu",
                           prefill_buckets=buckets, page_size=8).prefill(
            prompt, SamplingParams(max_tokens=4))
        assert th.first_token == jh.first_token
        assert th.ks.shape == jh.ks.shape and th.vs.shape == jh.vs.shape
        np.testing.assert_allclose(th.ks.numpy(), np.asarray(jh.ks),
                                   **KV_TOL)
        np.testing.assert_allclose(th.vs.numpy(), np.asarray(jh.vs),
                                   **KV_TOL)
        assert th.nbytes == jh.nbytes
        assert th.ready is None          # nothing to wait for on the CPU

    def test_prompt_beyond_every_bucket_raises(self, params):
        pw = PrefillWorker(params, CFG, device="cpu", prefill_buckets=(16,),
                           page_size=8)
        with pytest.raises(ValueError, match="largest prefill bucket"):
            pw.prefill(list(range(1, 18)))


class TestHandoffAcrossPackages:
    def test_jax_handoff_into_the_port(self, jax_params, params):
        prompt = [3, 17, 92, 5, 41]
        jh = JPrefillWorker(jax_params, J_CFG, prefill_buckets=(16,),
                            page_size=8).prefill(
            prompt, JSamplingParams(max_tokens=8))
        eng = InferenceEngine(params, CFG, device="cpu", **ENGINE_OPTS)
        rid = eng.import_prefill(jh)
        assert rid is not None
        local = InferenceEngine(params, CFG, device="cpu",
                                **ENGINE_OPTS).generate(
            [prompt], SamplingParams(max_tokens=8))[0]
        assert _drain(eng)[rid] == local == naive_greedy(params, prompt, 8)

    def test_port_handoff_into_jax(self, jax_params, params):
        prompt = [7, 9, 23, 6, 88, 1, 2]
        th = PrefillWorker(params, CFG, device="cpu", prefill_buckets=(16,),
                           page_size=8).prefill(
            prompt, SamplingParams(max_tokens=6))
        host = th.numpy()
        assert isinstance(host.ks, np.ndarray) and host.nbytes == th.nbytes
        eng = JEngine(jax_params, J_CFG, **ENGINE_OPTS)
        rid = eng.import_prefill(host)
        assert rid is not None
        local = JEngine(jax_params, J_CFG, **ENGINE_OPTS).generate(
            [prompt], JSamplingParams(max_tokens=6))[0]
        assert _drain(eng)[rid] == local


class TestKVHandoff:
    def test_import_prefill_continues_exact(self, params):
        prompt = [3, 17, 92, 5, 41]
        pw = PrefillWorker(params, CFG, device="cpu", prefill_buckets=(16,),
                           page_size=8)
        h = pw.prefill(prompt, SamplingParams(max_tokens=8))
        eng = InferenceEngine(params, CFG, device="cpu", **ENGINE_OPTS)
        rid = eng.import_prefill(h)
        assert _drain(eng)[rid] == naive_greedy(params, prompt, 8)
        assert eng.load_stats()["free_slots"] == ENGINE_OPTS["max_slots"]

    @pytest.mark.parametrize("pkg", PKGS)
    def test_decode_full_returns_none(self, jax_params, params, pkg):
        """import_prefill under decode-side pressure returns None (caller
        backpressure) instead of silently dropping."""
        disagg, Engine, SP, p, cfg, dev = _side(pkg, jax_params, params)
        pw = disagg.PrefillWorker(p, cfg, prefill_buckets=(16,),
                                  page_size=8, **dev)
        eng = Engine(p, cfg, max_slots=1, page_size=8, num_pages=64,
                     prefill_buckets=(16,), **dev)
        h1 = pw.prefill([1, 2, 3], SP(max_tokens=8))
        h2 = pw.prefill([4, 5, 6], SP(max_tokens=8))
        assert eng.import_prefill(h1) is not None
        assert eng.import_prefill(h2) is None  # no free slot
        while eng.has_work():
            eng.step()
        assert eng.import_prefill(h2) is not None

    def test_object_store_transport_is_item_6(self, params):
        h = KVHandoff([1], 2, torch.zeros(2, 8, 2, 8), torch.zeros(2, 8, 2, 8),
                      SamplingParams())
        assert h.nbytes == 2 * 2 * 8 * 2 * 8 * 4
        for call in (lambda: export_handoff(None, None, h),
                     lambda: import_handoff(None)):
            with pytest.raises(NotImplementedError, match="item 6"):
                call()


class TestDeadlineFeasibility:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_infeasible_queue_wait_sheds_at_admission(self, pkg):
        d = importlib.import_module(f"{pkg}.llm.disagg")
        ctl = d.AdmissionController(d.AdmissionConfig(classes={
            "default": d.RequestClass(max_queue_depth=1000,
                                      queue_deadline_s=0.5)}))
        load = {"kv_occupancy": 0.0, "waiting": 0}
        assert ctl.try_admit("default", 10, load) is None
        for _ in range(4):
            ctl.note_queue_wait(3.0)
        assert ctl.try_admit("default", 10, load) == "deadline_infeasible"

    @pytest.mark.parametrize("pkg", PKGS)
    def test_stale_ewma_never_sheds_an_empty_queue(self, pkg):
        d = importlib.import_module(f"{pkg}.llm.disagg")
        ctl = d.AdmissionController(d.AdmissionConfig(classes={
            "default": d.RequestClass(max_queue_depth=1000,
                                      queue_deadline_s=0.5)}))
        load = {"kv_occupancy": 0.0, "waiting": 0}
        ctl.try_admit("default", 10, load)      # one queued
        for _ in range(4):
            ctl.note_queue_wait(3.0)
        ctl.note_dequeued("default")            # queue now empty
        assert ctl.try_admit("default", 10, load) is None

    @pytest.mark.parametrize("pkg", PKGS)
    def test_backpressure_and_class_budget(self, pkg):
        d = importlib.import_module(f"{pkg}.llm.disagg")
        ctl = d.AdmissionController(d.AdmissionConfig(
            classes={"default": d.RequestClass(token_budget=40)},
            kv_high_watermark=0.9))
        assert ctl.try_admit("default", 30, {"kv_occupancy": 0.95,
                                             "waiting": 0}) is None
        assert ctl.try_admit("default", 5, {"kv_occupancy": 0.95,
                                            "waiting": 0}) == "backpressure"
        assert ctl.try_admit("default", 20, {"kv_occupancy": 0.0,
                                             "waiting": 0}) == "class_budget"
        ctl.note_finished("default", 30)
        ctl.note_dequeued("default")
        assert ctl.try_admit("default", 20, {"kv_occupancy": 0.0,
                                             "waiting": 0}) is None


PROMPTS = [[3, 17, 92, 5, 41], [7, 9, 23], list(range(1, 15))]


@pytest.fixture(scope="module")
def jax_disagg_streams(jax_params):
    """JAX's DisaggServer streams, by mode, on PROMPTS (computed once)."""
    out = {}
    for mode in ("inline", "chunked", "disagg"):
        srv = JDisaggServer(lambda: (jax_params, J_CFG), mode=mode,
                            engine_options=dict(ENGINE_OPTS))
        try:
            out[mode] = [srv({"prompt_tokens": p, "max_tokens": 6,
                              "timeout_s": 120})["output_tokens"]
                         for p in PROMPTS]
        finally:
            srv.close()
    return out


class TestDisaggServer:
    @pytest.mark.parametrize("mode", ["inline", "chunked", "disagg"])
    def test_streams_equal_jax(self, params, jax_disagg_streams, mode):
        srv = DisaggServer(lambda: (params, CFG), mode=mode,
                           engine_options=dict(ENGINE_OPTS, device="cpu"),
                           record_token_times=True)
        try:
            pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 6})
                    for p in PROMPTS]
            outs = [srv.result(p, timeout_s=120) for p in pubs]
        finally:
            srv.close()
        assert not srv._dispatcher.is_alive() and not srv._driver.is_alive()
        assert [o["output_tokens"] for o in outs] == jax_disagg_streams[mode]
        assert outs[0]["output_tokens"] == naive_greedy(params, PROMPTS[0],
                                                        6)
        for o in outs:
            assert o["finish_reason"] == "length"
            assert o["ttft_s"] is not None and o["ttft_s"] >= 0
            assert len(o["itl_s"]) == 5
        if mode == "disagg":
            assert srv.prefill_worker.params["embed"] is \
                srv.engine.params["embed"]         # one copy of the weights

    @pytest.mark.parametrize("mode", ["inline", "disagg"])
    def test_a_finish_before_registration_is_published(self, params, mode):
        """The drive thread can finish a request (max_tokens=1) before the
        dispatcher registers its rid (here held back 0.3 s): the result
        still reaches the caller."""
        srv = DisaggServer(lambda: (params, CFG), mode=mode,
                           engine_options=dict(ENGINE_OPTS, device="cpu"))
        inner = srv._map_or_cancel

        def late_map(*args, **kwargs):
            time.sleep(0.3)
            return inner(*args, **kwargs)
        srv._map_or_cancel = late_map
        try:
            res = srv({"prompt_tokens": PROMPTS[0], "max_tokens": 1,
                       "timeout_s": 30})
        finally:
            srv.close()
        assert res.get("finish_reason") == "length", res
        assert res["output_tokens"] == naive_greedy(params, PROMPTS[0], 1)
        assert not srv._early

    def test_admission_sheds_not_queues(self, params):
        adm = AdmissionConfig(classes={"default": RequestClass(
            max_queue_depth=2, queue_deadline_s=30.0)})
        srv = DisaggServer(lambda: (params, CFG), mode="inline",
                           engine_options=dict(ENGINE_OPTS, device="cpu"),
                           admission=adm)
        try:
            shed = 0
            ids = []
            for _ in range(40):
                try:
                    ids.append(srv.submit({"prompt_tokens": [5, 6, 7],
                                           "max_tokens": 12}))
                except OverloadError as e:
                    assert e.retriable
                    shed += 1
            assert shed > 0
            res = srv.result(ids[0], timeout_s=120)
            assert res["finish_reason"] == "length"
        finally:
            srv.close()

    def test_class_token_budget(self, params):
        adm = AdmissionConfig(classes={"default": RequestClass(
            token_budget=40, max_queue_depth=64)})
        srv = DisaggServer(lambda: (params, CFG), mode="inline",
                           engine_options=dict(ENGINE_OPTS, device="cpu"),
                           admission=adm)
        try:
            srv.submit({"prompt_tokens": [1, 2, 3], "max_tokens": 30})
            with pytest.raises(OverloadError, match="class_budget"):
                srv.submit({"prompt_tokens": [1, 2, 3], "max_tokens": 30})
        finally:
            srv.close()

    def test_disagg_rejects_prompts_beyond_the_buckets(self, params):
        srv = DisaggServer(lambda: (params, CFG), mode="disagg",
                           engine_options=dict(ENGINE_OPTS, device="cpu"))
        try:
            with pytest.raises(ValueError, match="largest disagg prefill"):
                srv.submit({"prompt_tokens": list(range(1, 30))})
        finally:
            srv.close()

    def test_serve_load_saturation_smoke(self, params):
        """Under forced saturation (open-loop arrivals far past capacity,
        tiny queue bounds) the router SHEDS instead of queueing
        unboundedly, and p99 TTFT of ADMITTED requests stays bounded (the
        JAX test's bounds)."""
        adm = AdmissionConfig(classes={
            "interactive": RequestClass("interactive", token_budget=200,
                                        max_queue_depth=4,
                                        queue_deadline_s=1.5),
            "batch": RequestClass("batch", token_budget=120,
                                  max_queue_depth=2, queue_deadline_s=1.5),
            "default": RequestClass()})
        srv = DisaggServer(lambda: (params, CFG), mode="chunked",
                           engine_options=dict(ENGINE_OPTS, device="cpu"),
                           admission=adm, record_token_times=True)
        try:
            spec = ServeLoadSpec(rps=60, duration_s=2.0, long_fraction=0.3,
                                 short_prompt=6, short_max_tokens=12,
                                 long_prompt=14, long_max_tokens=6,
                                 drain_timeout_s=120)
            r = run_open_loop(srv, spec, vocab_size=CFG.vocab_size)
        finally:
            srv.close()
        assert r["offered"] > 20
        assert r["shed_submit"] + r["shed_deadline"] > 0
        assert r["completed"] > 0
        assert r["unfinished"] == 0 and r["errors"] == 0
        assert r["ttft_p99_ms"] is not None and r["ttft_p99_ms"] < 5000.0

    def test_trace_tree_of_a_request(self, params):
        """With tracing on, a disagg request's phases land under one root
        span in one trace."""
        tracing._reset_for_tests()
        tracing.enable()
        srv = DisaggServer(lambda: (params, CFG), mode="disagg",
                           engine_options=dict(ENGINE_OPTS, device="cpu"))
        try:
            srv({"prompt_tokens": [4, 5, 6], "max_tokens": 3,
                 "timeout_s": 120})
        finally:
            srv.close()
            tracing.disable()
        (tid,) = tracing.list_traces()
        spans = tracing.get_trace(tid)
        root = [s for s in spans if s["name"] == "llm_request"]
        assert len(root) == 1 and root[0]["parent_span_id"] is None
        kids = {s["name"] for s in spans
                if s["parent_span_id"] == root[0]["span_id"]}
        assert kids == {"queue_wait", "prefill", "kv_transfer",
                        "decode_admission"}
        tracing._reset_for_tests()

    def test_refusals_name_item_6(self, params):
        with pytest.raises(NotImplementedError, match="item 6"):
            build_disagg_deployment(lambda: (params, CFG))
        with pytest.raises(NotImplementedError, match="item 6"):
            DisaggServer(lambda: (params, CFG), mode="disagg",
                         engine_options=dict(ENGINE_OPTS, device="cpu"),
                         store=object())


class TestEngineTelemetry:
    """A scripted run through both engines: one chunked prompt, one
    admitted and stopped, one rejected, a handoff import, and a
    step_chunk pass."""

    LLM = ("ray_tpu_llm_tokens_total", "ray_tpu_llm_requests_finished_total")

    def _script(self, disagg, Engine, SP, p, cfg, dev):
        eng = Engine(p, cfg, max_slots=2, page_size=8, num_pages=64,
                     prefill_buckets=(16,), prefill_chunk=8, **dev)
        rng = np.random.default_rng(9)
        long_prompt = rng.integers(1, 128, 21).tolist()
        eng.generate([long_prompt, [5, 6, 7], list(range(1, 125))],
                     SP(max_tokens=5))
        pw = disagg.PrefillWorker(p, cfg, prefill_buckets=(16,),
                                  page_size=8, **dev)
        eng.import_prefill(pw.prefill([9, 8, 7, 6], SP(max_tokens=4)))
        eng.add_request([1, 2, 3], SP(max_tokens=7))
        while eng.has_work():
            eng.step_chunk(4)

    def test_names_and_counts_equal_jax(self, jax_params, params,
                                        monkeypatch):
        from ray_tpu.util import telemetry as j_tel
        # JAX's side is read by intercepting its record helpers, which
        # leaves the JAX package's process-wide registry untouched.
        j_names, j_counts = set(), {}

        def recorder(kind):
            def record(name, value=1.0, tags=None):
                j_names.add(name)
                if kind == "counter" and name in self.LLM:
                    key = (name, tuple(sorted((tags or {}).items())))
                    j_counts[key] = j_counts.get(key, 0.0) + value
            return record
        for fn, kind in (("inc", "counter"), ("observe", "histogram"),
                         ("set_gauge", "gauge")):
            monkeypatch.setattr(j_tel, fn, recorder(kind))
        self._script(*_side("ray_tpu", jax_params, params))
        monkeypatch.undo()
        telemetry._reset_for_tests()
        self._script(*_side("ray_tpu_torch", jax_params, params))
        t_names = telemetry.emitted_names()
        t_counts = {(name, key): val[1] for name in self.LLM
                    for key, val in telemetry.samples(name).items()}
        telemetry._reset_for_tests()
        llm = {n for n in j_names if n.startswith("ray_tpu_llm_")}
        assert {"ray_tpu_llm_prefill_chunks_total",
                "ray_tpu_llm_ttft_seconds",
                "ray_tpu_llm_decode_token_seconds"} <= llm
        assert t_names == llm
        assert t_counts == j_counts
        assert t_counts[(self.LLM[1], (("reason", "prompt_too_long"),))] == 1

    def test_engine_spans(self, params):
        telemetry._reset_for_tests()
        eng = InferenceEngine(params, CFG, device="cpu", max_slots=2,
                              page_size=8, num_pages=64,
                              prefill_buckets=(16,), prefill_chunk=8)
        eng.generate([list(range(1, 12))], SamplingParams(max_tokens=3))
        eng.add_request([1, 2], SamplingParams(max_tokens=4))
        while eng.has_work():
            eng.step_chunk(4)
        names = {s["name"] for s in telemetry.spans()}
        assert {"engine_prefill", "engine_prefill_chunk", "engine_step",
                "engine_step_chunk"} <= names
        telemetry._reset_for_tests()

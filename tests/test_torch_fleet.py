"""ray_tpu_torch.llm.fleet against ray_tpu.llm.fleet, on the CPU.

The tiny fp32 config of tests/test_llm_fleet.py (reference attention),
with JAX's weights carried over by ``models/convert.params_from_numpy``:

- the host logic, parametrised over both packages so each case counts for
  each: ``TestPrefix``, ``TestRouter`` and ``TestAutoscalePolicy`` of
  tests/test_llm_fleet.py;
- ``FleetServer`` with 1 and 2 replicas: streams equal to JAX's
  ``FleetServer`` on the same prompts;
- the port's cases of ``TestFleetServer``, ``TestFleetChaos`` and
  ``TestFleetAutoscaleLoop`` (full-hit replay, sampled requests never
  replayed, the status surface, a kill that sheds ``replica_lost`` and
  backfills, a drain that sheds nothing, the manager scaling up and back
  down), the snapshot published to the control plane, replicas sharing
  one copy of the weights, and the refusals that name ROADMAP item 6.
Every server is closed in a ``finally``; close joins its threads.
"""

from __future__ import annotations

import importlib
import json
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.llm.fleet import FleetConfig as JFleetConfig
from ray_tpu.llm.fleet import FleetServer as JFleetServer
from ray_tpu.models import llama as j_llama
from ray_tpu_torch import _control
from ray_tpu_torch.llm import InferenceEngine, SamplingParams
from ray_tpu_torch.llm.fleet import (FLEET_KV_PREFIX, DecodeReplica,
                                     FleetConfig, FleetServer, RemoteReplica,
                                     ReplicaHost, ServeScaleConfig)
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as t_llama

DIMS = dict(vocab_size=128, hidden=32, layers=2, heads=4, kv_heads=2,
            head_dim=8, mlp_dim=64, max_seq_len=128)
J_CFG = j_llama.LlamaConfig(**DIMS, dtype=jnp.float32, remat=False,
                            attention_impl="reference")
CFG = t_llama.LlamaConfig(**DIMS, dtype=torch.float32,
                          attention_impl="reference")
ENGINE_OPTS = {"max_slots": 2, "page_size": 8, "num_pages": 64,
               "prefill_buckets": (16, 64)}
PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(scope="module")
def jax_params():
    return j_llama.init_params(J_CFG, jax.random.key(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")


@pytest.fixture(params=PKGS)
def fleet(request):
    """One package's ``llm.fleet`` module."""
    return importlib.import_module(f"{request.param}.llm.fleet")


def _wait_for(fn, timeout=20.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {fn}")


class _H:
    def __init__(self, toks, nbytes=64):
        self.prompt_tokens = list(toks)
        self.nbytes = nbytes


# ---------------------------------------------------------------------------
# prefix index + cache (both packages)
# ---------------------------------------------------------------------------


class TestPrefix:
    def test_chain_is_cumulative_per_block(self, fleet):
        toks = list(range(1, 40))
        chain = fleet.prefix_chain(toks, block=16)
        assert len(chain) == 2
        other = list(toks)
        other[20] = 99
        chain2 = fleet.prefix_chain(other, block=16)
        assert chain2[0] == chain[0]
        assert chain2[1] != chain[1]

    def test_full_hash_is_length_delimited(self, fleet):
        assert fleet.full_hash([1, 2, 3]) != fleet.full_hash([1, 2])
        assert fleet.full_hash([1, 2, 3]) == fleet.full_hash([1, 2, 3])

    def test_cache_lookup_verifies_exact_tokens(self, fleet):
        cache = fleet.PrefixCache(capacity_bytes=1 << 20, block=4)
        toks = [5, 6, 7, 8, 9]
        cache.insert(_H(toks, 256))
        assert cache.lookup(toks) is not None
        assert cache.lookup([5, 6, 7, 8]) is None
        assert cache.stats()["hits"] == 1

    def test_lru_eviction_respects_byte_budget(self, fleet):
        cache = fleet.PrefixCache(capacity_bytes=1000, block=4)
        a, b, c = [1] * 4, [2] * 4, [3] * 4
        cache.insert(_H(a, 400))
        cache.insert(_H(b, 400))
        cache.lookup(a)          # a is now MRU
        cache.insert(_H(c, 400))  # evicts b (LRU), not a
        assert cache.lookup(a) is not None
        assert cache.lookup(b) is None
        assert cache.lookup(c) is not None
        assert cache.stats()["bytes"] <= 1000

    def test_score_summary_full_and_partial(self, fleet):
        cache = fleet.PrefixCache(capacity_bytes=1 << 20, block=4)
        toks = list(range(1, 13))          # 3 full blocks
        cache.insert(_H(toks))
        summ = cache.summary()
        chain = fleet.prefix_chain(toks, 4)
        assert fleet.score_summary(summ, chain,
                                   fleet.full_hash(toks)) == (True, 3)
        other = toks[:8] + [99, 98, 97, 96]
        assert fleet.score_summary(summ, fleet.prefix_chain(other, 4),
                                   fleet.full_hash(other)) == (False, 2)
        assert fleet.score_summary(None, chain,
                                   fleet.full_hash(toks)) == (False, 0)


# ---------------------------------------------------------------------------
# router units (dict fixtures, no engines; both packages)
# ---------------------------------------------------------------------------


def _view(name, ongoing=0, assigned=0, summary=None):
    return {"name": name, "load": {"ongoing": ongoing},
            "summary": summary, "assigned": assigned}


def _summary_for(fleet, tokens, block=4):
    cache = fleet.PrefixCache(capacity_bytes=1 << 20, block=block)
    cache.insert(_H(tokens))
    return cache.summary()


class TestRouter:
    def test_empty_views_returns_none(self, fleet):
        assert fleet.FleetRouter().route([], ["x"], "fh") is None

    def test_full_hit_wins_over_less_loaded_miss(self, fleet):
        toks = list(range(1, 13))
        views = [_view("hot", ongoing=3, summary=_summary_for(fleet, toks)),
                 _view("cold", ongoing=0)]
        d = fleet.FleetRouter().route(views, fleet.prefix_chain(toks, 4),
                                      fleet.full_hash(toks))
        assert (d.replica, d.outcome, d.rebalanced) == ("hot", "full", False)

    def test_partial_prefix_steers_ties_by_load(self, fleet):
        toks = list(range(1, 13))
        overlap = toks[:8] + [99, 98, 97, 96]
        views = [_view("some", ongoing=1, summary=_summary_for(fleet, toks)),
                 _view("none", ongoing=0)]
        d = fleet.FleetRouter().route(views, fleet.prefix_chain(overlap, 4),
                                      fleet.full_hash(overlap))
        assert (d.replica, d.outcome, d.shared_blocks) == ("some", "partial",
                                                           2)

    def test_miss_routes_least_loaded(self, fleet):
        views = [_view("a", ongoing=2, assigned=1),
                 _view("b", ongoing=1, assigned=0)]
        d = fleet.FleetRouter().route(views, ["z"], "fh")
        assert (d.replica, d.outcome) == ("b", "miss")

    def test_imbalance_watermark_overrides_affinity(self, fleet):
        toks = list(range(1, 13))
        views = [_view("hot", ongoing=10,
                       summary=_summary_for(fleet, toks)),
                 _view("cold", ongoing=0)]
        d = fleet.FleetRouter(fleet.RoutingConfig(imbalance_watermark=4)) \
            .route(views, fleet.prefix_chain(toks, 4), fleet.full_hash(toks))
        assert (d.replica, d.rebalanced, d.outcome) == ("cold", True, "miss")

    def test_assigned_counts_toward_depth(self, fleet):
        views = [_view("a", ongoing=0, assigned=5),
                 _view("b", ongoing=1, assigned=0)]
        assert fleet.FleetRouter().route(views, ["z"], "fh").replica == "b"


# ---------------------------------------------------------------------------
# autoscale policy units (logical clock; both packages)
# ---------------------------------------------------------------------------


class TestAutoscalePolicy:
    def _policy(self, fleet, **kw):
        base = dict(min_replicas=1, max_replicas=3, queue_high=2.0,
                    sustain_s=1.0, down_sustain_s=2.0, cooldown_s=5.0,
                    window_s=4.0, queue_low=0.25)
        base.update(kw)
        return fleet.ServeAutoscalePolicy(fleet.ServeScaleConfig(**base))

    def test_sustained_queue_burn_scales_up(self, fleet):
        p = self._policy(fleet)
        t, decision = 100.0, None
        for i in range(12):
            p.observe(queue_depth=10, shed_total=0, completed_total=i,
                      replicas=1, now=t)
            decision = p.decide(pending=0, now=t) or decision
            t += 0.25
        assert (decision.direction, decision.reason) == ("up", "queue_depth")
        assert decision.signals["queue_per_replica"] > 2.0

    def test_transient_spike_does_not_scale(self, fleet):
        p = self._policy(fleet, sustain_s=2.0)
        t = 100.0
        p.observe(10, 0, 0, 1, now=t)
        assert p.decide(now=t) is None
        t += 0.5
        p.observe(0, 0, 5, 1, now=t)
        t += 0.5
        p.observe(10, 0, 5, 1, now=t)
        assert p.decide(now=t) is None

    def test_cooldown_spaces_actions_and_forget_unsticks(self, fleet):
        p = self._policy(fleet, sustain_s=0.5, cooldown_s=10.0)
        t, d = 100.0, None
        for _ in range(8):
            p.observe(10, 0, 0, 1, now=t)
            d = p.decide(now=t) or d
            t += 0.25
        assert d is not None and d.direction == "up"
        p.observe(10, 0, 0, 1, now=t)
        assert p.decide(now=t) is None
        p.forget_action()
        p.observe(10, 0, 0, 1, now=t)
        assert p.decide(now=t).direction == "up"

    def test_idle_fleet_scales_down_after_sustain(self, fleet):
        p = self._policy(fleet, cooldown_s=0.5)
        t, d = 100.0, None
        for _ in range(12):
            p.observe(0, 0, 100, 2, now=t)
            d = p.decide(now=t) or d
            t += 0.25
        assert d is not None and d.direction == "down"

    def test_never_below_min_or_above_max(self, fleet):
        p = self._policy(fleet, max_replicas=2, cooldown_s=0.0,
                         sustain_s=0.0, down_sustain_s=0.0)
        t = 100.0
        for _ in range(8):
            p.observe(10, 0, 0, 2, now=t)
            assert p.decide(now=t) is None
            t += 0.25
        t += 10.0
        for _ in range(8):
            p.observe(0, 0, 10, 1, now=t)
            assert p.decide(now=t) is None
            t += 0.25

    def test_pending_action_blocks_further_scaling(self, fleet):
        p = self._policy(fleet, sustain_s=0.0, cooldown_s=0.0)
        t = 100.0
        for _ in range(6):
            p.observe(10, 0, 0, 1, now=t)
            t += 0.25
        assert p.decide(pending=1, now=t) is None
        assert p.decide(pending=0, now=t) is not None

    def test_itl_axis_burns_when_enabled(self, fleet):
        p = self._policy(fleet, itl_p99_high_ms=50.0, sustain_s=0.0,
                         cooldown_s=0.0)
        t = 100.0
        for _ in range(6):
            p.observe(0, 0, 10, 1, itl_samples=[0.2] * 20, now=t)
            t += 0.25
        d = p.decide(now=t)
        assert d is not None and d.reason == "itl_p99"


class TestSeriesStore:
    """The windowed queries the autoscale policy makes (avg, delta, p99),
    the port's store against JAX's on the same samples."""

    BOUNDS = [0.001, 0.01, 0.1, 1.0]

    def _fill(self, mod):
        store = mod.SeriesStore(interval_s=0.25, max_points=64)
        rng = np.random.default_rng(3)
        counts, total, n = [0] * (len(self.BOUNDS) + 1), 0.0, 0
        for i in range(40):
            t = 100.0 + 0.25 * i
            store.append("q", {}, "gauge", float(rng.integers(0, 9)), t)
            store.append("c", {}, "counter", float(3 * i - (30 if i > 30
                                                            else 0)), t)
            for x in rng.exponential(0.05, 5):
                j = sum(1 for b in self.BOUNDS if x > b)
                for k in range(j, len(counts)):
                    counts[k] += 1
                total, n = total + float(x), n + 1
            store.append("h", {}, "histogram",
                         {"counts": list(counts), "sum": total, "count": n},
                         t, bounds=self.BOUNDS)
        return store

    @pytest.mark.parametrize("name,agg", [("q", "avg"), ("c", "delta"),
                                          ("h", "p99"), ("c", "rate"),
                                          ("h", "avg")])
    def test_queries_equal_jax(self, name, agg):
        from ray_tpu import metricsview as j_mv
        from ray_tpu_torch import metricsview as t_mv
        for window in (1.0, 4.0, 30.0):
            got = self._fill(t_mv).query(name, window, agg, now=109.75)
            want = self._fill(j_mv).query(name, window, agg, now=109.75)
            assert got == want
            assert got["value"] is not None


# ---------------------------------------------------------------------------
# the fleet end to end (one process, local replicas)
# ---------------------------------------------------------------------------


def _fleet(params, n=2, **cfg_kw):
    cfg_kw.setdefault("engine_options", dict(ENGINE_OPTS, device="cpu"))
    cfg_kw.setdefault("cache_capacity_bytes", 1 << 20)
    return FleetServer(lambda: (params, CFG), name="t",
                       config=FleetConfig(num_replicas=n, **cfg_kw),
                       record_token_times=True)


PROMPTS = [np.random.default_rng(i).integers(1, CFG.vocab_size, 12).tolist()
           for i in range(6)]


@pytest.fixture(scope="module")
def jax_fleet_streams(jax_params):
    """JAX's FleetServer streams on PROMPTS with 1 and 2 replicas."""
    out = {}
    for n in (1, 2):
        srv = JFleetServer(lambda: (jax_params, J_CFG), name="j",
                           config=JFleetConfig(
                               num_replicas=n,
                               engine_options=dict(ENGINE_OPTS),
                               cache_capacity_bytes=1 << 20))
        try:
            pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 6})
                    for p in PROMPTS]
            out[n] = [srv.result(p, timeout_s=120)["output_tokens"]
                      for p in pubs]
        finally:
            srv.close()
    return out


class TestFleetServer:
    @pytest.mark.parametrize("n", [1, 2])
    def test_streams_equal_jax(self, params, jax_fleet_streams, n):
        eng = InferenceEngine(params, CFG, device="cpu", **ENGINE_OPTS)
        gold = [eng.generate([p], SamplingParams(max_tokens=6))[0]
                for p in PROMPTS]
        srv = _fleet(params, n=n)
        try:
            pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 6})
                    for p in PROMPTS]
            outs = [srv.result(p, timeout_s=120) for p in pubs]
        finally:
            srv.close()
        assert not srv._dispatcher.is_alive() and not srv._manager.is_alive()
        for res in outs:
            assert "error" not in res, res
        assert [r["output_tokens"] for r in outs] == jax_fleet_streams[n] \
            == gold
        assert len({r["replica"] for r in outs}) == n

    def test_full_hit_replays_identical_tokens(self, params):
        srv = _fleet(params, n=1)
        try:
            prompt = list(range(1, 14))
            r1 = srv({"prompt_tokens": prompt, "max_tokens": 5,
                      "timeout_s": 60})
            r2 = srv({"prompt_tokens": prompt, "max_tokens": 5,
                      "timeout_s": 60})
            assert r1["prefix_outcome"] in ("miss", "partial")
            assert r2["prefix_outcome"] == "full"
            assert r2["output_tokens"] == r1["output_tokens"]
            assert r2["ttft_s"] < r1["ttft_s"]
            assert srv.status()["prefix"]["full"] >= 1
        finally:
            srv.close()

    def test_sampled_requests_never_replay(self, params):
        srv = _fleet(params, n=1)
        try:
            prompt = list(range(2, 15))
            srv({"prompt_tokens": prompt, "max_tokens": 4, "timeout_s": 60})
            r2 = srv({"prompt_tokens": prompt, "max_tokens": 4,
                      "temperature": 0.8, "timeout_s": 60})
            assert r2["prefix_outcome"] != "full"
        finally:
            srv.close()

    def test_status_and_load_surface(self, params):
        srv = _fleet(params, n=2)
        try:
            srv({"prompt_tokens": [3, 4, 5], "max_tokens": 3,
                 "timeout_s": 60})
            st = srv.status()
            assert st["name"] == "t" and len(st["replicas"]) == 2
            assert st["target_replicas"] == 2 and st["completed"] == 1
            for r in st["replicas"]:
                assert {"name", "state", "ongoing", "cache",
                        "assigned"} <= set(r)
            load = srv.load()
            assert load["mode"] == "fleet" and load["replicas"] == 2
        finally:
            srv.close()

    def test_replicas_share_the_weights_and_own_their_cache(self, params):
        srv = _fleet(params, n=2)
        try:
            reps = list(srv._replicas.values())
            for name in ("embed", "final_norm", "lm_head"):
                tensors = [srv.prefill.params[name]] + [
                    r.engine.params[name] for r in reps]
                assert all(t is tensors[0] for t in tensors)
            assert reps[0].engine.kv_pages[0] is not \
                reps[1].engine.kv_pages[0]
            prompt = list(range(3, 19))
            handoff = srv.prefill.prefill(prompt,
                                          SamplingParams(max_tokens=2))
            assert reps[0].import_prefill(handoff) is not None
            cached = reps[0].cache.lookup(prompt)
            assert cached.ks is not handoff.ks
            assert torch.equal(cached.ks, handoff.ks)
            assert reps[0].cache.stats()["bytes"] == handoff.nbytes
        finally:
            srv.close()

    def test_publishes_to_the_control_plane(self, params):
        plane = _control.ControlPlane.serve()
        _control.set_current(plane)
        try:
            srv = _fleet(params, n=1, publish_interval_s=0.0,
                         manager_interval_s=0.05)
            try:
                srv({"prompt_tokens": [4, 5, 6], "max_tokens": 2,
                     "timeout_s": 60})

                def published():
                    raw = plane.kv_get(FLEET_KV_PREFIX + "t")
                    return json.loads(raw.decode()) if raw else None
                snap = _wait_for(published)
                assert snap["name"] == "t" and len(snap["replicas"]) == 1
            finally:
                srv.close()
            assert plane.kv_get(FLEET_KV_PREFIX + "t") is None
        finally:
            _control.set_current(None)

    def test_refusals_name_item_6(self, params):
        for cls in (RemoteReplica, ReplicaHost):
            with pytest.raises(NotImplementedError, match="item 6"):
                cls(lambda: (params, CFG), name="r")
        with pytest.raises(NotImplementedError, match="item 6"):
            FleetServer(lambda: (params, CFG), store=object(),
                        config=FleetConfig(engine_options=dict(
                            ENGINE_OPTS, device="cpu")))


class TestEarlyFinish:
    @pytest.mark.parametrize("max_tokens", [1, 2])
    def test_a_finish_before_registration_is_published(self, params,
                                                       max_tokens):
        """The replica's drive thread can step, and finish, a request
        between import_prefill's return and the dispatcher's registration
        of it (here held back 0.3 s); the finish must still reach the
        caller, for a cold import and for a cached replay."""
        srv = _fleet(params, n=1)
        inner = srv._map

        def late_map(*args, **kwargs):
            time.sleep(0.3)
            return inner(*args, **kwargs)
        srv._map = late_map
        try:
            prompt = list(range(5, 22))
            body = {"prompt_tokens": prompt, "max_tokens": max_tokens,
                    "timeout_s": 30}
            cold = srv(body)
            hit = srv(body)
        finally:
            srv.close()
        for res in (cold, hit):
            assert "error" not in res, res
            assert len(res["output_tokens"]) == max_tokens
        assert hit["prefix_outcome"] == "full"
        assert hit["output_tokens"] == cold["output_tokens"]
        assert not srv._early


class TestFleetChaos:
    def test_replica_kill_sheds_retriably_and_backfills(self, params):
        srv = _fleet(params, n=2)
        try:
            prompts = [np.random.default_rng(100 + i).integers(
                1, CFG.vocab_size, 12).tolist() for i in range(8)]
            pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 100,
                                "timeout_s": 120}) for p in prompts]

            def victim():
                with srv._lock:
                    for name, _rid in list(srv._rid_map):
                        if name in srv._replicas:
                            return name
                return None
            name = _wait_for(victim)
            killed = srv._replicas[name]
            assert srv.kill_replica(name)
            assert not killed._driver.is_alive()
            results = [srv.result(p, timeout_s=120) for p in pubs]
            shed = [r for r in results if r.get("finish_reason") == "shed"]
            done = [r for r in results if r.get("finish_reason") != "shed"]
            assert any(r.get("reason") == "replica_lost" for r in shed)
            assert all(r.get("retriable") for r in shed)
            assert all(r.get("reason") in ("replica_lost", "deadline")
                       for r in shed)
            assert all("error" not in r for r in done) and done
            _wait_for(lambda: len(srv.status()["replicas"]) == 2
                      and not srv.status()["draining"])
            r = srv({"prompt_tokens": [9, 8, 7], "max_tokens": 3,
                     "timeout_s": 60})
            assert "error" not in r
        finally:
            srv.close()

    def test_scale_down_drains_without_killing_work(self, params):
        srv = _fleet(params, n=2)
        try:
            pubs = [srv.submit({"prompt_tokens": [i + 1, i + 2, i + 3],
                                "max_tokens": 30, "timeout_s": 120})
                    for i in range(4)]
            assert srv.scale_down() is not None
            results = [srv.result(p, timeout_s=120) for p in pubs]
            assert all(r.get("finish_reason") != "shed" for r in results)
            assert all("error" not in r for r in results)
            _wait_for(lambda: len(srv.status()["replicas"]) == 1
                      and not srv.status()["draining"])
        finally:
            srv.close()


class TestFleetAutoscaleLoop:
    def test_manager_executes_up_and_down(self, params):
        srv = _fleet(
            params, n=1, manager_interval_s=0.05,
            autoscale=ServeScaleConfig(
                min_replicas=1, max_replicas=2, queue_high=0.5,
                sustain_s=0.2, down_sustain_s=0.4, cooldown_s=0.3,
                window_s=1.0))
        try:
            prompts = [np.random.default_rng(7 + i).integers(
                1, CFG.vocab_size, 12).tolist() for i in range(16)]
            pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 30,
                                "timeout_s": 300}) for p in prompts]
            _wait_for(lambda: srv.status()["scales"]["up"] >= 1,
                      timeout=30.0)
            results = [srv.result(p, timeout_s=300) for p in pubs]
            assert all("error" not in r for r in results)
            assert all(r.get("finish_reason") != "shed" for r in results)
            _wait_for(lambda: srv.status()["scales"]["down"] >= 1
                      and len(srv.status()["replicas"]) == 1, timeout=30.0)
        finally:
            srv.close()


def test_decode_replica_alone(params):
    """A replica outside a fleet: import, finish callback, drain, kill."""
    finished = []
    rep = DecodeReplica(lambda: (params, CFG), name="solo",
                        engine_options=dict(ENGINE_OPTS, device="cpu"),
                        on_finish=lambda _r, req: finished.append(req))
    try:
        from ray_tpu_torch.llm.disagg import PrefillWorker
        pw = PrefillWorker(params, CFG, device="cpu", prefill_buckets=(16,),
                           page_size=8)
        h = pw.prefill([5, 6, 7, 8], SamplingParams(max_tokens=4))
        rid = rep.import_prefill(h)
        _wait_for(lambda: finished)
        assert finished[0].request_id == rid
        assert len(finished[0].output_tokens) == 4
        assert rep.idle()
        rep.drain()
        assert not rep.accepting and rep.import_prefill(h) is None
    finally:
        assert rep.kill() == []
    assert not rep._driver.is_alive()

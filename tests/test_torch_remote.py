"""The cross-process serving path of ``ray_tpu_torch`` against the JAX
package, on the CPU: the object store, the KV handoff between processes,
``store=`` on both servers, and ``RemoteReplica`` fleets.

The tiny fp32 config of tests/test_llm_fleet.py (reference attention),
with JAX's weights carried over by ``models/convert.params_from_numpy``:

- the store's page-blob semantics, parametrised over both packages (after
  tests/test_llm_disagg.py's object-store cases): export pins, the import
  is equal, the release leaves ``num_objects == 0``; a full store returns
  None and keeps nothing; a republish of one id is idempotent; a handoff
  through the store continues with the greedy stream of local admission;
- a handoff exported by this process and imported in a port actor: K/V
  bit-equal;
- ``DisaggServer(store=...)`` in every mode and ``FleetServer(store=...)``
  with 1 and 2 replicas: streams equal to JAX's servers with JAX's
  ``SharedMemoryStore``, and the store empty after;
- a fleet of two ``RemoteReplica`` processes: streams equal to JAX's
  in-process ``FleetServer``, a full-hit replay in the replica, a replica
  process killed (its requests shed as ``replica_lost``, retriably, and the
  manager backfills), and a drain that sheds nothing;
- a replica process that dies inside ``import_prefill``, before or after
  it opens the handoff: the call answers None, the replica turns dead and
  the store is empty; on the card (marked ``gpu``, skips here) the
  exporter's ``torch.cuda.memory_allocated`` is back to its baseline, so
  no CUDA IPC share of the lost send pins the handoff's memory.

Tokens are exact; K/V bit-equal.  Actors run torch on one thread; JAX is
imported inside functions (each actor imports this file to find
``_build``).
"""

from __future__ import annotations

import functools
import gc
import importlib
import os
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import _actor
from ray_tpu_torch import _object_store as t_store
from ray_tpu_torch.llm import InferenceEngine, SamplingParams
from ray_tpu_torch.llm.disagg import (DisaggServer, PrefillWorker,
                                      export_handoff, import_handoff)
from ray_tpu_torch.llm.fleet import (FleetConfig, FleetServer, RemoteReplica,
                                     ReplicaHost)
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as t_llama

DIMS = dict(vocab_size=128, hidden=32, layers=2, heads=4, kv_heads=2,
            head_dim=8, mlp_dim=64, max_seq_len=128)
CFG = t_llama.LlamaConfig(**DIMS, dtype=torch.float32,
                          attention_impl="reference")
ENGINE_OPTS = {"max_slots": 2, "page_size": 8, "num_pages": 64,
               "prefill_buckets": (16, 64)}
PKGS = ("ray_tpu", "ray_tpu_torch")
PROMPTS = [np.random.default_rng(i).integers(1, CFG.vocab_size, 12).tolist()
           for i in range(6)]
ONE_THREAD = {"num_cpus": 1, "env_vars": {"OMP_NUM_THREADS": "1"}}


def _j_cfg():
    import jax.numpy as jnp

    from ray_tpu.models import llama as j_llama
    return j_llama.LlamaConfig(**DIMS, dtype=jnp.float32, remat=False,
                               attention_impl="reference")


def _build(params_np):
    """A replica's ``build_params``: JAX's numpy weights -> the port's."""
    return convert.params_from_numpy(params_np, device="cpu"), CFG


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from ray_tpu.models import llama as j_llama
    return j_llama.init_params(_j_cfg(), jax.random.key(0))


@pytest.fixture(scope="module")
def params_np(jax_params):
    import jax
    return jax.tree.map(np.asarray, jax_params)


@pytest.fixture(scope="module")
def params(params_np):
    return _build(params_np)[0]


@pytest.fixture(scope="module")
def gold(params):
    """Local admission's greedy streams of PROMPTS (6 new tokens)."""
    eng = InferenceEngine(params, CFG, device="cpu", **ENGINE_OPTS)
    return [eng.generate([p], SamplingParams(max_tokens=6))[0]
            for p in PROMPTS]


# ---------------------------------------------------------------------------
# the store (both packages)
# ---------------------------------------------------------------------------


def _store_side(pkg, capacity):
    """(store, new id, export, release, import) of one package."""
    if pkg == "ray_tpu":
        from ray_tpu._private import object_store as S
        from ray_tpu._private.ids import ObjectID
        return (S.SharedMemoryStore(capacity_bytes=capacity),
                ObjectID.from_random, S.export_page_blob,
                S.release_page_blob, S.import_page_blob)
    return (t_store.SharedMemoryStore(capacity_bytes=capacity),
            t_store.new_object_id, t_store.export_page_blob,
            t_store.release_page_blob, t_store.import_page_blob)


class TestStore:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_pin_import_release(self, pkg):
        store, new_id, export, release, imp = _store_side(pkg, 32 << 20)
        value = {"ks": np.arange(4096, dtype=np.float32).reshape(8, 512),
                 "tokens": [3, 1, 4]}
        try:
            oid = new_id()
            desc = export(store, oid, value)
            assert desc is not None and desc[0] == "shm"
            assert store.stats()["num_pinned"] == 1
            got, keepalive = imp(desc)
            np.testing.assert_array_equal(got["ks"], value["ks"])
            assert got["tokens"] == value["tokens"]
            del got, keepalive
            release(store, oid)
            assert store.stats()["num_objects"] == 0
            release(store, oid)            # idempotent
        finally:
            store.shutdown()

    @pytest.mark.parametrize("pkg", PKGS)
    def test_full_store_returns_none(self, pkg):
        store, new_id, export, _release, _imp = _store_side(pkg, 1 << 16)
        try:
            assert export(store, new_id(), np.zeros(1 << 17, np.uint8)) \
                is None
            assert store.stats()["num_objects"] == 0
        finally:
            store.shutdown()

    @pytest.mark.parametrize("pkg", PKGS)
    def test_republish_is_idempotent(self, pkg):
        store, new_id, export, release, _imp = _store_side(pkg, 1 << 20)
        try:
            oid = new_id()
            a = export(store, oid, np.ones(16, np.int32))
            b = export(store, oid, np.ones(16, np.int32))
            assert a == b and store.stats()["num_objects"] == 1
            release(store, oid)
            assert store.stats()["num_objects"] == 0
        finally:
            store.shutdown()

    @pytest.mark.parametrize("pkg", PKGS)
    def test_handoff_through_store_continues_exact(self, pkg, params,
                                                   jax_params, gold):
        """tests/test_llm_disagg.py's object-store handoff, per package:
        the imported handoff continues with the stream of local
        admission."""
        disagg = importlib.import_module(f"{pkg}.llm.disagg")
        llm = importlib.import_module(f"{pkg}.llm")
        if pkg == "ray_tpu":
            p, cfg, dev = jax_params, _j_cfg(), {}
        else:
            p, cfg, dev = params, CFG, {"device": "cpu"}
        store, new_id, _export, release, _imp = _store_side(pkg, 32 << 20)
        try:
            pw = disagg.PrefillWorker(p, cfg, prefill_buckets=(16,),
                                      page_size=8, **dev)
            h = pw.prefill(PROMPTS[0], llm.SamplingParams(max_tokens=6))
            oid = new_id()
            desc = disagg.export_handoff(store, oid, h)
            h2, keepalive = disagg.import_handoff(desc)
            np.testing.assert_array_equal(np.asarray(h2.ks),
                                          np.asarray(h.ks))
            eng = llm.InferenceEngine(p, cfg, max_slots=2, page_size=8,
                                      num_pages=64, prefill_buckets=(16,),
                                      **dev)
            rid = eng.import_prefill(h2)
            del h2, keepalive
            release(store, oid)
            assert store.stats()["num_objects"] == 0
            done = {}
            while eng.has_work():
                for r in eng.step():
                    done[r.request_id] = r.output_tokens
            assert done[rid] == gold[0]
        finally:
            store.shutdown()


# ---------------------------------------------------------------------------
# a handoff read in another process
# ---------------------------------------------------------------------------


class HandoffReader:
    """Opens a handoff by descriptor in its own process."""

    def read(self, desc):
        h, keepalive = import_handoff(desc)
        out = (h.prompt_tokens, h.first_token, h.ks.clone().numpy(),
               h.vs.clone().numpy())
        del h, keepalive
        return out


def test_handoff_read_in_an_actor(params):
    pw = PrefillWorker(params, CFG, prefill_buckets=(16,), page_size=8,
                       device="cpu")
    h = pw.prefill(PROMPTS[1], SamplingParams(max_tokens=4))
    store = t_store.SharedMemoryStore(capacity_bytes=32 << 20)
    reader = _actor.remote(HandoffReader).options(
        device="cpu", **ONE_THREAD).remote()
    try:
        oid = t_store.new_object_id()
        desc = export_handoff(store, oid, h)
        toks, first, ks, vs = _actor.get(reader.read.remote(desc),
                                         timeout=120)
        t_store.release_page_blob(store, oid)
        assert (toks, first) == (h.prompt_tokens, h.first_token)
        np.testing.assert_array_equal(ks, h.ks.numpy())
        np.testing.assert_array_equal(vs, h.vs.numpy())
        assert store.stats()["num_objects"] == 0
    finally:
        _actor.kill(reader)
        store.shutdown()


# ---------------------------------------------------------------------------
# store= on both servers, against JAX's with JAX's store
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_store_streams(jax_params):
    """JAX's DisaggServer (each mode) and FleetServer (1, 2 replicas)
    streams on PROMPTS, with JAX's SharedMemoryStore."""
    from ray_tpu._private.object_store import SharedMemoryStore
    from ray_tpu.llm.disagg import DisaggServer as JDisagg
    from ray_tpu.llm.fleet import FleetConfig as JFleetConfig
    from ray_tpu.llm.fleet import FleetServer as JFleet
    cfg = _j_cfg()
    out = {}
    store = SharedMemoryStore(capacity_bytes=64 << 20)
    try:
        for mode in ("inline", "chunked", "disagg"):
            srv = JDisagg(lambda: (jax_params, cfg), mode=mode,
                          engine_options=dict(ENGINE_OPTS), store=store)
            try:
                out[mode] = [srv({"prompt_tokens": p, "max_tokens": 6,
                                  "timeout_s": 120})["output_tokens"]
                             for p in PROMPTS]
            finally:
                srv.close()
        for n in (1, 2):
            srv = JFleet(lambda: (jax_params, cfg), name="j", store=store,
                         config=JFleetConfig(num_replicas=n,
                                             engine_options=dict(ENGINE_OPTS),
                                             cache_capacity_bytes=1 << 20))
            try:
                pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 6})
                        for p in PROMPTS]
                out[n] = [srv.result(p, timeout_s=120)["output_tokens"]
                          for p in pubs]
            finally:
                srv.close()
    finally:
        store.shutdown()
    return out


@pytest.mark.parametrize("mode", ["inline", "chunked", "disagg"])
def test_disagg_server_with_store_equals_jax(params, jax_store_streams,
                                             gold, mode):
    store = t_store.SharedMemoryStore(capacity_bytes=64 << 20)
    srv = DisaggServer(lambda: (params, CFG), mode=mode, store=store,
                       engine_options=dict(ENGINE_OPTS, device="cpu"))
    try:
        got = [srv({"prompt_tokens": p, "max_tokens": 6,
                    "timeout_s": 120})["output_tokens"] for p in PROMPTS]
    finally:
        srv.close()
        stats = store.stats()
        store.shutdown()
    assert got == jax_store_streams[mode] == gold
    assert stats["num_objects"] == 0


@pytest.mark.parametrize("n", [1, 2])
def test_fleet_server_with_store_equals_jax(params, jax_store_streams,
                                            gold, n):
    store = t_store.SharedMemoryStore(capacity_bytes=64 << 20)
    srv = FleetServer(lambda: (params, CFG), name="t", store=store,
                      config=FleetConfig(num_replicas=n,
                                         engine_options=dict(ENGINE_OPTS,
                                                             device="cpu"),
                                         cache_capacity_bytes=1 << 20))
    try:
        pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 6})
                for p in PROMPTS]
        got = [srv.result(p, timeout_s=120)["output_tokens"] for p in pubs]
    finally:
        srv.close()
        stats = store.stats()
        store.shutdown()
    assert got == jax_store_streams[n] == gold
    assert stats["num_objects"] == 0


# ---------------------------------------------------------------------------
# RemoteReplica fleets
# ---------------------------------------------------------------------------


def _remote_factory(params_np):
    def factory(name, on_finish):
        return RemoteReplica(
            functools.partial(_build, params_np), name=name,
            engine_options=dict(ENGINE_OPTS, device="cpu"),
            cache_capacity_bytes=1 << 20, record_token_times=True,
            on_finish=on_finish, poll_interval_s=0.01,
            actor_options={"device": "cpu",
                           "env_vars": {"OMP_NUM_THREADS": "1"}})
    return factory


@pytest.fixture(scope="module")
def remote_fleet(params, params_np):
    """Two RemoteReplica processes behind one FleetServer (the prefill
    tier in this process; handoffs go through its default store)."""
    srv = FleetServer(lambda: (params, CFG), name="rf",
                      config=FleetConfig(num_replicas=2,
                                         engine_options=dict(ENGINE_OPTS,
                                                             device="cpu"),
                                         cache_capacity_bytes=1 << 20,
                                         manager_interval_s=0.1),
                      record_token_times=True,
                      replica_factory=_remote_factory(params_np))
    yield srv, t_store.default_store()
    srv.close()


@pytest.fixture(scope="module")
def jax_fleet_streams(jax_params):
    """JAX's in-process FleetServer (2 replicas) on PROMPTS."""
    from ray_tpu.llm.fleet import FleetConfig as JFleetConfig
    from ray_tpu.llm.fleet import FleetServer as JFleet
    cfg = _j_cfg()
    srv = JFleet(lambda: (jax_params, cfg), name="j",
                 config=JFleetConfig(num_replicas=2,
                                     engine_options=dict(ENGINE_OPTS),
                                     cache_capacity_bytes=1 << 20))
    try:
        pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 6})
                for p in PROMPTS]
        return [srv.result(p, timeout_s=120)["output_tokens"]
                for p in pubs]
    finally:
        srv.close()


class TestRemoteFleet:
    def test_streams_equal_jax_and_replay(self, remote_fleet,
                                          jax_fleet_streams, gold):
        srv, store = remote_fleet
        pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 6})
                for p in PROMPTS]
        outs = [srv.result(p, timeout_s=120) for p in pubs]
        assert [o["output_tokens"] for o in outs] == jax_fleet_streams \
            == gold
        for o in outs:
            assert o["finish_reason"] == "length"
            assert o["ttft_s"] is not None and o["ttft_s"] >= 0
            assert len(o["itl_s"]) == 5
        assert {o["replica"] for o in outs} <= {"rf-r0", "rf-r1"}
        # The same prompt again: a full hit, replayed inside the replica.
        again = srv({"prompt_tokens": PROMPTS[0], "max_tokens": 6,
                     "timeout_s": 120})
        assert again["prefix_outcome"] == "full"
        assert again["output_tokens"] == gold[0]
        assert store.stats()["num_objects"] == 0
        # Routing reads the polled snapshot, never the replica itself.
        views = srv._views()
        assert len(views) == 2 and all("kv_occupancy" in v["load"]
                                       for v in views)

    def test_killed_process_sheds_and_backfills(self, remote_fleet, gold):
        srv, _store = remote_fleet
        pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 60,
                            "timeout_s": 120}) for p in PROMPTS[:4]]
        deadline = time.monotonic() + 60
        victim = None
        while victim is None and time.monotonic() < deadline:
            with srv._lock:
                victim = next((name for name, _rid in srv._rid_map
                               if name in srv._replicas), None)
            time.sleep(0.005)
        assert victim is not None
        # The replica's process dies (not a kill through the fleet): the
        # poll turns it dead and the manager reaps it.
        _actor.kill(srv._replicas[victim].actor)
        results = [srv.result(p, timeout_s=120) for p in pubs]
        shed = [r for r in results if r.get("finish_reason") == "shed"]
        assert shed and all(r["reason"] == "replica_lost"
                            and r["retriable"] for r in shed)
        assert all(r.get("finish_reason") in ("shed", "length")
                   for r in results)

        def backfilled():
            st = srv.status()
            return len(st["replicas"]) == 2 and victim not in \
                [r["name"] for r in st["replicas"]]
        deadline = time.monotonic() + 120
        while not backfilled():
            assert time.monotonic() < deadline, srv.status()
            time.sleep(0.1)
        out = srv({"prompt_tokens": PROMPTS[2], "max_tokens": 6,
                   "timeout_s": 120})
        assert out["output_tokens"] == gold[2]

    def test_drain_sheds_nothing(self, remote_fleet, gold):
        srv, _store = remote_fleet
        pubs = [srv.submit({"prompt_tokens": p, "max_tokens": 6})
                for p in PROMPTS[3:]]
        name = srv.scale_down()
        assert name is not None
        outs = [srv.result(p, timeout_s=120) for p in pubs]
        assert [o["output_tokens"] for o in outs] == gold[3:]
        assert all(o["finish_reason"] == "length" for o in outs)
        # Once idle, the drained replica's process is stopped.
        deadline = time.monotonic() + 60
        while name in srv._replicas:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert len(srv.status()["replicas"]) == 1


# ---------------------------------------------------------------------------
# a replica that dies holding a handoff's descriptor
# ---------------------------------------------------------------------------


def _build_port(device):
    """``build_params`` with the port's own seeded weights (no JAX: the
    card's case runs where JAX is not installed)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return t_llama.init_params(CFG, gen, device=device), CFG


class DiesBeforeOpen(ReplicaHost):
    """Its process exits on an import, before it opens the handles."""

    def import_prefill(self, desc, retain=True):
        os._exit(1)


class DiesAfterOpen(ReplicaHost):
    """Its process exits on an import, holding the opened handoff."""

    def import_prefill(self, desc, retain=True):
        handoff, _keepalive = import_handoff(desc)
        if handoff.ks.is_cuda:
            torch.cuda.synchronize()
        os._exit(1)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("host_cls", [DiesBeforeOpen, DiesAfterOpen])
def test_replica_dead_in_import_leaves_nothing_pinned(device, host_cls):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA IPC opens only there)")
    params, cfg = _build_port(device)
    pw = PrefillWorker(params, cfg, prefill_buckets=(16,), page_size=8,
                       device=device)
    sp = SamplingParams(max_tokens=4)
    pw.prefill(PROMPTS[0], sp)              # the workspace, allocated
    store = t_store.default_store()
    opts = {"env_vars": {"OMP_NUM_THREADS": "1"}}
    if device == "cpu":
        opts["device"] = "cpu"
    rep = RemoteReplica(functools.partial(_build_port, device), name="dies",
                        engine_options=dict(ENGINE_OPTS, device=device),
                        cache_capacity_bytes=1 << 20, host_cls=host_cls,
                        actor_options=opts)
    try:
        if device == "cuda":
            gc.collect()        # an earlier test's garbage, freed now
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
        h = pw.prefill(PROMPTS[1], sp)
        assert rep.import_prefill(h) is None
        assert rep.state == "dead"
        assert store.stats()["num_objects"] == 0
        del h
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.ipc_collect()
            assert torch.cuda.memory_allocated() == base
    finally:
        rep.kill()

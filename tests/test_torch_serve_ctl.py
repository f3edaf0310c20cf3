"""The serve controller, batching, multiplexing and the HTTP ingress of
``ray_tpu_torch.serve`` against ``ray_tpu.serve``, on the CPU.

The scenarios of tests/test_serve.py (batching, the multiplexed LRU and
the router's model affinity, a dead replica recreated, autoscaling up and
down, the replica-set snapshot pushed on a change, the HTTP ingress) and
the chunked stream of tests/test_serve_ha.py, each run under both
packages with the same deployment classes: each run is held to the JAX
test's expectations, and the port's run to the JAX run's own result where
that ran first in this process.  Then a handle called from inside another
deployment's replica, under both packages.  Results are exact (ints,
strings, process counts); no tolerance.

Classes are module level (the port's replicas import them by reference);
the two packages' decorators (``batch``, ``multiplexed``) give each its
own class.  The port's replicas run torch on one thread; every ``get``
has a timeout.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import time
import urllib.request

import pytest

from ray_tpu.serve import batching as j_batching
from ray_tpu.serve import multiplex as j_multiplex
from ray_tpu_torch.serve import batching as t_batching
from ray_tpu_torch.serve import multiplex as t_multiplex

PKGS = ("ray_tpu", "ray_tpu_torch")
ONE_THREAD = {"num_cpus": 1, "env_vars": {"OMP_NUM_THREADS": "1"}}
#: Each scenario's result under the JAX package, for the port's run.
JAX_RESULTS = {}


def _named(cls, name):
    """Give a class built by a factory a module-level name (so the port
    pickles it by reference)."""
    cls.__name__ = cls.__qualname__ = name
    globals()[name] = cls
    return cls


def _batch_adder(batch, name):
    class BatchAdder:
        @batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def __call__(self, items):
            # Whole batch processed at once.
            return [i + 100 for i in items]
    return _named(BatchAdder, name)


def _multi_model(multiplexed, name):
    class MultiModel:
        def __init__(self):
            self.loads = []

        @multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            self.loads.append(model_id)
            return f"model:{model_id}"

        def __call__(self, x):
            model = self.get_model()
            return {"model": model, "loads": list(self.loads),
                    "resident": self.get_model.loaded_model_ids}
    return _named(MultiModel, name)


def _pid_model(multiplexed, name):
    class PidModel:
        @multiplexed(max_num_models_per_replica=4)
        def get_model(self, model_id):
            return model_id

        def __call__(self, x):
            self.get_model()
            return os.getpid()
    return _named(PidModel, name)


BATCH = {"ray_tpu": _batch_adder(j_batching.batch, "BatchAdderJ"),
         "ray_tpu_torch": _batch_adder(t_batching.batch, "BatchAdderT")}
MULTI = {"ray_tpu": _multi_model(j_multiplex.multiplexed, "MultiModelJ"),
         "ray_tpu_torch": _multi_model(t_multiplex.multiplexed,
                                       "MultiModelT")}
PID_MODEL = {"ray_tpu": _pid_model(j_multiplex.multiplexed, "PidModelJ"),
             "ray_tpu_torch": _pid_model(t_multiplex.multiplexed,
                                         "PidModelT")}


class Doubler:
    def __call__(self, payload):
        if isinstance(payload, dict):
            return {"doubled": payload.get("x", 0) * 2}
        return payload * 2

    def pid(self):
        return os.getpid()


class Slow:
    def __call__(self, t):
        time.sleep(t)
        return "done"


class Tok:
    def __call__(self, body):
        for i in range(int(body.get("n", 3))):
            yield {"token": i}


class Outer:
    """Calls another deployment from inside its replica."""

    def __init__(self, pkg):
        self.pkg = pkg

    def __call__(self, x):
        serve = importlib.import_module(f"{self.pkg}.serve")
        inner = serve.get_deployment_handle("Inner")
        ref = inner.remote(x)
        if self.pkg == "ray_tpu":
            import ray_tpu
            return ray_tpu.get(ref, timeout=60) + 1
        from ray_tpu_torch import _actor
        return _actor.get(ref, timeout=60) + 1


class _Side:
    """One package's serve surface, as the scenarios use it."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.serve = importlib.import_module(f"{pkg}.serve")

    def deployment(self, cls, **kw):
        if self.pkg == "ray_tpu_torch":
            kw.setdefault("ray_actor_options", ONE_THREAD)
        return self.serve.deployment(cls, **kw)

    def get(self, refs, timeout=60):
        if self.pkg == "ray_tpu":
            import ray_tpu
            return ray_tpu.get(refs, timeout=timeout)
        from ray_tpu_torch import _actor
        return _actor.get(refs, timeout=timeout)

    def snapshot(self, name):
        """(version, [replica id, ...]) of the published replica set."""
        if self.pkg == "ray_tpu":
            from ray_tpu._private.api import _control
            from ray_tpu.serve.controller import REPLICA_KV_PREFIX
            blob = _control("kv_get", REPLICA_KV_PREFIX + name)
        else:
            from ray_tpu_torch import _actor
            from ray_tpu_torch.serve.controller import REPLICA_KV_PREFIX
            blob = _actor._plane().kv_get(REPLICA_KV_PREFIX + name)
        version, entries = pickle.loads(blob)[:2]
        return version, [e[0] for e in entries]

    def kill(self, replica_id, cls_name):
        if self.pkg == "ray_tpu":
            import ray_tpu
            from ray_tpu._private.api import ActorHandle
            from ray_tpu._private.ids import ActorID
            ray_tpu.kill(ActorHandle(ActorID(bytes.fromhex(replica_id)),
                                     cls_name))
        else:
            from ray_tpu_torch import _actor
            _actor.kill(_actor.ActorHandle(replica_id, cls_name))

    def http_port(self):
        if self.pkg == "ray_tpu":
            return self.serve.api._http_server.port
        return self.serve.api.http_address()[1]


@pytest.fixture(params=PKGS)
def side(request):
    if request.param == "ray_tpu":
        request.getfixturevalue("ray_start")
    s = _Side(request.param)
    yield s
    s.serve.shutdown()


def _held(side, key, result, want=None):
    """``result`` against the JAX test's expectation and, for the port,
    against the JAX run's result."""
    if want is not None:
        assert result == want
    if side.pkg == "ray_tpu":
        JAX_RESULTS[key] = result
    elif key in JAX_RESULTS:
        assert result == JAX_RESULTS[key]


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    pytest.fail(f"timed out: {what}")


def test_batch_accumulates(side):
    h = side.serve.run(side.deployment(BATCH[side.pkg]).bind())
    refs = [h.remote(i) for i in range(8)]
    _held(side, "batch", sorted(side.get(refs)),
          [100 + i for i in range(8)])


def test_multiplex_lru_cache_and_eviction(side):
    h = side.serve.run(side.deployment(MULTI[side.pkg],
                                       num_replicas=1).bind())

    def ask(mid):
        return side.get(h.options(multiplexed_model_id=mid).remote(0))

    r1 = ask("m1")
    assert r1["model"] == "model:m1" and r1["loads"] == ["m1"]
    ask("m2")
    r3 = ask("m1")          # cached: no reload
    r4 = ask("m3")          # evicts m2 (LRU)
    r5 = ask("m2")          # m2 was evicted: reloaded
    got = [r3["loads"], r4["loads"], sorted(r4["resident"]), r5["loads"]]
    _held(side, "multiplex_lru", got,
          [["m1", "m2"], ["m1", "m2", "m3"], ["m1", "m3"],
           ["m1", "m2", "m3", "m2"]])


def test_multiplex_router_affinity(side):
    h = side.serve.run(side.deployment(PID_MODEL[side.pkg],
                                       num_replicas=2).bind())
    hm = h.options(multiplexed_model_id="alpha")
    pids = [side.get(hm.remote(i)) for i in range(6)]
    # After the first request, every later request for the model lands on
    # the replica that holds it.
    _held(side, "affinity", len(set(pids[1:])), 1)
    assert side.serve.get_multiplexed_model_id() is None


def _settled(side, name, n):
    """The published replica set once it holds ``n`` replicas (JAX's
    controller can start one more while ``run`` is still starting the
    first ones, then drain it)."""
    _wait(lambda: len(side.snapshot(name)[1]) == n, 60,
          f"{n} replicas published")
    return side.snapshot(name)


def test_dead_replica_recreated(side):
    h = side.serve.run(side.deployment(Doubler, num_replicas=2).bind())
    assert side.get(h.remote(21)) == 42
    _v0, ids = _settled(side, "Doubler", 2)
    side.kill(ids[0], "Doubler")
    # The controller notices the death and backfills to the target.
    _wait(lambda: (lambda s: ids[0] not in s[1] and len(s[1]) == 2)(
        side.snapshot("Doubler")), 90, "backfill")
    # Served after the recovery (the router converges from the snapshot).
    _held(side, "recreated", side.get(h.remote(5)), 10)


def test_autoscale_up_and_down(side):
    cfg = side.serve.AutoscalingConfig(
        min_replicas=1, max_replicas=2, target_ongoing_requests=1.0,
        upscale_delay_s=0.3, downscale_delay_s=0.6)
    h = side.serve.run(side.deployment(
        Slow, num_replicas=1, max_ongoing_requests=4,
        autoscaling_config=cfg).bind())

    def n_replicas():
        return side.serve.status()["Slow"]["num_replicas"]

    # Load: more slow concurrent requests than the target per replica.
    refs = [h.remote(2.0) for _ in range(6)]
    _wait(lambda: n_replicas() >= 2, 60, "scale up")
    up = n_replicas()
    assert side.get(refs, timeout=120) == ["done"] * 6
    # Idle: back down to the minimum.
    _wait(lambda: n_replicas() == 1, 60, "scale down")
    _held(side, "autoscale", (up, n_replicas()), (2, 1))


def test_replica_set_push_on_change(side):
    side.serve.run(side.deployment(Doubler, num_replicas=1).bind())
    v0, ids = _settled(side, "Doubler", 1)
    side.kill(ids[0], "Doubler")

    def republished():
        v1, ids1 = side.snapshot("Doubler")
        return v1 > v0 and ids1 and ids1[0] != ids[0]
    _wait(republished, 90, "snapshot re-published after the death")
    _held(side, "push", len(side.snapshot("Doubler")[1]), 1)


def test_http_ingress(side):
    side.serve.run(side.deployment(Doubler, num_replicas=1).bind(),
                   http_port=0)
    req = urllib.request.Request(
        f"http://127.0.0.1:{side.http_port()}/Doubler",
        data=json.dumps({"x": 5}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
    _held(side, "http", body, {"result": {"doubled": 10}})


def test_http_chunked_stream(side):
    h = side.serve.run(side.deployment(Tok, num_replicas=1).bind(),
                       http_port=0)
    req = urllib.request.Request(
        f"http://127.0.0.1:{side.http_port()}/Tok",
        data=json.dumps({"n": 3, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(x) for x in resp.read().splitlines() if x]
    items = [side.get(r) for r in h.options(stream=True).remote({"n": 3})]
    assert [x["result"] for x in lines] == items
    _held(side, "stream", [x["result"]["token"] for x in lines], [0, 1, 2])


def test_handle_inside_a_replica(side):
    side.serve.run(side.deployment(Doubler, name="Inner").bind())
    h = side.serve.run(side.deployment(Outer).bind(side.pkg))
    _held(side, "nested", side.get([h.remote(i) for i in range(3)]),
          [1, 3, 5])

"""The port's one-host surfaces against the JAX package's: tracing across
submits (``util.tracing``), user metrics (``util.metrics``), ``ActorPool``,
``Queue``, the checkpoint shim and the ``workflow`` tombstone.

- traceparent strings are byte-equal, and parse back the same;
- a driver span submitting a task that submits a nested task renders the
  same trace tree (names and nesting; span ids and durations aside) in
  both packages, and the OTLP/JSON export parses;
- the same user metrics render the same Prometheus text (there are no
  timestamps in it), driver-side and recorded in a task; an actor's reach
  the driver's scrape too, and the HTTP server serves it;
- ``tests/test_util.py``'s ``ActorPool`` and ``Queue`` cases give the
  same results from both packages.

JAX runs under the conftest ``ray_start`` runtime and the port under one
module session; the port's is set up after JAX's and torn down before
it (the JAX sanitizer counts the port's threads as framework threads).
"""

from __future__ import annotations

import json
import re
import urllib.request

import pytest

import ray_tpu_torch as rtt
from ray_tpu_torch.util import metrics as p_metrics
from ray_tpu_torch.util import tracing as p_tracing

TIMEOUT = 60


# -- functions and classes both packages wrap ------------------------------------


def _pkg(name):
    import importlib
    return importlib.import_module(name)


def leaf(x):
    return x + 1


def middle(pkg_name, x):
    rt = _pkg(pkg_name)
    return rt.get(rt.remote(leaf).remote(x)) * 10


def record_metrics(pkg_name):
    m = _pkg(f"{pkg_name}.util.metrics")
    m.Counter("t_util_task_total", "tasks that ran", ("kind",)).inc(
        2.0, tags={"kind": "a"})
    m.Histogram("t_util_task_seconds", "task seconds",
                boundaries=[0.1, 1.0]).observe(0.5)
    return True


class MetricActor:
    def __init__(self, pkg_name):
        self.m = _pkg(f"{pkg_name}.util.metrics")
        self.c = self.m.Counter("t_util_actor_total", "actor calls",
                                ("who",))
        self.h = self.m.Histogram("t_util_actor_seconds", "actor seconds",
                                  boundaries=[0.01, 0.1, 1.0])

    def work(self, v):
        self.c.inc(1.0, tags={"who": "actor"})
        self.h.observe(v)
        return v


class Doubler:
    def double(self, v):
        return v * 2


class Erroring:
    def fail(self):
        raise ValueError("task failed")


def produce(queue, n):
    for i in range(n):
        queue.put(i)
    return n


# -- fixtures ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def port(ray_start):
    session = rtt.init(num_cpus=4)
    yield session
    rtt.shutdown()


@pytest.fixture(scope="module")
def both(ray_start, port):
    import ray_tpu
    return {"jax": ray_tpu, "port": rtt}


@pytest.fixture(scope="module")
def doublers(both):
    out = {k: [rt.remote(Doubler).options(num_cpus=0).remote()
               for _ in range(2)] for k, rt in both.items()}
    for k, rt in both.items():
        assert rt.get([a.double.remote(1) for a in out[k]]) == [2, 2]
    return out


# -- tracing ----------------------------------------------------------------------


def test_traceparent_round_trip_byte_equal():
    from ray_tpu.util import tracing as j_tracing
    for trace_id, span_id in [("0" * 32, "0" * 16), ("a1" * 16, "b2" * 8),
                              (p_tracing._rand_hex(16),
                               p_tracing._rand_hex(8))]:
        j = j_tracing.SpanContext(trace_id, span_id).traceparent()
        p = p_tracing.SpanContext(trace_id, span_id).traceparent()
        assert p == j and p.encode() == j.encode()
        back = p_tracing.SpanContext.from_traceparent(p)
        assert (back.trace_id, back.span_id) == (trace_id, span_id)
    for bad in ("", "00-abc-def-01", "00-" + "a" * 32 + "-" + "b" * 15 +
                "-01", "nonsense"):
        assert p_tracing.SpanContext.from_traceparent(bad) is None
        assert j_tracing.SpanContext.from_traceparent(bad) is None


def _shape(text: str):
    """A rendered trace's tree: indentation and span names."""
    return [re.sub(r" \[[0-9a-f]+\] [0-9.]+ms$", "", line)
            for line in text.splitlines()[1:]]


def _trace_of(rt, tracing):
    tracing.enable()
    try:
        with tracing.span("driver"):
            tid = tracing.current().trace_id
            out = rt.get(rt.remote(middle).remote(rt.__name__, 4),
                         timeout=TIMEOUT)
    finally:
        tracing.disable()
    return out, tid


def test_render_trace_across_submits_matches_jax(both, tmp_path):
    from ray_tpu.util import tracing as j_tracing
    j_out, j_tid = _trace_of(both["jax"], j_tracing)
    p_out, p_tid = _trace_of(rtt, p_tracing)
    assert p_out == j_out == 50
    want = _shape(j_tracing.render_trace(j_tid))
    got = _shape(p_tracing.render_trace(p_tid))
    assert got == want
    assert got == ["  - driver", "    - submit middle",
                   "      - execute middle", "        - submit leaf",
                   "          - execute leaf"]
    path = p_tracing.export_otlp_json(str(tmp_path / "trace.json"), p_tid)
    with open(path) as f:
        doc = json.load(f)
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert len(spans) == 5 and {s["traceId"] for s in spans} == {p_tid}


def test_actor_call_carries_the_trace(both):
    from ray_tpu.util import tracing as j_tracing
    shapes = {}
    for k, (rt, tracing) in {"jax": (both["jax"], j_tracing),
                             "port": (rtt, p_tracing)}.items():
        a = rt.remote(Doubler).options(num_cpus=0).remote()
        rt.get(a.double.remote(0))
        tracing.enable()
        try:
            with tracing.span("caller"):
                tid = tracing.current().trace_id
                assert rt.get(a.double.remote(21)) == 42
        finally:
            tracing.disable()
        shapes[k] = _shape(tracing.render_trace(tid))
        rt.kill(a)
    assert shapes["port"][:2] == shapes["jax"][:2] == [
        "  - caller", "    - submit Doubler.double"]
    assert shapes["port"] == ["  - caller", "    - submit Doubler.double",
                              "      - execute Doubler.double"]


# -- metrics ----------------------------------------------------------------------


def _user_metrics(m):
    c = m.Counter("t_util_requests_total", "requests", ("route",))
    c.inc(3.0, tags={"route": "/a"})
    c.inc(1.0, tags={"route": "/b"})
    g = m.Gauge("t_util_queue_depth", "depth")
    g.set(7.0)
    h = m.Histogram("t_util_latency_seconds", "latency",
                    boundaries=[0.01, 0.1, 1.0], tag_keys=("route",))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v, tags={"route": "/a"})
    return m.prometheus_text()


def test_prometheus_text_matches_jax():
    from ray_tpu.util import metrics as j_metrics
    j_metrics._reset_for_tests()
    p_metrics._reset_for_tests()
    want = _user_metrics(j_metrics)
    got = _user_metrics(p_metrics)
    assert got == want
    assert 't_util_latency_seconds_bucket{le="+Inf",route="/a"} 4.0' in got
    j_metrics._reset_for_tests()
    p_metrics._reset_for_tests()


def _series(text, prefix):
    return sorted(line for line in text.splitlines()
                  if line.startswith(prefix))


def test_task_metrics_reach_the_driver_as_jax(both):
    from ray_tpu.util import metrics as j_metrics
    texts = {}
    for k, m in (("jax", j_metrics), ("port", p_metrics)):
        rt = both[k]
        assert rt.get(rt.remote(record_metrics).remote(rt.__name__),
                      timeout=TIMEOUT)
        texts[k] = _series(m.prometheus_text(), "t_util_task")
    assert texts["port"] == texts["jax"]
    assert 't_util_task_total{kind="a"} 2.0' in texts["port"]


def test_actor_metrics_served_over_http(both):
    """A user Counter and Histogram made in an actor, scraped from the
    driver's metrics server on a free localhost port."""
    a = rtt.remote(MetricActor).options(num_cpus=0).remote("ray_tpu_torch")
    assert rtt.get([a.work.remote(v) for v in (0.05, 0.5)]) == [0.05, 0.5]
    port = p_metrics.start_metrics_server(0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=TIMEOUT) as r:
            text = r.read().decode()
    finally:
        p_metrics.stop_metrics_server()
    assert 't_util_actor_total{who="actor"} 2.0' in text
    assert 't_util_actor_seconds_bucket{le="0.1"} 1.0' in text
    assert "t_util_actor_seconds_count 2.0" in text
    # Killed, the actor's last values stay in the view.
    rtt.kill(a)
    assert 't_util_actor_total{who="actor"} 2.0' in \
        p_metrics.prometheus_text()


def test_telemetry_catalog_instances_match_jax():
    from ray_tpu.util import telemetry as j_tel
    from ray_tpu_torch.util import telemetry as p_tel
    for fn, name in (("counter", "ray_tpu_internal_swallowed_errors_total"),
                     ("histogram", "ray_tpu_lock_wait_seconds")):
        j, p = getattr(j_tel, fn)(name), getattr(p_tel, fn)(name)
        assert type(p).__name__ == type(j).__name__
        assert p.info["tag_keys"] == j.info["tag_keys"]
        assert getattr(p_tel, fn)(name) is p
    with pytest.raises(TypeError):
        p_tel.gauge("ray_tpu_internal_swallowed_errors_total")
    with pytest.raises(KeyError):
        p_tel.counter("ray_tpu_not_in_the_catalog_total")


# -- ActorPool ----------------------------------------------------------------------


def _pool(doublers, k):
    from ray_tpu.util import ActorPool as JPool
    from ray_tpu_torch.util import ActorPool as PPool
    return (JPool if k == "jax" else PPool)(list(doublers[k]))


def pool_map(pool, rt):
    return list(pool.map(lambda a, v: a.double.remote(v), range(5)))


def pool_map_unordered(pool, rt):
    return sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                     range(5)))


def pool_submit_get_next(pool, rt):
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 11)
    return pool.get_next(), pool.get_next(), pool.has_next()


def pool_push_pop(pool, rt):
    a = pool.pop_idle()
    b = pool.pop_idle()
    empty = not pool.has_free()
    pool.push(a)
    pool.push(b)
    return empty, pool.has_free()


def pool_survives_task_error(pool, rt):
    err = rt.remote(Erroring).options(num_cpus=0).remote()
    pool.submit(lambda a, v: a.double.remote(v), 1)
    pool.submit(lambda a, v: err.fail.remote(), 2)
    first = pool.get_next()
    with pytest.raises(Exception):
        pool.get_next()
    pool.submit(lambda a, v: a.double.remote(v), 5)
    out = (first, pool.get_next())
    rt.kill(err)
    return out


POOL_CASES = [pool_map, pool_map_unordered, pool_submit_get_next,
              pool_push_pop, pool_survives_task_error]


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=[c.__name__ for c in POOL_CASES])
def test_actor_pool_matches_jax(case, both, doublers):
    out = {k: case(_pool(doublers, k), both[k]) for k in both}
    assert out["port"] == out["jax"]


# -- Queue ---------------------------------------------------------------------------


def _queue(k, **kw):
    from ray_tpu.util import Queue as JQueue
    from ray_tpu_torch.util import Queue as PQueue
    return (JQueue if k == "jax" else PQueue)(
        actor_options={"num_cpus": 0}, **kw)


def _errors(k):
    if k == "jax":
        from ray_tpu.util import Empty, Full
    else:
        from ray_tpu_torch.util import Empty, Full
    return Empty, Full


def queue_put_get(q, k, rt):
    q.put(1)
    q.put("two")
    return q.get(), q.get(), q.empty()


def queue_empty_and_timeouts(q, k, rt):
    Empty, _Full = _errors(k)
    out = []
    with pytest.raises(Empty):
        q.get_nowait()
    out.append("nowait")
    with pytest.raises(Empty):
        q.get(timeout=0.3)
    out.append("timeout")
    q.put_nowait(5)
    out.append(q.get(block=False))
    return out


def queue_full(q, k, rt):
    _Empty, Full = _errors(k)
    q.put(1)
    q.put(2)
    out = [q.full(), q.qsize()]
    with pytest.raises(Full):
        q.put_nowait(3)
    with pytest.raises(Full):
        q.put(3, timeout=0.3)
    with pytest.raises(Full):
        q.put_nowait_batch([3, 4])
    out.append(q.get_nowait_batch(5))
    q.put_nowait_batch([7, 8])
    out.append(q.size())
    return out


def queue_batch_and_size(q, k, rt):
    q.put_nowait_batch([1, 2, 3])
    return q.qsize(), q.get_nowait_batch(2), q.qsize()


def queue_passed_to_task(q, k, rt):
    n = rt.get(rt.remote(produce).remote(q, 3), timeout=TIMEOUT)
    return n, [q.get(timeout=TIMEOUT) for _ in range(3)]


QUEUE_CASES = [(queue_put_get, {}), (queue_empty_and_timeouts, {}),
               (queue_full, {"maxsize": 2}), (queue_batch_and_size, {}),
               (queue_passed_to_task, {})]


@pytest.mark.parametrize("case,kw", QUEUE_CASES,
                         ids=[c.__name__ for c, _kw in QUEUE_CASES])
def test_queue_matches_jax(case, kw, both):
    out = {}
    for k, rt in both.items():
        q = _queue(k, **kw)
        try:
            out[k] = case(q, k, rt)
        finally:
            q.shutdown()
    assert out["port"] == out["jax"]


# -- shims -----------------------------------------------------------------------------


def test_workflow_tombstone():
    with pytest.raises(ImportError, match="deprecated"):
        import ray_tpu_torch.workflow  # noqa: F401
    with pytest.raises(ImportError):
        import ray_tpu.workflow  # noqa: F401


def test_train_checkpoint_shim_matches_jax():
    import ray_tpu.train._checkpoint as j
    import ray_tpu_torch.train._checkpoint as p
    from ray_tpu_torch.checkpoint import format as fmt
    from ray_tpu_torch.checkpoint import manager
    assert p.__all__ == j.__all__
    assert (p.Checkpoint, p.CheckpointManager, p.save_pytree,
            p.load_pytree) == (manager.Checkpoint, manager.CheckpointManager,
                               fmt.save_pytree, fmt.load_pytree)

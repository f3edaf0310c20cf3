"""ROADMAP Queue 3 faults 9-11 and 15, each held against the JAX package on the
same class or function, both sessions at ``init(num_cpus=2)``:

- 9: an actor method called with ``num_returns=2`` returns two refs;
- 10: a task submits a streaming task (both packages give it a
  generator) and, in the port, reads its items while the producer still
  runs (the producer holds its second item until the consumer has opened
  a gate file after reading the first: gated on that event, not on time),
  the same items the JAX package's driver reads from the same producer
  (JAX's generator iterates in the driver only: in a worker it raises
  "driver-side only");
- 11: the two packages' ``__all__`` differ only by the names later items
  still owe;
- 15: two threads of one task ask the driver at once (one waits in
  ``get`` on an inner task that only the other's inner task lets end).

The port's session starts before the JAX runtime and ends before it: the
JAX package's leak sanitizer counts threads started from any path under
``ray_tpu*`` (the port's too) that are still alive at its shutdown.
"""

from __future__ import annotations

import importlib
import os
import time
import uuid

import pytest

import ray_tpu_torch as rtt

TIMEOUT = 60


class Pair:
    def two(self):
        return 1, 2

    def three(self, x):
        return x, x + 1, x + 2

    def wrong(self):
        return 1, 2, 3


def gated_gen(gate):
    yield 0
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(gate) and time.monotonic() < deadline:
        time.sleep(0.01)
    yield os.path.exists(gate)
    yield 2


def consume_stream(rt, gate):
    it = iter(rt.remote(num_returns="streaming")(gated_gen).remote(gate))
    first = rt.get(next(it))
    open(gate, "w").close()
    return [first] + [rt.get(r) for r in it]


def consume_nested_stream(pkg_name, gate):
    return consume_stream(importlib.import_module(pkg_name), gate)


def submit_nested_stream(pkg_name, gate):
    rt = importlib.import_module(pkg_name)
    gen = rt.remote(num_returns="streaming")(gated_gen).remote(gate)
    open(gate, "w").close()
    return isinstance(gen, rt.ObjectRefGenerator)


def wait_for_gate(gate):
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(gate) and time.monotonic() < deadline:
        time.sleep(0.01)
    return os.path.exists(gate)


def open_gate(gate):
    open(gate, "w").close()
    return "opened"


def two_threads_in_a_task(pkg_name, gate):
    """One thread of the task waits on an inner task that ends only once
    another thread of the same task has run a second inner task."""
    import threading
    rt = importlib.import_module(pkg_name)
    waiting = threading.Event()
    out = {}

    def opener():
        waiting.wait(TIMEOUT)
        out["opener"] = rt.get(rt.remote(num_cpus=0)(open_gate).remote(
            gate), timeout=TIMEOUT)

    t = threading.Thread(target=opener)
    t.start()
    # No CPU asked: what is tested is the requests, not the booking.
    ref = rt.remote(num_cpus=0)(wait_for_gate).remote(gate)
    waiting.set()
    out["waiter"] = rt.get(ref, timeout=TIMEOUT)
    t.join(TIMEOUT)
    return out


@pytest.fixture(scope="module")
def both():
    rtt.init(num_cpus=2)
    import ray_tpu
    ray_tpu.init(num_cpus=2)
    yield ray_tpu
    rtt.shutdown()
    ray_tpu.shutdown()


def _pair(rt):
    return rt.remote(Pair).options(num_cpus=0).remote()


def test_actor_num_returns_two_matches_jax(both):
    """Fault 9."""
    out = {}
    for rt in (both, rtt):
        a = _pair(rt)
        refs = a.two.options(num_returns=2).remote()
        r3 = a.three.options(num_returns=3).remote(10)
        out[rt.__name__] = (len(refs), rt.get(list(refs)),
                            rt.get(list(r3)))
        rt.kill(a)
    assert out["ray_tpu_torch"] == out["ray_tpu"] == (2, [1, 2],
                                                      [10, 11, 12])


def test_actor_num_returns_mismatch_raises(both):
    a = _pair(rtt)
    refs = a.wrong.options(num_returns=2).remote()
    for r in refs:
        with pytest.raises(ValueError, match="num_returns=2"):
            rtt.get(r, timeout=TIMEOUT)
    with pytest.raises(ValueError):
        a.two.options(num_returns=0).remote()
    rtt.kill(a)


def test_nested_streaming_task_matches_jax(both, tmp_path):
    """Fault 10: a task's streaming submit gives a generator in both
    packages; the port's items reach the consuming task while the
    producer runs, as the JAX driver's do."""
    def gate():
        return str(tmp_path / f"gate_{uuid.uuid4().hex}")

    submitted = [rt.get(rt.remote(submit_nested_stream).remote(
        rt.__name__, gate()), timeout=TIMEOUT) for rt in (both, rtt)]
    assert submitted == [True, True]
    want = consume_stream(both, gate())
    got = rtt.get(rtt.remote(consume_nested_stream).remote(
        "ray_tpu_torch", gate()), timeout=TIMEOUT)
    assert got == want == [0, True, 2]


def test_top_level_names_match_jax():
    """Fault 11: the port exports the actor classes; the JAX names it
    still lacks are those items 13 and 14 owe."""
    import ray_tpu
    assert set(ray_tpu.__all__) - set(rtt.__all__) == {"ObjectLostError",
                                                        "timeline"}
    assert set(rtt.__all__) - set(ray_tpu.__all__) == {
        "RuntimeEnvSetupError"}
    for name in rtt.__all__:
        assert hasattr(rtt, name), name
    from ray_tpu_torch import _actor
    assert (rtt.ActorClass, rtt.ActorHandle, rtt.ActorMethod) == \
        (_actor.ActorClass, _actor.ActorHandle, _actor.ActorMethod)


def test_threads_of_a_task_ask_the_driver_at_once(both, tmp_path):
    """Queue 3 item 15: a thread of a task waiting in ``get`` holds up no
    other thread of it (the port's worker link answers by request id)."""
    out = {}
    for rt in (both, rtt):
        gate = str(tmp_path / f"gate_{uuid.uuid4().hex}")
        out[rt.__name__] = rt.get(rt.remote(two_threads_in_a_task).remote(
            rt.__name__, gate), timeout=2 * TIMEOUT)
    assert out["ray_tpu_torch"] == out["ray_tpu"] == {
        "opener": "opened", "waiter": True}

"""The port's process actors (``ray_tpu_torch._actor``) against the JAX
package's actor API.

One call sequence (ordered calls, an exception, a stream, ``put`` and a
ref argument, ``wait``) runs through both packages' ``remote`` on the same
class, and the results agree.  Then the port alone: ``max_concurrency``,
``get`` timeouts, ``kill`` failing calls in flight, the by-reference rule
(a lambda or a nested class raises ``ValueError`` at ``.remote()``, naming
the rule), a constructor that raises, and no orphans: a parent that dies
(by an exception, or killed) leaves no actor process behind.

Actors run torch on one thread; every ``get`` has a timeout.  The JAX
package is imported inside the one test that uses it: each actor imports
this file.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from ray_tpu_torch import _actor as A

ONE_THREAD = {"num_cpus": 1, "env_vars": {"OMP_NUM_THREADS": "1"}}


class Counter:
    """A plain class: both packages' ``remote`` wrap it."""

    def __init__(self, start=0):
        self.n = start
        self.log = []

    def inc(self, k=1):
        self.n += k
        self.log.append(k)
        return self.n

    def history(self):
        return list(self.log)

    def boom(self, msg):
        raise ValueError(msg)

    def squares(self, n):
        for i in range(n):
            yield i * i

    def total(self, arr):
        return float(np.asarray(arr).sum())

    def sleep(self, s):
        time.sleep(s)
        return s

    def pid(self):
        return os.getpid()

    def die(self):
        os._exit(7)


class Broken:
    def __init__(self):
        raise RuntimeError("no constructor today")

    def ping(self):
        return "ok"


def _sequence(remote, get, put, wait, kill, TaskError):
    """The same calls through one package; returns what they gave."""
    c = remote(Counter).remote(5)
    out = {"inc": get([c.inc.remote(k) for k in (1, 2, 3)], timeout=120)}
    try:
        get(c.boom.remote("bad"), timeout=60)
    except TaskError as e:
        out["error"] = (type(e.cause).__name__, str(e.cause))
    gen = c.squares.options(num_returns="streaming").remote(5)
    out["stream"] = [get(r, timeout=60) for r in gen]
    ref = put(np.arange(10.0))
    out["ref_arg"] = get(c.total.remote(ref), timeout=60)
    slow, fast = c.sleep.remote(0.2), c.inc.remote(10)
    ready, pending = wait([slow, fast], num_returns=1, timeout=60)
    # One thread: the calls run in order, so the slow one finishes first.
    out["wait"] = (get(ready[0], timeout=60), len(pending))
    out["history"] = get(c.history.remote(), timeout=60)
    kill(c)
    return out


def test_call_sequence_matches_jax(ray_start):
    import ray_tpu
    from ray_tpu._private.exceptions import TaskError as JTaskError
    want = _sequence(ray_tpu.remote, ray_tpu.get, ray_tpu.put,
                     ray_tpu.wait, ray_tpu.kill, JTaskError)
    got = _sequence(lambda cls: A.remote(cls).options(**ONE_THREAD), A.get,
                    A.put, A.wait, A.kill, A.TaskError)
    assert got == want
    assert got["inc"] == [6, 8, 11] and got["stream"] == [0, 1, 4, 9, 16]


@pytest.fixture(scope="module")
def counter():
    c = A.remote(Counter).options(**ONE_THREAD).remote()
    yield c
    A.kill(c)


def test_max_concurrency_runs_calls_together():
    c = A.remote(Counter).options(max_concurrency=4, **ONE_THREAD).remote()
    try:
        A.get(c.pid.remote(), timeout=120)
        t0 = time.monotonic()
        assert A.get([c.sleep.remote(0.5) for _ in range(4)],
                     timeout=60) == [0.5] * 4
        assert time.monotonic() - t0 < 1.5
    finally:
        A.kill(c)


def test_get_timeout_then_the_value(counter):
    ref = counter.sleep.remote(1.0)
    with pytest.raises(A.GetTimeoutError):
        A.get(ref, timeout=0.05)
    assert A.get(ref, timeout=60) == 1.0
    ready, pending = A.wait([counter.sleep.remote(1.0)], num_returns=1,
                            timeout=0.1)
    assert ready == [] and len(pending) == 1
    assert A.get(pending[0], timeout=60) == 1.0


def test_by_reference_rule():
    with pytest.raises(ValueError, match="top level of a module"):
        A.remote(Counter).remote(lambda: 1)

    def local_fn():
        return 1

    with pytest.raises(ValueError, match="lambdas and nested functions"):
        A.remote(Counter).remote(local_fn)

    class Local:
        pass

    with pytest.raises(ValueError, match="top level of a module"):
        A.remote(Local).remote()
    # A function becomes a task (ray_tpu_torch._tasks); a nested one is
    # refused at .remote() by the same rule, before any session is asked.
    with pytest.raises(ValueError, match="lambdas and nested functions"):
        A.remote(local_fn).remote()
    with pytest.raises(ValueError, match="unknown actor options"):
        A.remote(Counter).options(num_replicas=2)


def test_method_error_keeps_the_actor_and_kill_fails_calls(counter):
    with pytest.raises(A.TaskError) as e:
        A.get(counter.boom.remote("x"), timeout=60)
    assert isinstance(e.value.cause, ValueError)
    assert "raise ValueError(msg)" in e.value.remote_traceback
    # The actor lives on.
    assert A.get(counter.inc.remote(0), timeout=60) >= 0
    c = A.remote(Counter).options(**ONE_THREAD).remote()
    pid = A.get(c.pid.remote(), timeout=120)
    inflight = c.sleep.remote(30)
    A.kill(c)
    with pytest.raises(A.ActorError):
        A.get(inflight, timeout=30)
    with pytest.raises(A.ActorError):
        A.get(c.inc.remote(), timeout=30)
    assert not _alive(pid)


def test_actor_death_and_broken_constructor():
    c = A.remote(Counter).options(**ONE_THREAD).remote()
    b = A.remote(Broken).options(**ONE_THREAD).remote()
    with pytest.raises(A.ActorError, match="exited"):
        A.get(c.die.remote(), timeout=120)
    with pytest.raises(A.ActorError, match="no constructor today"):
        A.get(b.ping.remote(), timeout=120)
    A.kill(b)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # A zombie (exited, not yet reaped by its parent) counts as gone.
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[1].split()[0] != "Z"
    except OSError:
        return False


_PARENT = textwrap.dedent("""
    import os, sys
    from ray_tpu_torch import _actor as A
    from test_torch_actor import Counter, ONE_THREAD

    if __name__ == "__main__":
        c = A.remote(Counter).options(**ONE_THREAD).remote()
        print(A.get(c.pid.remote(), timeout=120), flush=True)
        if sys.argv[1] == "raise":
            raise SystemExit("the parent failed")
        os._exit(1)    # no atexit: the actor's parent watch must act
""")


def test_no_orphans_when_the_parent_dies(tmp_path):
    """Two parents at once: one raises (atexit kills its actor), one exits
    with ``os._exit`` (the actor's parent watch ends it)."""
    script = tmp_path / "parent.py"
    script.write_text(_PARENT)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(__file__),
         os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]))
    parents = [subprocess.Popen([sys.executable, str(script), how], env=env,
                                stdout=subprocess.PIPE, text=True)
               for how in ("raise", "exit")]
    pids = []
    for d in parents:
        out, _ = d.communicate(timeout=180)
        assert d.returncode != 0
        pids.append(int(out.split()[0]))
    deadline = time.monotonic() + 15
    while any(map(_alive, pids)) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(map(_alive, pids))


@pytest.mark.parametrize("device,visible,want", [
    (None, None, {}), ("cuda", None, {}),
    ("cuda:2", None, {"CUDA_VISIBLE_DEVICES": "2"}),
    ("cuda:1", "4,5,6", {"CUDA_VISIBLE_DEVICES": "5"}),
    ("cpu", "0", {"CUDA_VISIBLE_DEVICES": ""})])
def test_device_option_is_the_visible_card(monkeypatch, device, visible,
                                           want):
    """An actor's ``device`` becomes its only visible card (CUDA's current
    device is per thread; the calls run on other threads than the one
    that would call ``set_device``)."""
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert A._device_env(device) == want
    with pytest.raises(ValueError, match="cuda"):
        A._device_env("tpu:0")

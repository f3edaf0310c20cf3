"""Scenarios of ``tests/test_torch_head.py``, run the same way through the
JAX package and the port, each in a fresh interpreter:

    python -m _torch_head_fns <scenario> <jax|port> [args...]

Each prints one JSON line (``RESULT {...}``) that the test compares
between the packages.  The functions and classes the scenarios send are
defined here, at the top level, so a head's workers import them by
reference (the port has no cloudpickle); the head runs with this
directory on its ``PYTHONPATH``.  Nothing here imports torch or JAX at
import time.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time


def add(a, b):
    return a + b


def one():
    return 1


def boom():
    raise ValueError("kapow")


class Counter:
    """JAX's ``tests/test_head_ft.py`` counter: ``bump`` gives base + n."""

    def __init__(self, base=0):
        self.base = base
        self.n = 0

    def bump(self):
        self.n += 1
        return self.base + self.n

    def pid(self):
        return os.getpid()

    def die(self):
        os._exit(1)

    def kv(self, key):
        """The session's KV verb from inside an actor."""
        from ray_tpu_torch._actor import control
        control("kv_put", key + "/actor", b"from-actor")
        return control("kv_get", key)


def kv_from_task(key):
    """The session's KV verb from inside a task."""
    from ray_tpu_torch._actor import control
    control("kv_put", key + "/task", b"from-task")
    return control("kv_get", key)


class Inc:
    """JAX's ``tests/test_client.py`` counter."""

    def __init__(self):
        self.v = 0

    def inc(self, k=1):
        self.v += k
        return self.v


def _pkg(name):
    """(the package, its control verb function) of ``name``."""
    if name == "jax":
        import ray_tpu as R
        from ray_tpu._private.api import _control
        return R, _control
    import ray_tpu_torch as R
    from ray_tpu_torch._actor import control
    return R, control


def _emit(out) -> None:
    print("RESULT " + json.dumps(out, sort_keys=True), flush=True)


def _until(fn, timeout=60.0):
    """``fn()`` once it stops raising (a revived actor takes a while)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except Exception:  # noqa: BLE001 - retried until the deadline
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def restart(pkg):
    """An actor with ``max_restarts=1``: killed once it answers with fresh
    state; killed again every call fails with ``ActorError``."""
    R, _ = _pkg(pkg)
    R.init(num_cpus=2)
    a = R.remote(Counter).options(max_restarts=1, num_cpus=0).remote(10)
    out = {"first": R.get(a.bump.remote(), timeout=120),
           "second": R.get(a.bump.remote(), timeout=60)}
    pid = R.get(a.pid.remote(), timeout=60)
    try:
        R.get(a.die.remote(), timeout=60)
        out["die1"] = "returned"
    except R.ActorError:
        out["die1"] = "ActorError"
    out["after_restart"] = _until(lambda: R.get(a.bump.remote(), timeout=60))
    out["new_pid"] = R.get(a.pid.remote(), timeout=60) != pid
    try:
        R.get(a.die.remote(), timeout=60)
        out["die2"] = "returned"
    except R.ActorError:
        out["die2"] = "ActorError"
    time.sleep(0.5)
    try:
        R.get(a.bump.remote(), timeout=60)
        out["after_death"] = "returned"
    except R.ActorError:
        out["after_death"] = "ActorError"
    R.shutdown()
    _emit(out)


def state_first(pkg, state_dir):
    """``init(state_dir=)``: a named actor, a placement group and a KV key,
    then SIGKILL (no shutdown runs; only the WAL remains)."""
    R, control = _pkg(pkg)
    R.init(num_cpus=2, state_dir=state_dir)
    c = R.remote(Counter).options(name="survivor", max_restarts=0,
                                  num_cpus=0).remote(100)
    bump = R.get(c.bump.remote(), timeout=120)
    pg = R.placement_group([{"CPU": 1}], strategy="PACK")
    ready = pg.ready(timeout=30)
    control("kv_put", "ft-key", b"ft-value")
    _emit({"bump": bump, "pg_ready": ready, "pg": pg.id.hex()})
    os.kill(os.getpid(), signal.SIGKILL)


def state_second(pkg, state_dir, pg_hex):
    """The same state dir in a fresh interpreter: the KV value, the named
    actor from its creation spec (fresh state: 101 again) and the
    placement group CREATED."""
    R, control = _pkg(pkg)
    R.init(num_cpus=2, state_dir=state_dir)
    out = {"kv": control("kv_get", "ft-key").decode()}
    out["bump"] = _until(lambda: R.get(
        R.get_actor("survivor").bump.remote(), timeout=30))
    pg_id = bytes.fromhex(pg_hex)
    out["pg_state"] = _until(
        lambda: _created(control("pg_state", pg_id)), 30)
    R.shutdown()
    _emit(out)


def _created(state):
    if state != "CREATED":
        raise RuntimeError(f"placement group {state}")
    return state


def client(pkg, address, token):
    """JAX's ``tests/test_client.py`` checks through a client."""
    import numpy as np
    R, control = _pkg(pkg)
    R.init(address=address, cluster_token=token.encode())
    radd = R.remote(add)
    out = {"add": R.get(radd.remote(2, 3), timeout=60)}
    small = R.put({"x": 1})
    big = R.put(np.arange(200_000, dtype=np.float32))
    arr = R.get(big, timeout=60)
    out["small"] = R.get(small, timeout=60)["x"]
    out["big"] = [list(arr.shape), float(arr[12345]), float(arr.sum())]
    out["ref_arg"] = R.get(radd.remote(radd.remote(1, 1), 3), timeout=60)
    refs = [radd.remote(i, i) for i in range(4)]
    ready, not_ready = R.wait(refs, num_returns=4, timeout=30)
    out["wait"] = [len(ready), len(not_ready)]
    out["wait_values"] = R.get(ready, timeout=60)
    c = R.remote(Inc).remote()
    out["actor"] = [R.get(c.inc.remote(), timeout=120),
                    R.get(c.inc.remote(5), timeout=60)]
    nodes = R.nodes() if pkg == "port" else control("nodes")
    out["is_head"] = any(n["is_head"] for n in nodes)
    try:
        R.get(R.remote(boom).remote(), timeout=60)
        out["error"] = "none"
    except R.TaskError as e:
        out["error"] = ["TaskError", "kapow" in str(e)]
    R.shutdown()
    _emit(out)


def client_again(pkg, address, token):
    """A second client after the first one disconnected."""
    R, _ = _pkg(pkg)
    R.init(address=address, cluster_token=token.encode())
    out = {"one": R.get(R.remote(one).remote(), timeout=60)}
    R.shutdown()
    _emit(out)


def main_only():
    return "never sent"


def kill9_before(pkg, address, token):
    """Against a head with a state dir: a named actor, a placement group,
    a KV key, a large put; then the head's pid, session and workers."""
    import numpy as np
    R, control = _pkg(pkg)
    R.init(address=address, cluster_token=token.encode())
    c = R.remote(Counter).options(name="survivor", max_restarts=0,
                                  num_cpus=0).remote(100)
    out = {"bump": R.get(c.bump.remote(), timeout=120)}
    pg = R.placement_group([{"CPU": 1}], strategy="PACK")
    out["pg_ready"] = pg.ready(timeout=30)
    out["pg"] = pg.id.hex()
    control("kv_put", "ft-key", b"ft-value")
    big = R.put(np.ones(1 << 20, dtype=np.float32))
    out["big"] = float(R.get(big, timeout=60).sum())
    out["task"] = R.get(R.remote(add).remote(1, 2), timeout=60)
    main_fn = sys.modules["__main__"].main_only
    try:
        R.remote(main_fn).remote()
        out["main_refused"] = False
    except ValueError as e:
        out["main_refused"] = "__main__" in str(e)
    out["info"] = control("session_info")
    _emit(out)
    # Connected (its large put held in the head's shared memory) until the
    # test has killed the head and closes this process's stdin.
    sys.stdin.readline()
    R.shutdown()


def kill9_after(pkg, address, token, pg_hex):
    R, control = _pkg(pkg)
    R.init(address=address, cluster_token=token.encode())
    out = {"kv": control("kv_get", "ft-key").decode()}
    h = _until(lambda: R.get_actor("survivor"))
    out["bump"] = _until(lambda: R.get(h.bump.remote(), timeout=30))
    out["pg_state"] = _until(
        lambda: _created(control("pg_state", bytes.fromhex(pg_hex))), 30)
    out["pid"] = R.get(h.pid.remote(), timeout=30)
    _emit(out)
    R.shutdown()


SCENARIOS = {"restart": restart, "state_first": state_first,
             "state_second": state_second, "client": client,
             "client_again": client_again, "kill9_before": kill9_before,
             "kill9_after": kill9_after}


def main(argv):
    SCENARIOS[argv[1]](*argv[2:])


if __name__ == "__main__":
    # Run through the module's own name, so what it sends pickles as
    # ``_torch_head_fns.<name>`` (``main_only`` stays ``__main__``'s).
    import _torch_head_fns
    _torch_head_fns.main(sys.argv)

"""The cases of JAX's ``tests/test_cluster.py``, run the same way through the
JAX package and the port, each package in a fresh interpreter with one
cluster of its own (a head with no CPUs and three 2-CPU nodes, as JAX's
module fixture boots it):

    RTT_PKG=<jax|port> python -m _torch_cluster_fns <tmpdir> [case ...]
    RTT_PKG=<jax|port> python -m _torch_cluster_fns <scenario> <tmpdir>

It prints one line ``RESULT {...}``: each case's outcome (or its error),
which ``tests/test_torch_cluster.py`` compares between the packages.  The
functions and classes the cases send are defined here, at the top level:
a node's workers import them by reference (the port has no
cloudpickle); the scenario's ``PYTHONPATH`` carries this directory to the
nodes.  Nothing here imports torch or JAX at import time.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback


def _pkg():
    if os.environ.get("RTT_PKG") == "jax":
        import ray_tpu
        return ray_tpu
    import ray_tpu_torch
    return ray_tpu_torch


# -- what the cases run on the nodes ---------------------------------------------------


def who():
    time.sleep(0.2)
    return os.getpid()


def make(n):
    import numpy as np
    return np.arange(n, dtype=np.float64)


def consume(a):
    return float(a.sum())


def make_ones():
    import numpy as np
    return np.ones(150_000)


def fetch(refs):
    # A nested get inside a worker (wrapping the ref in a list keeps it
    # from being resolved as a task dependency).
    return float(_pkg().get(refs[0]).sum())


def inner(x):
    return x + 1


def outer(x):
    R = _pkg()
    return R.get(R.remote(num_cpus=1)(inner).remote(x)) * 10


class Counter:
    def __init__(self):
        self.log = []

    def add(self, x):
        self.log.append(x)
        return list(self.log)


def run_pid():
    return os.getpid()


def remote_stack_probe(flag, marker):
    open(marker, "w").close()
    while not os.path.exists(flag):
        time.sleep(0.05)
    return "ok"


def wedge_probe(flag, pid_file):
    with open(pid_file, "w") as f:
        f.write(str(os.getpid()))
    while not os.path.exists(flag):
        time.sleep(0.05)
    return "ok"


def use_gadget():
    return "ok"


class Bumper:
    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1
        return self.n


def produce():
    import numpy as np
    return np.arange(250_000, dtype=np.float64)


# -- access to each package's tables ----------------------------------------------------


class _Port:
    def __init__(self, c):
        self.c = c

    def pg_info(self, pg):
        from ray_tpu_torch._ids import PlacementGroupID
        return self.c.controller.get_placement_group(
            PlacementGroupID(pg.id.binary()))

    def actor_node(self, a):
        from ray_tpu_torch._ids import ActorID
        return self.c.controller.get_actor(
            ActorID.from_hex(a._actor_id)).node_id

    def drop_head_copy(self, ref):
        self.c.runtime.drop_cached(ref._fut.result())

    def head_node_id(self):
        return self.c.session.node.node_id.hex()

    def pulled(self):
        from ray_tpu_torch import _cluster
        return _cluster.transfer_stats()["pull_bytes"]

    def nbytes(self, ref):
        from ray_tpu_torch import _tasks
        return _tasks.desc_nbytes(ref._fut.result())


class _Jax:
    def __init__(self, c):
        self.c = c

    def pg_info(self, pg):
        from ray_tpu._private.ids import PlacementGroupID
        return self.c.runtime.controller.get_placement_group(
            PlacementGroupID(pg.id.binary()))

    def actor_node(self, a):
        return self.c.runtime._actors[a._actor_id].node_id

    def drop_head_copy(self, ref):
        self.c.runtime.node.store.delete(ref.id())

    def head_node_id(self):
        return self.c.runtime.node_id.hex()


# -- the cases (JAX's tests/test_cluster.py:34-320, in its order) ----------------------


def case_join_and_resources(R, c, t, tmp):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if R.cluster_resources().get("CPU", 0) == 6.0:
            break
        time.sleep(0.1)
    return [c.alive_node_count(), R.cluster_resources().get("CPU", 0)]


def case_remote_dispatch_and_spread(R, c, t, tmp):
    f = R.remote(num_cpus=1, scheduling_strategy="SPREAD")(who)
    pids = set(R.get([f.remote() for _ in range(6)]))
    # Six concurrent 1-CPU tasks cannot fit on one 2-CPU node.
    return len(pids) >= 3


def case_cross_node_object_transfer(R, c, t, tmp):
    mk = R.remote(num_cpus=1)(make)
    co = R.remote(num_cpus=1)(consume)
    ref = mk.remote(200_000)
    before = t.pulled() if hasattr(t, "pulled") else None
    arr = R.get(ref)
    out = {"last": float(arr[-1]),
           "sum": R.get(co.remote(ref)) == float(arr.sum())}
    if before is not None:
        # The port only: the driver's read came over the data plane.
        out["pulled_equals_payload"] = t.pulled() - before == t.nbytes(ref)
    return out


def case_syncer_node_views(R, c, t, tmp):
    rt = c.runtime
    deadline = time.time() + 15
    views = {}
    while time.time() < deadline:
        views = rt.ctl_node_views()
        remote = {k: v for k, v in views.items() if v["_version"] >= 1}
        if len(remote) >= 3:
            break
        time.sleep(0.2)
    remote = {k: v for k, v in views.items() if v["_version"] >= 1}
    ok = len(remote) >= 3 and all(
        "workers" in v and "running_tasks" in v
        and v["memory_total_bytes"] > 0 for v in remote.values())
    nid = next(iter(rt._node_views))
    cur = rt._node_views[nid][0]
    rt.on_node_view(nid, cur - 1, {"stale": True})
    return [ok, "stale" not in rt._node_views[nid][1]]


def case_worker_nested_get_of_remote_object(R, c, t, tmp):
    ref = R.remote(num_cpus=1)(make_ones).remote()
    return R.get(R.remote(num_cpus=1)(fetch).remote([ref]))


def case_worker_nested_submit(R, c, t, tmp):
    return R.get(R.remote(num_cpus=1)(outer).remote(4))


def case_actor_on_remote_node_ordering(R, c, t, tmp):
    a = R.remote(num_cpus=1)(Counter).remote()
    out = R.get([a.add.remote(i) for i in range(20)])
    R.kill(a)
    return out[-1]


def case_strict_spread_pg(R, c, t, tmp):
    pg = R.placement_group([{"CPU": 1}, {"CPU": 1}, {"CPU": 1}],
                           strategy="STRICT_SPREAD")
    ready = pg.ready(timeout=20)
    nids = [b.node_id for b in t.pg_info(pg).bundles]
    f = R.remote(num_cpus=1)(run_pid)
    pids = R.get([f.options(placement_group=pg,
                            placement_group_bundle_index=i).remote()
                  for i in range(3)])
    R.remove_placement_group(pg)
    return [ready, len(set(nids)), all(n is not None for n in nids),
            len(set(pids))]


def case_strict_pack_pg(R, c, t, tmp):
    pg = R.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
    ready = pg.ready(timeout=20)
    nids = {b.node_id for b in t.pg_info(pg).bundles}
    R.remove_placement_group(pg)
    return [ready, len(nids)]


def case_remote_workers_answer_stack_dump(R, c, t, tmp):
    flag, marker = os.path.join(tmp, "release"), os.path.join(tmp,
                                                              "started")
    ref = R.remote(num_cpus=1)(remote_stack_probe).remote(flag, marker)
    deadline = time.monotonic() + 30
    while not os.path.exists(marker):
        assert time.monotonic() < deadline, "probe never started"
        time.sleep(0.05)
    try:
        dump = c.runtime.ctl_stack_dump(timeout_s=10.0)
        head = t.head_node_id()
        probed = [r for r in dump["stacks"]
                  if any(any("remote_stack_probe" in f for f in th["frames"])
                         for th in r["threads"])]
        out = [bool(probed), all(not r.get("is_driver") for r in probed),
               any(r.get("node_id") and r["node_id"] != head
                   for r in probed)]
    finally:
        open(flag, "w").close()
    return out + [R.get(ref, timeout=60)]


def case_wedged_remote_worker_reported_unresponsive(R, c, t, tmp):
    import signal
    flag, pid_file = os.path.join(tmp, "wedge_release"), os.path.join(
        tmp, "wedge_pid")
    ref = R.remote(num_cpus=1)(wedge_probe).remote(flag, pid_file)
    deadline = time.monotonic() + 30
    while not (os.path.exists(pid_file) and open(pid_file).read().strip()):
        assert time.monotonic() < deadline, "probe never started"
        time.sleep(0.05)
    pid = int(open(pid_file).read())
    os.kill(pid, signal.SIGSTOP)
    try:
        dump = c.runtime.ctl_stack_dump(timeout_s=3.0)
        out = [bool(dump["unresponsive"]), not any(
            any(any("wedge_probe" in f for f in th["frames"])
                for th in r["threads"]) for r in dump["stacks"])]
    finally:
        try:
            os.kill(pid, signal.SIGCONT)
        except ProcessLookupError:
            pass
    open(flag, "w").close()
    return out + [R.get(ref, timeout=60)]


def case_task_infeasible_until_node_joins(R, c, t, tmp):
    ref = R.remote(resources={"gadget": 1})(use_gadget).remote()
    _ready, pending = R.wait([ref], timeout=1.0)
    handle = c.add_node(num_cpus=1, resources={"gadget": 1})
    out = [bool(pending), R.get(ref, timeout=30)]
    c.remove_node(handle)
    return out


def case_actor_restarts_on_surviving_node(R, c, t, tmp):
    handle = c.add_node(num_cpus=1, resources={"doom": 1})
    a = R.remote(num_cpus=1, resources={"doom": 0.001},
                 max_restarts=1)(Bumper).remote()
    first = R.get(a.bump.remote())
    victim = t.actor_node(a)
    c.remove_node(handle)
    handle2 = c.add_node(num_cpus=1, resources={"doom": 1})
    deadline = time.monotonic() + 30
    val = None
    while time.monotonic() < deadline:
        try:
            val = R.get(a.bump.remote(), timeout=10)
            break
        except Exception:  # noqa: BLE001 - still restarting
            time.sleep(0.2)
    moved = t.actor_node(a) != victim
    R.kill(a)
    c.remove_node(handle2)
    return [first, val, moved]


def case_object_reconstructed_after_node_death(R, c, t, tmp):
    handle = c.add_node(num_cpus=1, resources={"vault": 1})
    ref = R.remote(num_cpus=1, resources={"vault": 0.001})(produce).remote()
    first = float(R.get(ref, timeout=30)[-1])
    # The only copy lives on the doomed node once the head's is dropped.
    t.drop_head_copy(ref)
    c.remove_node(handle)
    handle2 = c.add_node(num_cpus=1, resources={"vault": 1})
    arr = R.get(ref, timeout=60)
    c.remove_node(handle2)
    return [first, float(arr[-1])]


def case_pg_bundle_rescheduled_after_node_death(R, c, t, tmp):
    handle = c.add_node(num_cpus=2, resources={"mark": 1})
    pg = R.placement_group([{"CPU": 1, "mark": 0.001}, {"CPU": 1}],
                           strategy="SPREAD")
    ready = pg.ready(timeout=20)
    info = t.pg_info(pg)
    marked = [b for b in info.bundles if "mark" in b.resources.to_dict()]
    dead = marked[0].node_id
    c.remove_node(handle)
    handle2 = c.add_node(num_cpus=2, resources={"mark": 1})
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        info = t.pg_info(pg)
        b = info.bundles[marked[0].index]
        if info.state == "CREATED" and b.node_id is not None \
                and b.node_id != dead:
            break
        time.sleep(0.1)
    out = [ready, info.state,
           info.bundles[marked[0].index].node_id != dead]
    R.remove_placement_group(pg)
    c.remove_node(handle2)
    return out


CASES = [case_join_and_resources, case_remote_dispatch_and_spread,
         case_cross_node_object_transfer, case_syncer_node_views,
         case_worker_nested_get_of_remote_object, case_worker_nested_submit,
         case_actor_on_remote_node_ordering, case_strict_spread_pg,
         case_strict_pack_pg, case_remote_workers_answer_stack_dump,
         case_wedged_remote_worker_reported_unresponsive,
         case_task_infeasible_until_node_joins,
         case_actor_restarts_on_surviving_node,
         case_object_reconstructed_after_node_death,
         case_pg_bundle_rescheduled_after_node_death]


# -- the flash forward on a node (the card path's kernel, plain on a CPU) ---------------


def flash_on_node(q, k, v):
    """The port's flash forward in a node's worker: (out, lse, the
    kernel's launches in this worker, the worker's pid)."""
    import importlib

    import torch

    # ``ray_tpu_torch.ops.attention`` is also a function of ``ops``.
    attention = importlib.import_module("ray_tpu_torch.ops.attention")
    out, lse = attention.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   need_lse=True)
    return (out.numpy(), lse.numpy(), attention.flash_fwd.launches,
            os.getpid())


class XCounter:
    """JAX's ``tests/test_direct_calls.py`` counter."""

    def __init__(self):
        self.n = 0

    def ready(self):
        return "up"

    def bump(self, k):
        self.n += k
        return self.n

    def die(self):
        os._exit(1)


def caller(a, n):
    """A node's task calling an actor n times (straight to the actor's
    process, in order)."""
    R = _pkg()
    return R.get([a.bump.remote(1) for _ in range(n)])


def crash_caller(a):
    R = _pkg()
    assert R.get(a.bump.remote(1)) == 1
    try:
        R.get(a.die.remote(), timeout=15)
        return "no-error"
    except Exception as e:  # noqa: BLE001 - the error's name is the answer
        err = type(e).__name__
    deadline = time.time() + 40
    while time.time() < deadline:
        try:
            v = R.get(a.bump.remote(5), timeout=5)
            return f"{err}:{v}"
        except Exception:  # noqa: BLE001 - the actor is restarting
            time.sleep(0.3)
    return err + ":no-recovery"


def nested_put_pass(n):
    """A node's task puts a large array and hands its ref to a nested
    task: the ref's descriptor leaves the node tagged."""
    import numpy as np
    R = _pkg()
    ref = R.put(np.arange(n, dtype=np.float64))
    return R.get(R.remote(num_cpus=1)(consume).remote(ref))


def worker_pid():
    return os.getpid()


def double(i):
    return i * 2


def inc_slow(i):
    time.sleep(0.02)
    return i + 1


def slow_start(s):
    time.sleep(s)
    return s


class SlowInit:
    """An actor whose constructor takes ``s`` seconds."""

    def __init__(self, s):
        time.sleep(s)

    def ready(self):
        return True


class FlashHolder:
    """An actor that runs the flash forward (on a node)."""

    def run(self, q, k, v):
        return flash_on_node(q, k, v)


# -- JAX's tests/test_reconnect.py and test_head_ft.py's node case ----------------------


def work(i):
    time.sleep(0.15)
    return i * 2


class Keeper:
    def __init__(self):
        self.v = 0

    def bump(self):
        self.v += 1
        return self.v


def gated(i, gate):
    """Say this task started (``<gate>/started-<i>``), then run until the
    test writes ``<gate>/release``."""
    start = time.time()
    open(os.path.join(gate, f"started-{i}"), "w").close()
    deadline = time.monotonic() + 240
    while not os.path.exists(os.path.join(gate, "release")):
        assert time.monotonic() < deadline, "never released"
        time.sleep(0.05)
    return (i * 10, os.getpid(), start)


def scenario_reconnect(tmp):
    """JAX's ``test_drop_under_load_no_task_fails``: the head closes a
    node's connection with tasks in flight; the node re-attaches under
    its identity and no task fails or runs twice."""
    jax = os.environ.get("RTT_PKG") == "jax"
    if jax:
        from ray_tpu.cluster_utils import Cluster
    else:
        from ray_tpu_torch.cluster_utils import Cluster
    R = _pkg()
    c = Cluster(head_num_cpus=0)
    try:
        c.add_node(num_cpus=2)
        c.wait_for_nodes(1)
        if jax:
            hs, alive = c.runtime.head_server, c.runtime.controller
        else:
            hs, alive = c.session.head_server, c.controller
        k = R.remote(num_cpus=1)(Keeper).remote()
        first = R.get(k.bump.remote(), timeout=60)
        nids = [n.node_id for n in alive.alive_nodes() if not n.is_head]
        w = R.remote(num_cpus=1)(work)
        refs = [w.remote(i) for i in range(30)]
        time.sleep(0.3)
        hs.proxies[nids[0]].conn.close()
        out = R.get(refs, timeout=120) == [i * 2 for i in range(30)]
        second = R.get(k.bump.remote(), timeout=60)
        after = [n.node_id for n in alive.alive_nodes() if not n.is_head]
        more = R.get(w.remote(100), timeout=60)
        return [first, out, second, after == nids, more]
    finally:
        c.shutdown()


def scenario_head_restart(tmp):
    """JAX's ``test_head_restart_nodes_reattach_tasks_survive``: kill -9
    the head with tasks running on two nodes, restart it on the same port
    from its WAL; the nodes re-attach under their identities and the
    tasks in flight finish on their first workers, not run again."""
    import signal
    import socket
    import subprocess
    jax = os.environ.get("RTT_PKG") == "jax"
    R = _pkg()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    node_port = s.getsockname()[1]
    s.close()
    state_dir = os.path.join(tmp, "state")
    addr_file = os.path.join(tmp, "head_address")
    token = "a" * 32
    env = dict(os.environ, RAY_TPU_NODE_RECONNECT_GRACE_S="60")
    env.pop("RAY_TPU_CONFIG_BLOB", None)
    pkg = "ray_tpu" if jax else "ray_tpu_torch"
    node_main = "ray_tpu._private.node_server_main" if jax else \
        "ray_tpu_torch._node_server_main"

    def start_head():
        try:
            os.unlink(addr_file)
        except FileNotFoundError:
            pass
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.scripts.head",
             "--port", "0" if jax else "-1", "--node-port", str(node_port),
             "--token", token, "--address-file", addr_file,
             "--dashboard-port", "-1", "--state-dir", state_dir,
             "--num-cpus", "0", "--num-tpus", "0"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(f"head died rc={proc.returncode}")
            try:
                with open(addr_file) as f:
                    return proc, json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                time.sleep(0.2)
        raise RuntimeError("head did not boot")

    def start_node():
        return subprocess.Popen(
            [sys.executable, "-m", node_main,
             "--address", f"127.0.0.1:{node_port}", "--token", token,
             "--num-cpus", "2", "--num-tpus", "0"],
            env=dict(env, RAY_TPU_TPU_CHIPS_PER_HOST_OVERRIDE="0"),
            start_new_session=True)

    def ids_of(refs):
        return [r.id() for r in refs] if jax else [r._fut._oid
                                                   for r in refs]

    def refs_of(rt, ids):
        if jax:
            from ray_tpu._private.api import ObjectRef
            return [ObjectRef(oid) for oid in ids]
        return rt._refs(ids, "gated")

    nodes, head = [], None
    try:
        head, info = start_head()
        nodes = [start_node(), start_node()]
        R.init(address=info["node_address"], cluster_token=token.encode())
        deadline = time.monotonic() + 60
        while len(R.nodes()) < 3:
            assert time.monotonic() < deadline, "nodes did not join"
            time.sleep(0.2)
        gate = os.path.join(tmp, "gate")
        os.makedirs(gate)
        f = R.remote(num_cpus=1)(gated)
        refs = [f.remote(i, gate) for i in range(4)]    # fills both nodes
        ids = ids_of(refs)
        deadline = time.monotonic() + 120
        while len(os.listdir(gate)) < 4:            # all four running
            assert time.monotonic() < deadline, "tasks did not start"
            time.sleep(0.05)
        kill_time = time.time()
        os.killpg(head.pid, signal.SIGKILL)
        head.wait(timeout=15)
        R.shutdown()
        del refs
        # The tasks finish while the head is down: the nodes hold their
        # results until they re-attach.
        open(os.path.join(gate, "release"), "w").close()
        head, _info2 = start_head()
        rt2 = R.init(address=_info2["node_address"],
                     cluster_token=token.encode())
        vals = R.get(refs_of(rt2, ids), timeout=90)
        out = [[v[0] for v in vals], all(v[2] < kill_time for v in vals),
               len(R.nodes())]
        R.shutdown()
        return out
    finally:
        for p in nodes:
            if p.poll() is None:
                os.killpg(os.getpgid(p.pid), signal.SIGKILL)
        if head is not None and head.poll() is None:
            os.killpg(head.pid, signal.SIGKILL)


SCENARIOS = {"reconnect": scenario_reconnect,
             "head_restart": scenario_head_restart}


def main(argv) -> int:
    if argv and argv[0] in SCENARIOS:
        try:
            out = {"value": SCENARIOS[argv[0]](argv[1])}
        except Exception as e:  # noqa: BLE001 - reported to the test
            out = {"error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-3000:]}
        print("RESULT " + json.dumps(out), flush=True)
        return 0
    tmp = argv[0]
    names = set(argv[1:])
    jax = os.environ.get("RTT_PKG") == "jax"
    if jax:
        from ray_tpu.cluster_utils import Cluster
    else:
        from ray_tpu_torch.cluster_utils import Cluster
    R = _pkg()
    c = Cluster(head_num_cpus=0)
    for _ in range(3):
        c.add_node(num_cpus=2)
    t = _Jax(c) if jax else _Port(c)
    out = {}
    try:
        for case in CASES:
            name = case.__name__[5:]
            if names and name not in names:
                continue
            t0 = time.monotonic()
            d = os.path.join(tmp, name)
            os.makedirs(d, exist_ok=True)
            try:
                out[name] = {"value": case(R, c, t, d)}
            except Exception as e:  # noqa: BLE001 - reported per case
                out[name] = {"error": f"{type(e).__name__}: {e}",
                             "trace": traceback.format_exc()[-2000:]}
            out[name]["s"] = round(time.monotonic() - t0, 2)
    finally:
        c.shutdown()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # The cases' functions must be this module's by name (a node's
    # workers import them), not ``__main__``'s.
    import _torch_cluster_fns
    sys.exit(_torch_cluster_fns.main(sys.argv[1:]))

"""The port's node plane part by part (``_wire``, ``_events``,
``_log_monitor``, ``_diagnostics``, the node store, descriptor tagging,
``_node``/``_cluster``'s node half, ``_runtime``, ``cluster_utils``),
each held to the JAX package where the API is shared; JAX's
``tests/test_reconnect.py`` and ``test_head_ft.py``'s node case under
both packages (each in a fresh interpreter, ``tests/_torch_cluster_fns``);
and the flash forward run in a node's task and in a node's actor against
JAX's kernel in interpret mode.
"""

from __future__ import annotations

import ast
import glob
import importlib
import json
import math
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = pathlib.Path(HERE).parent
sys.path.insert(0, HERE)

import _torch_cluster_fns as fns  # noqa: E402


def _jax_private(name):
    return importlib.import_module(f"ray_tpu._private.{name}")


def _port(name):
    return importlib.import_module(f"ray_tpu_torch._{name}")


# -- frames, events, logs, descriptors -------------------------------------------------


class _Spec:
    """The fields ``encode_run_task`` reads, as both packages' specs have
    them."""

    def __init__(self, ids):
        self.task_id = ids.TaskID(b"\x01" * _size(ids.TaskID))
        self.name = "f"
        self.fn_id = b"fid"
        self.method_name = None
        self.return_ids = [ids.ObjectID(b"\x02" * _size(ids.ObjectID))]
        self.actor_id = None
        self.streaming = False
        self.max_concurrency = 1
        self.runtime_env = {"env_vars": {"A": "1"}}
        self.trace_ctx = "00-ab-cd-01"


def _size(cls) -> int:
    return len(cls.from_random().binary())


def test_wire_frames_match_jax():
    got = {}
    for pkg, wire, ids in (
            ("jax", _jax_private("wire"), _jax_private("ids")),
            ("port", _port("wire"), _port("ids"))):
        spec = _Spec(ids)
        frame = wire.encode_run_task(spec, [("inline", b"x")], {"k": 1},
                                     b"blob")
        ws, args, kwargs = wire.decode_run_task(frame)
        done = wire.encode_task_done(
            b"t" * _size(ids.TaskID), b"w" * _size(ids.WorkerID),
            [(b"o" * _size(ids.ObjectID), ("inline", b"v"))], None, False,
            None, 0.5)
        td = wire.decode_task_done(done)
        got[pkg] = (frame, ws.task_id.binary(), ws.name, ws.fn_blob,
                    [r.binary() for r in ws.return_ids], ws.runtime_env,
                    ws.trace_ctx, args, kwargs, done,
                    td.task_id.binary(), td.results[0][1],
                    td.execution_time_s, wire.RUN_TASK, wire.TASK_DONE)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_task_event_buffer_transitions(pkg):
    ev = _jax_private("events") if pkg == "jax" else _port("events")
    buf = ev.TaskEventBuffer(max_events=3)
    for tid, states in (("a", [ev.PENDING_ARGS, ev.SUBMITTED_TO_NODE,
                               ev.RUNNING, ev.FINISHED]),
                        ("b", [ev.SUBMITTED_TO_NODE, ev.RUNNING,
                               ev.FAILED]),
                        ("c", [ev.RUNNING]), ("d", [ev.RUNNING])):
        for st in states:
            buf.record(tid, st, name=f"fn_{tid}", node_id="n1")
    snap = buf.snapshot()
    # Bounded: the oldest task went; each record holds its last state.
    assert [r["task_id"] for r in snap] == ["b", "c", "d"]
    assert [r["state"] for r in snap] == [ev.FAILED, ev.RUNNING, ev.RUNNING]
    assert buf.summary() == {"fn_b": {ev.FAILED: 1}, "fn_c": {ev.RUNNING: 1},
                             "fn_d": {ev.RUNNING: 1}}
    assert buf.find_ids("c") == ["c"]
    assert buf.stats()["num_dropped"] == 1


def _log_lines(mod, tmp_path):
    d = tmp_path / mod.__name__.replace(".", "_")
    d.mkdir()
    (d / "worker-0123abcd.out").write_text("hello\nworld\npartial")
    (d / "worker-0123abcd.err").write_text("oops\n")
    (d / "ignored.txt").write_text("x\n")
    seen = []
    mon = mod.LogMonitor(str(d), emit=lambda f, line: seen.append((f, line)))
    n = mon.poll_once()
    with open(d / "worker-0123abcd.out", "a") as f:
        f.write(" done\n")
    n += mon.poll_once()
    return n, seen, mon.tail("worker-0123abcd.out", 2)


def test_log_monitor_prefixes_match_jax(tmp_path, capsys):
    jax_mod, port_mod = _jax_private("log_monitor"), _port("log_monitor")
    assert _log_lines(port_mod, tmp_path) == _log_lines(jax_mod, tmp_path)
    for mod in (jax_mod, port_mod):
        mod.LogMonitor._default_emit("worker-0123abcd.err", "boom")
        mod.LogMonitor._default_emit("worker-0123abcd.out", "fine")
    out, err = capsys.readouterr()
    assert err == "(worker-0123abcd) boom\n" * 2
    assert out == "(worker-0123abcd) fine\n" * 2


def test_descriptor_tags_match_jax():
    j, t = _jax_private("cluster"), _port("cluster")
    nid, other = b"\x07" * 16, b"\x08" * 16
    shm = ("shm", "rt_" + "ab" * 22, 4096)
    for desc in (shm, ("inline", b"abc")):
        assert t.tag_desc(desc, nid) == j.tag_desc(desc, nid)
        tagged = j.tag_desc(desc, nid)
        for local in (nid, other):
            assert t.untag_desc(tagged, local) == j.untag_desc(tagged, local)
    assert t.desc_key(shm) == j.desc_key(shm)
    # The port's inline payloads carry inner descriptors: exported, they
    # are tagged too, and imported back on their node, untagged.
    import pickle
    inline = ("inline", pickle.dumps(([shm], b"meta", []), protocol=5))
    out = t.export_desc(inline, nid)
    assert pickle.loads(out[1])[0] == [("at", nid, shm)]
    assert t.import_desc(out, nid) == inline
    assert t.import_desc(out, other) == out


def test_diagnostics_stack_records_match_jax():
    recs = [mod.capture_process_stacks("w1", thread_tasks={})
            for mod in (_jax_private("diagnostics"), _port("diagnostics"))]
    assert set(recs[0]) == set(recs[1])
    assert {frozenset(th) for th in recs[0]["threads"]} == \
        {frozenset(th) for th in recs[1]["threads"]}
    assert any("test_diagnostics_stack_records_match_jax" in f
               for th in recs[1]["threads"] for f in th["frames"])


# -- the node's store -------------------------------------------------------------------


def test_node_store_evicts_spills_and_restores(tmp_path):
    from ray_tpu_torch._object_store import (RemoteObjectReader,
                                             SharedMemoryStore, _read)
    spill = tmp_path / "spill"
    store = SharedMemoryStore(3 << 20, spill_dir=str(spill))
    names = []
    try:
        for i in range(5):
            name, n = RemoteObjectReader.write(
                f"rtt_nodetest{os.getpid()}_{i}",
                np.full(200_000, i, np.float32))
            store.adopt_segment(name, n)
            names.append(name)
        st = store.stats()
        assert st["num_objects"] == 5 and st["num_spilled"] == 2
        assert st["used_bytes"] <= st["capacity_bytes"]
        # The two oldest went to disk and out of shared memory.
        assert not os.path.exists(f"/dev/shm/{names[0]}")
        assert len(os.listdir(spill / str(os.getpid()))) == 2
        for i, name in enumerate(names):
            value = _read(memoryview(store.read_raw(name)))
            assert value[0] == i and value.shape == (200_000,)
        assert store.stats()["restored_total"] >= 2
        store.delete(names[-1])
        assert not os.path.exists(f"/dev/shm/{names[-1]}")
    finally:
        store.shutdown()
    assert not any(os.path.exists(f"/dev/shm/{n}") for n in names)
    assert not (spill / str(os.getpid())).exists()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_sweep_orphan_spills(pkg, tmp_path):
    mod = _jax_private("object_store") if pkg == "jax" else \
        _port("object_store")
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    for pid in (dead.pid, os.getpid()):
        d = tmp_path / str(pid)
        d.mkdir()
        (d / "obj").write_bytes(b"x" * 100)
    assert mod.sweep_orphan_spills(str(tmp_path)) == 100
    assert sorted(os.listdir(tmp_path)) == [str(os.getpid())]


def test_native_arena_store_waits_for_item_14():
    from ray_tpu_torch._object_store import NativeArenaStore
    with pytest.raises(NotImplementedError, match="item 14"):
        NativeArenaStore(1 << 20)


def test_card_pool_grants_and_refuses():
    from ray_tpu_torch._protocol import TaskSpec
    from ray_tpu_torch._resources import ResourceSet
    from ray_tpu_torch._scheduler import CardPool
    from ray_tpu_torch._ids import TaskID

    def spec(n):
        return TaskSpec(TaskID.from_random(), "t", None, None, [], {}, [],
                        ResourceSet({"GPU": n}))
    pool = CardPool(2)
    assert pool.take(spec(1)) == [0]
    assert pool.take(spec(0.5)) == []
    # No quiet fallback: a card booked but not free is a fault.
    with pytest.raises(RuntimeError, match="booked but only"):
        pool.take(spec(2))
    pool.give_back([0])
    assert pool.take(spec(2)) == [0, 1]


# -- a cluster in this process ------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    """A head with no CPUs and one 2-CPU node, torch on one thread."""
    from ray_tpu_torch.cluster_utils import Cluster
    c = Cluster(head_num_cpus=0)
    c.add_node(num_cpus=2, env={"OMP_NUM_THREADS": "1",
                                "PYTHONPATH": os.pathsep.join(
                                    [HERE, str(REPO)])})
    yield c
    sid = c.session.id
    pids = c.node_pids()
    session_dir = c.runtime.session_dir
    c.shutdown()
    assert not os.path.exists(session_dir)
    # No node process, worker or segment of the session is left.
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not [p for p in pids if _alive(p)]
    assert not glob.glob(f"/dev/shm/rtt_{sid}_*")


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _qkv():
    rng = np.random.default_rng(18)
    q = rng.standard_normal((1, 4, 64, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 64, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 64, 32)).astype(np.float32)
    return q, k, v


def test_flash_forward_in_a_node_task_and_actor_matches_jax(cluster):
    """The card path's kernel entry point (plain on a CPU tensor) in a
    node's worker and in an actor placed on the node, against JAX's
    flash kernel in interpret mode: fp32, within 1e-4."""
    import ray_tpu_torch as R
    q, k, v = _qkv()
    task = R.remote(num_cpus=1)(fns.flash_on_node)
    actor = R.remote(num_cpus=1, env_vars={"OMP_NUM_THREADS": "1"})(
        fns.FlashHolder).remote()
    (t_out, t_lse, _n, t_pid), (a_out, a_lse, _m, a_pid) = R.get(
        [task.remote(q, k, v), actor.run.remote(q, k, v)], timeout=120)
    import jax.numpy as jnp
    j_attn = importlib.import_module("ray_tpu.ops.attention")
    j_out, j_lse = j_attn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
        1.0 / math.sqrt(32), 32, 32, 0, True, need_lse=True)
    for out, lse in ((t_out, t_lse), (a_out, a_lse)):
        np.testing.assert_allclose(out, np.asarray(j_out), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(lse, np.asarray(j_lse), atol=1e-4,
                                   rtol=1e-4)
    # Both ran in the node's process group (its workers and actors), not
    # in this process.
    groups = {os.getpgid(p) for p in cluster.node_pids()}
    assert os.getpgid(t_pid) in groups and os.getpgid(a_pid) in groups
    assert os.getpid() not in (t_pid, a_pid)
    R.kill(actor)


def test_debug_bundle_carries_the_nodes_stacks(cluster):
    """``write_debug_bundle`` on the head: the stacks of every node's
    workers (the driver's first), the task events of tasks run on the
    node, the scheduler's decisions and a manifest."""
    import ray_tpu_torch as R
    assert R.get(R.remote(num_cpus=1)(fns.double).remote(3)) == 6
    path = cluster.runtime.write_debug_bundle("test", stack_timeout_s=5.0)
    files = set(os.listdir(path))
    assert {"stacks.json", "task_events.json", "sched_decisions.json",
            "manifest.json"} <= files, files
    stacks = json.load(open(os.path.join(path, "stacks.json")))
    assert stacks["stacks"][0]["is_driver"] and len(stacks["stacks"]) >= 2
    events = json.load(open(os.path.join(path, "task_events.json")))
    assert any(e["name"] == "double" and e["state"] == "FINISHED"
               for e in events), events[-3:]


def test_pings_answered_during_slow_worker_starts(cluster):
    """The node's reader never waits on a dispatch: while it starts four
    workers and an actor whose constructor takes seconds, a ping from the
    head comes back at once."""
    import ray_tpu_torch as R
    rt = cluster.runtime
    (nid,) = [n.node_id for n in cluster.controller.alive_nodes()
              if not n.is_head]
    slow = R.remote(num_cpus=0.5)(fns.slow_start)
    refs = [slow.remote(2.0) for _ in range(4)]
    a = R.remote(num_cpus=0)(fns.SlowInit).remote(3.0)
    worst = max(rt.ping_node(nid, timeout=5.0) for _ in range(10))
    assert worst < 1.0, worst
    assert sorted(R.get(refs, timeout=120)) == [2.0] * 4
    assert R.get(a.ready.remote(), timeout=120) is True
    R.kill(a)


def test_views_counters_and_bytes_pulled(cluster):
    """A node's view carries its data-plane counters; a 1 MB result is
    pulled once by the driver (then read from the head's copy) and its
    pushed bytes equal what was pulled."""
    import ray_tpu_torch as R
    from ray_tpu_torch import _cluster
    ref = R.remote(num_cpus=1)(fns.make).remote(131_072)
    before = _cluster.transfer_stats()["pull_bytes"]
    a = R.get(ref)
    b = R.get(ref)
    assert a[-1] == b[-1] == 131_071.0
    from ray_tpu_torch import _tasks
    nbytes = _tasks.desc_nbytes(ref._fut.result())
    assert _cluster.transfer_stats()["pull_bytes"] - before == nbytes
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        views = {k: v for k, v in cluster.runtime.ctl_node_views().items()
                 if v["_version"] >= 1}
        pushed = [v["transfer"]["push_bytes"] for v in views.values()]
        if pushed and max(pushed) >= nbytes:
            break
        time.sleep(0.2)
    assert max(pushed) >= nbytes


def test_worker_calls_an_actor_directly_in_order(cluster):
    """JAX's ``test_worker_to_worker_across_nodes``: a node's task calls an
    actor of the head 50 times; the calls ride the task's own connection
    to the actor's process (``_actor``'s channel), in submission order."""
    import ray_tpu_torch as R
    a = R.remote(fns.XCounter).remote()
    assert R.get(a.ready.remote(), timeout=120) == "up"
    vals = R.get(R.remote(num_cpus=1)(fns.caller).remote(a, 50), timeout=120)
    assert vals == list(range(1, 51))
    R.kill(a)


def test_worker_channel_survives_actor_restart(cluster):
    """JAX's ``test_worker_channel_survives_actor_restart_across_nodes``:
    the call in flight fails with ``ActorError``, the caller's channel
    reaches the restarted incarnation, whose state starts from 0."""
    import ray_tpu_torch as R
    a = R.remote(fns.XCounter).options(max_restarts=1).remote()
    assert R.get(a.ready.remote(), timeout=120) == "up"
    assert R.get(R.remote(num_cpus=1)(fns.crash_caller).remote(a),
                 timeout=180) == "ActorError:5"
    R.kill(a)


def test_nested_put_passed_to_a_nested_task(cluster):
    """A node's worker puts 1.6 MB and passes the ref to a task of its
    own: the segment is the node's, and its descriptor crosses tagged."""
    import ray_tpu_torch as R
    n = 200_000
    assert R.get(R.remote(num_cpus=1)(fns.nested_put_pass).remote(n),
                 timeout=120) == float(np.arange(n).sum())


def test_workers_exit_with_their_node(cluster):
    """A node killed alone (SIGKILL to its process, not its group):
    its workers see their socket's end and exit; the head declares the
    node dead and the cluster goes on without it."""
    import ray_tpu_torch as R
    h = cluster.add_node(num_cpus=1, resources={"lone": 1},
                         env={"PYTHONPATH": os.pathsep.join(
                             [HERE, str(REPO)])})
    pid = R.get(R.remote(num_cpus=1, resources={"lone": 0.5})(
        fns.worker_pid).remote(), timeout=120)
    assert os.getpgid(pid) == os.getpgid(h.proc.pid)
    os.kill(h.proc.pid, signal.SIGKILL)
    h.proc.wait(timeout=10)
    deadline = time.monotonic() + 15
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _alive(pid)
    cluster.remove_node(h)
    assert h.node_id not in {n["node_id"] for n in R.nodes() if n["alive"]}


def test_remote_pipelining_with_credits(cluster):
    """JAX's ``test_remote_pipelining_with_credits``: a burst bigger than
    the node queues ahead on its busy workers; every credit comes back."""
    import ray_tpu_torch as R
    rt = cluster.runtime
    before = rt.counts["pipelined"]
    f = R.remote(fns.double)
    assert R.get([f.remote(i) for i in range(40)], timeout=120) == \
        [i * 2 for i in range(40)]
    assert rt.counts["pipelined"] > before
    assert sum(rt.credits().values()) == 0


def test_pipeline_reject_resubmits(cluster, monkeypatch):
    """JAX's ``test_pipeline_reject_resubmits``: credits far above the
    node's queue room make it refuse the overflow, which the head runs
    through booked scheduling without loss."""
    import ray_tpu_torch as R
    rt = cluster.runtime
    monkeypatch.setattr(type(rt), "_pipeline_cap", lambda self, p: 64)
    before = rt.counts["pipeline_rejects"]
    g = R.remote(fns.inc_slow)
    assert R.get([g.remote(i) for i in range(60)], timeout=120) == \
        [i + 1 for i in range(60)]
    assert rt.counts["pipeline_rejects"] > before
    assert sum(rt.credits().values()) == 0


# -- JAX's reconnect and head-restart cases, both packages ---------------------------------


def _run_both(scenario, tmp_path, extra_env=None):
    procs = {}
    for pkg in ("jax", "port"):
        env = dict(os.environ, RTT_PKG=pkg, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([HERE, str(REPO)]),
                   **(extra_env or {}))
        env.pop("RAY_TPU_CONFIG_BLOB", None)
        d = tmp_path / pkg
        d.mkdir()
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-m", "_torch_cluster_fns", scenario, str(d)],
            env=env, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
    out = {}
    for pkg, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            stdout, stderr = proc.communicate()
        line = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
        assert line, f"{pkg}: no result\n{stdout[-2000:]}\n{stderr[-4000:]}"
        rec = json.loads(line[0][7:])
        assert "error" not in rec, f"{pkg}: {rec['error']}\n{rec['trace']}"
        out[pkg] = rec["value"]
    return out


def test_reconnect_drop_under_load_no_task_fails(tmp_path):
    """JAX's ``test_drop_under_load_no_task_fails``: same node identity,
    every task done once, the actor's state kept."""
    out = _run_both("reconnect", tmp_path,
                    {"RAY_TPU_NODE_RECONNECT_GRACE_S": "5"})
    assert out["jax"] == [1, True, 2, True, 200]
    assert out["port"] == out["jax"]


def test_head_restart_nodes_reattach_tasks_survive(tmp_path):
    """JAX's ``test_head_restart_nodes_reattach_tasks_survive``: the
    tasks in flight finish on their first workers (started before the
    kill) and both nodes re-attach."""
    out = _run_both("head_restart", tmp_path)
    assert out["jax"] == [[0, 10, 20, 30], True, 3]
    assert out["port"] == out["jax"]


# -- process-level checks ------------------------------------------------------------------


def _from_main():
    return 1


# As if defined in the driver's main script, which a node's workers
# cannot import.
_from_main.__module__ = "__main__"


def test_a_main_function_is_refused_on_a_node(cluster):
    import ray_tpu_torch as R
    with pytest.raises(ValueError, match="__main__"):
        R.get(R.remote(num_cpus=1)(_from_main).remote(), timeout=60)


def test_no_secret_crosses_the_wire(cluster, monkeypatch):
    """The head's answer to a joining node and what it sends a node to
    start an actor carry neither the cluster token nor this process's
    key: the node holds the token it dialled with.  The actor started so
    answers this process's call all the same."""
    import multiprocessing as mp
    import pickle

    import ray_tpu_torch as R
    from ray_tpu_torch._ids import NodeID
    hs = cluster.session.head_server
    secrets = {bytes(hs.token), bytes(mp.current_process().authkey)}
    ack = hs._ack(NodeID.from_random())
    assert not [x for x in secrets if x in pickle.dumps(ack)]
    sent = []
    for proxy in [p for p in hs.proxies.values() if p.alive]:
        def send(msg, real=proxy.send):
            sent.append(pickle.dumps(msg))
            real(msg)

        monkeypatch.setattr(proxy, "send", send)
    a = R.remote(fns.XCounter).options(num_cpus=1).remote()
    assert R.get(a.ready.remote(), timeout=120) == "up"
    monkeypatch.undo()
    assert any(b"StartActor" in b for b in sent)
    assert not [x for b in sent for x in secrets if x in b]
    R.kill(a)


def test_a_node_of_another_host_is_refused(cluster):
    """The head takes nodes of its own host only (actors listen on the
    loopback): one naming another host is answered with a refusal."""
    from multiprocessing.connection import Client

    from ray_tpu_torch._cluster import RegisterAck, RegisterNode
    hs = cluster.session.head_server
    before = set(hs.proxies)
    conn = Client(hs.address, "AF_INET", authkey=hs.token)
    try:
        conn.send(RegisterNode("not-" + socket.gethostname(), {"CPU": 1.0},
                               0, ("", 0)))
        ack = conn.recv()
    finally:
        conn.close()
    assert not isinstance(ack, RegisterAck)
    assert "item 13 part 3" in ack
    assert set(hs.proxies) == before


def test_node_with_a_wrong_token_fails_its_start(cluster):
    host, port = cluster.address
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch._node_server_main",
         "--address", f"{host}:{port}", "--token", "not-the-token",
         "--num-cpus", "1"], capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode != 0
    assert "AuthenticationError" in proc.stderr


NEW_MODULES = ["_wire.py", "_events.py", "_log_monitor.py", "_diagnostics.py",
               "_node.py", "_worker_main.py", "_worker.py", "_runtime.py",
               "_node_server_main.py", "cluster_utils.py",
               "_cluster.py", "_object_store.py", "_scheduler.py"]


def test_node_plane_modules_import_no_jax_and_nothing_of_ray_tpu():
    """The modules this slice added (and the ones it grew) exist, and
    import nothing of JAX or of the JAX package (the repo-wide walk in
    ``test_torch_ops`` covers them too)."""
    for name in NEW_MODULES:
        path = REPO / "ray_tpu_torch" / name
        assert path.exists(), name
        roots = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add((node.module or "").split(".")[0])
        bad = roots & {"jax", "jaxlib", "ray_tpu", "cloudpickle"}
        assert not bad, f"{name} imports {bad}"
    import ray_tpu_torch._cluster as c
    for stub in ("RemoteNodeProxy", "DataServer", "DataClient",
                 "ObjectPuller", "NodeServer"):
        assert hasattr(getattr(c, stub), "__init__")
    assert not hasattr(c, "_part_2")

"""The head in the port (``_controller``, ``_persist``, ``_serialization``,
``_cluster``, ``_client``, ``scripts.head``) against the JAX package.

- ``StateStore``: the round trip, compact and torn-tail cases of
  ``tests/test_head_ft.py`` on both stores, and one record stream written
  by either package's store read back equal through the other's.
- ``Controller``: one scripted sequence (jobs, named actors in two
  namespaces, restarts through RESTARTING to DEAD, placement groups, KV
  with a ``kv_wait`` woken by a put, pub/sub) leaves equal tables in both
  packages, as plain dicts, and again after ``snapshot_records`` ->
  ``restore``.
- ``_serialization``: the frames are byte for byte JAX's, and each
  package reads the other's.
- Scenarios in fresh interpreters (``tests/_torch_head_fns.py``), each
  package's output equal to the other's: ``max_restarts``,
  ``init(state_dir=)`` across a SIGKILL, a head (``scripts.head``) and
  its clients (``init(head_port=)``/``init(address=)``).
- The port's head killed with SIGKILL and started again on its state
  dir: the KV value, the named actor (a new pid, fresh state) and the
  placement group come back; no worker of the old head lives on and none
  of its segments is left; a ``__main__`` function is refused.
- A head session in this process shuts down with no thread left (the
  leak sanitizer is on for the suite).

No test depends on elapsed time: waits are deadlines.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOKEN = "a" * 32
TIMEOUT = 240


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               RAY_TPU_TPU_CHIPS_PER_HOST_OVERRIDE="0",
               PYTHONPATH=os.pathsep.join([HERE, REPO]))
    env.pop("RAY_TPU_CONFIG_BLOB", None)
    return env


def _start(args, stdin=None):
    return subprocess.Popen([sys.executable, "-m", "_torch_head_fns"]
                            + [str(a) for a in args], env=_env(), cwd=HERE,
                            stdin=stdin, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc, allow_kill=False):
    out, err = proc.communicate(timeout=TIMEOUT)
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert lines, f"rc={proc.returncode}\nstdout={out}\nstderr={err[-4000:]}"
    if not allow_kill:
        assert proc.returncode == 0, err[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


def _both(*args):
    """The scenario through both packages at once: (jax, port)."""
    procs = [_start([args[0], pkg] + list(args[1:]))
             for pkg in ("jax", "port")]
    return [_result(p) for p in procs]


# -- StateStore ---------------------------------------------------------------


def _store(pkg):
    if pkg == "jax":
        from ray_tpu._private.persist import StateStore
    else:
        from ray_tpu_torch._persist import StateStore
    return StateStore


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_wal_round_trip_compact_and_torn_tail(tmp_path, pkg):
    StateStore = _store(pkg)
    d = str(tmp_path / "s")
    st = StateStore(d)
    st.append(("kv_put", "default", "a", b"1"))
    st.append(("kv_put", "default", "b", b"2"))
    st.append(("kv_del", "default", "a"))
    st.close()
    st2 = StateStore(d)
    assert st2.load() == [("kv_put", "default", "a", b"1"),
                          ("kv_put", "default", "b", b"2"),
                          ("kv_del", "default", "a")]
    st2.compact([("kv_put", "default", "b", b"2")])
    st2.append(("kv_put", "default", "c", b"3"))
    st2.close()
    st3 = StateStore(d)
    assert st3.load() == [("kv_put", "default", "b", b"2"),
                          ("kv_put", "default", "c", b"3")]
    st3.close()
    t = str(tmp_path / "torn")
    st = StateStore(t)
    st.append(("kv_put", "default", "a", b"1"))
    st.close()
    with open(os.path.join(t, "wal.bin"), "ab") as f:
        f.write(b"\xff\xff\x00\x00partial")
    assert StateStore(t).load() == [("kv_put", "default", "a", b"1")]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_wal_reads_across_packages(tmp_path, writer, reader):
    records = [("kv_put", "ns", "k", b"v" * 300), ("job", 3, None),
               ("kv_del", "ns", "k"), ("pg", {"bundles": [1.0, 2.0]})]
    st = _store(writer)(str(tmp_path))
    for r in records[:2]:
        st.append(r)
    st.compact(records[:2])
    for r in records[2:]:
        st.append(r)
    st.close()
    assert _store(reader)(str(tmp_path)).load() == records


# -- Controller -----------------------------------------------------------------


def _mods(pkg):
    if pkg == "jax":
        from ray_tpu._private import controller, ids, protocol, resources
        return controller, ids, protocol, resources.ResourceSet
    from ray_tpu_torch import _controller, _ids, _protocol, _resources
    return _controller, _ids, _protocol, _resources.ResourceSet


_VOLATILE = {"start_time", "end_time", "last_heartbeat"}


def _plain(x):
    """Tables as plain data: dataclasses as dicts (clock fields dropped),
    ids as hex, resource sets as dicts."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.name not in _VOLATILE}
    if hasattr(x, "binary") and hasattr(x, "hex"):
        return x.hex()
    if hasattr(x, "to_dict"):
        return x.to_dict()
    if isinstance(x, dict):
        return {_key(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _key(k):
    return json.dumps(_plain(k)) if isinstance(k, tuple) else _plain(k)


def _tables(c):
    return _plain({"nodes": c.nodes, "actors": c.actors,
                   "named": c.named_actors, "pgs": c.placement_groups,
                   "jobs": c.jobs, "kv": c._kv,
                   "revivable": c.revivable_nodes})


def _script(pkg, store_dir):
    """One sequence of mutations; returns (controller, what it observed)."""
    C, ids, proto, RS = _mods(pkg)
    _, persist_mod = (None, __import__(
        "ray_tpu._private.persist" if pkg == "jax"
        else "ray_tpu_torch._persist", fromlist=["StateStore"]))
    c = C.Controller()
    c.persist = persist_mod.StateStore(store_dir)
    seen = {}
    job = ids.JobID(b"\x07\x00\x00\x00")
    c.register_job(C.JobInfo(job, entrypoint="driver"))
    node = ids.NodeID(b"n" * 16)
    c.register_node(C.NodeInfo(node, "host", RS({"CPU": 4.0}),
                               is_head=True))
    c.note_revivable(b"r" * 16, ("host2", {"CPU": 2.0}, 0))
    spec = proto.TaskSpec(
        task_id=ids.TaskID(b"t" * 18), name="Counter.__init__",
        fn_blob=b"ctor", method_name=None, arg_descs=[("val", b"args")],
        kwarg_descs={}, return_ids=[], resources=RS({"CPU": 0.0}),
        create_actor_id=ids.ActorID(b"a" * 12), max_concurrency=2)
    a1, a2, a3 = (ids.ActorID(bytes([i]) * 12) for i in (1, 2, 3))
    c.register_actor(C.ActorInfo(a1, "svc", C.DEPENDENCIES_UNREADY, spec,
                                 1, namespace="ns1", class_name="Counter"))
    c.register_actor(C.ActorInfo(a2, "svc", C.DEPENDENCIES_UNREADY, spec,
                                 0, namespace="ns2", class_name="Counter"))
    c.register_actor(C.ActorInfo(a3, None, C.PENDING_CREATION, None, 0))
    try:
        c.register_actor(C.ActorInfo(ids.ActorID(b"\x04" * 12), "svc",
                                     C.PENDING_CREATION, None, 0,
                                     namespace="ns1"))
        seen["dup"] = "registered"
    except ValueError as e:
        seen["dup"] = "taken" if "already taken" in str(e) else str(e)
    # a1 lives, dies once (restart), dies again at max_restarts (DEAD).
    c.set_actor_state(a1, C.ALIVE, node_id=node)
    for _death in range(2):
        info = c.get_actor(a1)
        if info.num_restarts < info.max_restarts:
            info.num_restarts += 1
            c.set_actor_state(a1, C.RESTARTING)
            c.set_actor_state(a1, C.ALIVE, node_id=node)
        else:
            c.set_actor_state(a1, C.DEAD, death_cause="worker died")
    c.set_actor_state(a2, C.ALIVE, node_id=node)
    seen["named"] = [_plain(c.get_named_actor("svc", ns).actor_id)
                     for ns in ("ns1", "ns2")]
    # The dead name may be taken again.
    c.register_actor(C.ActorInfo(ids.ActorID(b"\x05" * 12), "svc",
                                 C.PENDING_CREATION, None, 0,
                                 namespace="ns1", class_name="Other"))
    pg = C.PlacementGroupInfo(
        ids.PlacementGroupID(b"p" * 14), "grp", "PACK",
        [C.BundleInfo(0, RS({"CPU": 1.0})), C.BundleInfo(1, RS({"GPU": 1.0}))])
    c.register_placement_group(pg)
    pg.bundles[0].node_id = node
    c.set_pg_state(pg.pg_id, C.PG_CREATED)
    pg2 = C.PlacementGroupInfo(ids.PlacementGroupID(b"q" * 14), None,
                               "SPREAD", [C.BundleInfo(0, RS({"CPU": 2.0}))])
    c.register_placement_group(pg2)
    c.set_pg_state(pg2.pg_id, C.PG_REMOVED)
    c.kv_put("a", b"1")
    c.kv_put("b", b"2", namespace="other")
    seen["no_overwrite"] = c.kv_put("a", b"x", overwrite=False)
    c.kv_del("a")
    seen["keys"] = [c.kv_keys(), c.kv_keys("", "other")]
    got = {}
    waiter = threading.Thread(target=lambda: got.update(
        v=c.kv_wait("late", timeout=60)))
    waiter.start()
    time.sleep(0.05)
    c.kv_put("late", b"woken")
    waiter.join(60)
    seen["kv_wait"] = got["v"]
    seen["kv_wait_timeout"] = c.kv_wait("never", timeout=0.01)
    c.publish("chan", "m1")
    c.publish("other", "x")
    c.publish("chan", "m2")
    seq, msgs = c.pubsub_poll("chan", 0, timeout=0)
    seen["poll"] = msgs
    seen["poll_after"] = c.pubsub_poll("chan", seq, timeout=0)[1]
    c.finish_job(job)
    c.drop_revivable(b"r" * 16)
    return c, seen


def test_controller_tables_match_jax(tmp_path):
    jc, jseen = _script("jax", str(tmp_path / "j"))
    pc, pseen = _script("port", str(tmp_path / "p"))
    assert pseen == jseen
    assert jseen["dup"] == "taken"
    assert _tables(pc) == _tables(jc)
    tables = _tables(pc)
    assert tables["actors"][("01" * 12)]["state"] == "DEAD"
    assert tables["actors"][("01" * 12)]["num_restarts"] == 1
    # The snapshot rebuilds the tables (nodes re-register: never
    # persisted); the WAL each package wrote rebuilds equal tables in both
    # (JAX keeps a refused duplicate in memory unlogged, as the port does).
    rebuilt = {}
    for pkg, c in (("jax", jc), ("port", pc)):
        C = _mods(pkg)[0]
        r = C.Controller()
        r.restore(c.snapshot_records())
        want = _tables(c)
        want["nodes"] = {}
        assert _tables(r) == want, pkg
        w = C.Controller()
        w.restore(c.persist.load())
        c.persist.close()
        rebuilt[pkg] = _tables(w)
    assert rebuilt["port"] == rebuilt["jax"]
    assert rebuilt["port"]["kv"] == {"default": {"late": b"woken"},
                                     "other": {"b": b"2"}}


# -- serialization ----------------------------------------------------------------


def _values():
    import torch
    t = torch.arange(48, dtype=torch.float32).reshape(6, 8)
    return [np.arange(300_000, dtype=np.float32),
            t.numpy(),
            {"a": [1, 2.5, "x", None], "b": {"c": np.ones((3, 4)),
                                             "d": (b"raw", True)}}]


def test_serialization_frames_match_jax():
    from ray_tpu._private import serialization as js

    from ray_tpu_torch import _serialization as ps
    for v in _values():
        jb, pb = js.pack_payload(v), ps.pack_payload(v)
        assert pb == jb
        for blob in (jb, pb):
            for mod in (js, ps):
                back = mod.unpack_payload(blob)
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(back, v)
                else:
                    assert repr(back) == repr(v)
    meta, bufs = ps.serialize_payload(_values()[0])
    assert len(bufs) == 1 and bufs[0].nbytes == 1_200_000
    assert ps.loads_control(ps.dumps_control({"k": (1, b"2")})) == \
        {"k": (1, b"2")}


# -- scenarios in fresh interpreters ------------------------------------------------


def test_max_restarts_matches_jax():
    jax_out, port_out = _both("restart")
    assert port_out == jax_out
    assert port_out == {"first": 11, "second": 12, "die1": "ActorError",
                        "after_restart": 11, "new_pid": True,
                        "die2": "ActorError", "after_death": "ActorError"}


def test_state_dir_survives_sigkill_in_both(tmp_path):
    firsts = [_start(["state_first", pkg, tmp_path / pkg])
              for pkg in ("jax", "port")]
    outs = [_result(p, allow_kill=True) for p in firsts]
    for p in firsts:
        assert p.returncode == -signal.SIGKILL
    assert [o["bump"] for o in outs] == [101, 101]
    assert all(o["pg_ready"] for o in outs)
    seconds = [_start(["state_second", pkg, tmp_path / pkg, o["pg"]])
               for pkg, o in zip(("jax", "port"), outs)]
    jax_out, port_out = [_result(p) for p in seconds]
    assert port_out == jax_out == {"kv": "ft-value", "bump": 101,
                                   "pg_state": "CREATED"}


def _head(pkg, tmp_path, state_dir=""):
    """Start a head process; (process, its address file's content)."""
    addr_file = str(tmp_path / f"head_address_{pkg}")
    if os.path.exists(addr_file):
        os.unlink(addr_file)     # a SIGKILLed head leaves its file
    mod = "ray_tpu.scripts.head" if pkg == "jax" else \
        "ray_tpu_torch.scripts.head"
    args = [sys.executable, "-m", mod, "--node-port", "0", "--token", TOKEN,
            "--address-file", addr_file, "--dashboard-port", "-1",
            "--num-cpus", "4", "--num-tpus", "0", "--state-dir", state_dir,
            "--port", "0" if pkg == "jax" else "-1"]
    env = _env()
    if pkg == "port":
        # Pings every 0.2 s, a client silent for 1 s is closed: a call
        # that waits for an actor's start (seconds) must not hold up the
        # client's reader, which answers them.
        env["RAY_TPU_HEALTH_CHECK_PERIOD_S"] = "0.2"
    proc = subprocess.Popen(args, env=env, cwd=HERE,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        assert proc.poll() is None, f"{pkg} head exited {proc.returncode}"
        try:
            with open(addr_file) as f:
                return proc, json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            time.sleep(0.1)
    proc.kill()
    raise AssertionError(f"{pkg} head did not boot")


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def test_head_and_clients_match_jax(tmp_path):
    heads = {pkg: _head(pkg, tmp_path) for pkg in ("jax", "port")}
    try:
        outs = {}
        for scenario in ("client", "client_again"):
            procs = {pkg: _start([scenario, pkg, info["node_address"], TOKEN])
                     for pkg, (_, info) in heads.items()}
            outs[scenario] = {pkg: _result(p) for pkg, p in procs.items()}
        for scenario, by_pkg in outs.items():
            assert by_pkg["port"] == by_pkg["jax"], scenario
        assert outs["client"]["port"]["big"] == [[200000], 12345.0,
                                                 float(np.arange(
                                                     200_000,
                                                     dtype=np.float32).sum())]
        assert outs["client_again"]["port"] == {"one": 1}
        port_info = heads["port"][1]
        assert port_info["address"] is None
        assert oct(os.stat(str(tmp_path / "head_address_port")).st_mode
                   & 0o777) == "0o600"
    finally:
        for proc, _ in heads.values():
            _stop(proc)


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[1].split()[0] == "Z"
    except OSError:
        return True


def test_port_head_survives_kill9(tmp_path):
    """JAX's ``test_kill9_restart_actors_pgs_kv_survive`` against the
    port's head, plus: no old worker alive, no old segment left, a
    ``__main__`` function refused."""
    state = str(tmp_path / "state")
    head, info = _head("port", tmp_path, state)
    try:
        client = _start(["kill9_before", "port", info["node_address"],
                         TOKEN], stdin=subprocess.PIPE)
        for line in client.stdout:    # connected until its stdin closes
            if line.startswith("RESULT "):
                before = json.loads(line[len("RESULT "):])
                break
        else:
            raise AssertionError(client.stderr.read()[-4000:])
        assert before["bump"] == 101 and before["pg_ready"]
        assert before["big"] == float(1 << 20) and before["task"] == 3
        assert before["main_refused"] is True
        old = before["info"]
        assert old["pid"] == head.pid and old["worker_pids"]
        assert glob.glob(f"/dev/shm/rtt_{old['session_id']}_*")
        head.send_signal(signal.SIGKILL)
        head.wait(timeout=30)
        client.communicate("\n", timeout=TIMEOUT)
        deadline = time.monotonic() + 10
        while not all(map(_gone, old["worker_pids"])) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert [p for p in old["worker_pids"] if not _gone(p)] == []
        head, info = _head("port", tmp_path, state)
        after = _result(_start(["kill9_after", "port", info["node_address"],
                                TOKEN, before["pg"]]))
        assert after["kv"] == "ft-value"
        assert after["bump"] == 101          # fresh state, args replayed
        assert after["pg_state"] == "CREATED"
        assert after["pid"] not in old["worker_pids"]
        assert glob.glob(f"/dev/shm/rtt_{old['session_id']}_*") == []
    finally:
        _stop(head)


# -- a head session in this process -------------------------------------------------


def test_head_session_shuts_down_clean(tmp_path):
    """``init(head_port=, cluster_token=, state_dir=)`` in this process, a
    client connection served (a task, the KV verbs, a placement group),
    then ``shutdown()``: the leak sanitizer (on for the suite) finds no
    thread left, and the WAL holds the shutdown's verdict."""
    import ray_tpu_torch as rtt
    from ray_tpu_torch import _actor, _client
    from ray_tpu_torch._persist import StateStore
    session = rtt.init(num_cpus=1, head_port=0, cluster_token=b"t" * 16,
                       state_dir=str(tmp_path / "s"))
    try:
        _actor.control("kv_put", "k", b"v")
        rt = _client.ClientRuntime(session.head_server.address, b"t" * 16)
        try:
            assert rt.control("kv_get", "k") == b"v"
            assert rt.control("kv_wait", "k", timeout=5) == b"v"
            assert rt.control("kv_keys") == ["k"]
            assert rt.control("nodes")[0]["is_head"]
            pg = rt.control("create_pg", [{"CPU": 1}], "PACK", None)
            assert rt.control("pg_wait", pg, 30)
            assert rt.control("get_named_actor", "nobody") is None
            with pytest.raises(RuntimeError, match="unknown control verb"):
                rt.control("no_such_verb")
        finally:
            rt.disconnect()
    finally:
        rtt.shutdown()
    records = StateStore(str(tmp_path / "s")).load()
    assert ("kv_put", "default", "k", b"v") in records
    assert any(r[0] == "pg" and r[1].state == "CREATED" for r in records)


def test_workers_verbs_and_a_revival_that_cannot_import(tmp_path):
    """A task and an actor call the session's KV verbs over the endpoint;
    an actor replayed from the WAL whose class no longer imports goes
    DEAD with the cause, and the boot goes on."""
    import _torch_head_fns as F

    import ray_tpu_torch as rtt
    from ray_tpu_torch import _actor, _controller, _ids, _persist, _protocol
    from ray_tpu_torch._resources import ResourceSet
    state = str(tmp_path / "s")
    aid = _ids.ActorID(b"\x09" * 12)
    spec = _protocol.TaskSpec(
        task_id=_ids.TaskID.of(aid), name="Gone.__init__",
        fn_blob=__import__("pickle").dumps(
            ("actor", "no_such_module_anywhere", "Gone", {"num_cpus": 0})),
        method_name=None, arg_descs=[("val", __import__("pickle").dumps(
            ((), {})))], kwarg_descs={}, return_ids=[],
        resources=ResourceSet({"CPU": 0.0}), create_actor_id=aid)
    st = _persist.StateStore(state)
    st.append(("actor", _controller.ActorInfo(
        aid, "gone", _controller.ALIVE, spec, 0, class_name="Gone")))
    st.close()
    rtt.init(num_cpus=1, state_dir=state)
    try:
        _actor.control("kv_put", "k", b"v")
        assert rtt.get(rtt.remote(F.kv_from_task).remote("k"),
                       timeout=TIMEOUT) == b"v"
        a = rtt.remote(F.Counter).options(
            num_cpus=1, env_vars={"OMP_NUM_THREADS": "1"}).remote()
        assert rtt.get(a.kv.remote("k"), timeout=TIMEOUT) == b"v"
        assert _actor.control("kv_keys", "k/") == ["k/task", "k/actor"]
        deadline = time.monotonic() + TIMEOUT
        while not _actor.is_dead(_actor.ActorHandle(aid.hex())):
            assert time.monotonic() < deadline, "the replayed actor lives"
            time.sleep(0.05)
        info = _actor._session.controller.get_actor(aid)
        assert info.state == "DEAD"
        assert "no_such_module_anywhere" in info.death_cause
        with pytest.raises(ValueError, match="died"):
            rtt.get_actor("gone")
    finally:
        rtt.shutdown()

"""The port's leak sanitizer (``ray_tpu_torch._sanitizer``) against the JAX
package's (``ray_tpu/_private/sanitizer.py``).

- ``tests/test_sanitizer.py``'s scenarios run through both packages, each
  session at ``init(num_cpus=2)``: a clean session passes; an injected
  pin, thread or framework-created named actor trips the shutdown gate
  with its creation site; a session-scoped name is exempt; ``report()``
  names a tracked spawn; the checkpoint writer's thread retires after a
  wedged close; ``get(timeout=)`` leaves no timer behind.  The JAX
  runtime and the port's session never overlap: the JAX sanitizer counts
  threads started from any path under ``ray_tpu*``.
- Both sanitizers patch ``threading.Thread.start``: the port's install
  wraps what is in force, and its uninstall leaves the JAX package's
  wrapper in place, in either order; the wrapper on top records the
  port's threads, and neither records a user's.
- ROADMAP Queue 3 fault 12: a ref returned inside its submitter's result
  outlives the submitting task (its inner value in shared memory), in
  both packages, and the session shuts down with no leak.

The suite runs with ``RAY_TPU_SANITIZE=1`` (``tests/conftest.py``), so
both packages' sanitizers are installed at import.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rtt
from ray_tpu_torch import _sanitizer as P
from ray_tpu_torch._sanitizer import LeakError as PLeakError

TIMEOUT = 60


def _jax():
    import ray_tpu
    from ray_tpu._private import sanitizer
    return ray_tpu, sanitizer


def _pkgs():
    ray_tpu, j_san = _jax()
    return {"jax": (ray_tpu, j_san), "port": (rtt, P)}


@pytest.fixture(autouse=True)
def _fast_grace(monkeypatch):
    _ray_tpu, j_san = _jax()
    assert P.is_enabled() and j_san.is_enabled()
    monkeypatch.setattr(P, "DEFAULT_GRACE_S", 1.0)
    monkeypatch.setattr(j_san, "DEFAULT_GRACE_S", 1.0)
    yield


def echo(x):
    return x


class Holder:
    def ping(self):
        return "ok"


def inner_big():
    return np.arange(200_000, dtype=np.float64)    # 1.6 MB: shared memory


def outer_port():
    return [rtt.remote(inner_big).remote()]


def outer_jax():
    import ray_tpu
    return [ray_tpu.remote(inner_big).remote()]


def _leak_of(rt, san, exc):
    with pytest.raises(exc) as ei:
        rt.shutdown()
    return str(ei.value)


# -- tests/test_sanitizer.py's scenarios, per package ---------------------------


def sc_clean_session_passes(rt, san, pkg):
    rt.init(num_cpus=2)
    assert rt.get(rt.remote(echo).remote(7)) == 7
    rt.shutdown()
    return "clean"


def sc_injected_pin_leak_caught(rt, san, pkg):
    sess = rt.init(num_cpus=2)
    if pkg == "jax":
        ref = rt.put(b"snapshot-blob")
        sess.ctl_pin_object(ref.binary())
        oid = ref.binary().hex()
    else:
        from ray_tpu_torch import _object_store
        store = _object_store.SharedMemoryStore()
        oid = _object_store.new_object_id()
        store.put(oid, b"snapshot-blob")
        assert store.try_pin(oid)
    msg = _leak_of(rt, san, san.LeakError)
    san.note_unpin(oid)
    if pkg == "port":
        store.shutdown()
    return "[pin]" in msg, "pinned at" in msg


def sc_injected_thread_leak_caught(rt, san, pkg):
    rt.init(num_cpus=2)
    release = threading.Event()
    t = san.spawn(release.wait, name="injected-leak-thread")
    try:
        msg = _leak_of(rt, san, san.LeakError)
    finally:
        release.set()
        t.join(5)
    return "injected-leak-thread" in msg, "created at" in msg


def _inject_named(san, name, site):
    with san._state.mu:
        san._state.named_actors[f"default/{name}"] = {
            "name": name, "namespace": "default", "class_name": "Holder",
            "site": site, "stack": []}


def _drop_named(san, name):
    with san._state.mu:
        san._state.named_actors.pop(f"default/{name}", None)
        if name in san._state.session_patterns:
            san._state.session_patterns.remove(name)


def sc_injected_named_actor_leak_caught(rt, san, pkg):
    rt.init(num_cpus=2)
    h = rt.remote(Holder).options(name="leaky-holder").remote()
    rt.get(h.ping.remote())
    # User-created named actors are reaped by shutdown by design; this
    # simulates a framework-created one, as a subsystem frame records it.
    _inject_named(san, "leaky-holder", f"{rt.__name__}/somepkg/mod.py:1")
    try:
        msg = _leak_of(rt, san, san.LeakError)
    finally:
        _drop_named(san, "leaky-holder")
    return "leaky-holder" in msg, "[named_actor]" in msg


def sc_session_scoped_name_is_exempt(rt, san, pkg):
    rt.init(num_cpus=2)
    h = rt.remote(Holder).options(name="san-exempt-holder").remote()
    rt.get(h.ping.remote())
    _inject_named(san, "san-exempt-holder",
                  f"{rt.__name__}/somepkg/mod.py:1")
    san.session_scoped("san-exempt-holder")
    try:
        rt.shutdown()  # declared session-lifetime
    finally:
        _drop_named(san, "san-exempt-holder")
    return "exempt"


def sc_report_names_tracked_spawn(rt, san, pkg):
    release = threading.Event()
    t = san.spawn(release.wait, name="report-probe")
    try:
        rep = san.report()
        probe = [th for th in rep["threads"] if th["name"] == "report-probe"]
        return bool(probe) and probe[0]["tracked"] is True and \
            bool(probe[0]["site"]), rep["enabled"]
    finally:
        release.set()
        t.join(5)


def sc_async_writer_thread_exits_after_wedged_close(rt, san, pkg,
                                                    tmp_path, monkeypatch):
    import importlib
    fmt = importlib.import_module(f"{rt.__name__}.checkpoint.format")
    aw = importlib.import_module(f"{rt.__name__}.checkpoint.async_writer")
    monkeypatch.setenv("RAY_TPU_CKPT_TEST_WRITE_DELAY_S", "2.0")
    w = aw.AsyncCheckpointWriter(max_inflight=1)
    if pkg == "jax":
        snap = fmt.snapshot_tree({"x": np.zeros(4)})
    else:
        import torch
        snap = fmt.snapshot_tree({"x": torch.zeros(4)})
    w.submit(aw.WriteJob(dirpath=str(tmp_path / pkg / "step_00000001"),
                         step=1, rank=0, world=1, snapshot=snap))
    with pytest.raises(fmt.CheckpointError):
        w.close(timeout=0.2)
    # The wedged write ends (2 s); the thread must retire then.
    w._thread.join(TIMEOUT)
    return w._thread.is_alive()


def sc_get_timeout_timer_cancelled(rt, san, pkg):
    rt.init(num_cpus=2)
    try:
        refs = [rt.remote(echo).remote(i) for i in range(8)]
        out = rt.get(refs, timeout=120)
        deadline = time.monotonic() + 5
        while True:
            zombies = [t for t in threading.enumerate()
                       if isinstance(t, threading.Timer) and t.is_alive()]
            if not zombies or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        return out, zombies
    finally:
        rt.shutdown()


SCENARIOS = [sc_clean_session_passes, sc_injected_pin_leak_caught,
             sc_injected_thread_leak_caught,
             sc_injected_named_actor_leak_caught,
             sc_session_scoped_name_is_exempt, sc_report_names_tracked_spawn,
             sc_get_timeout_timer_cancelled]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_scenario_matches_jax(scenario):
    out = {}
    for pkg, (rt, san) in _pkgs().items():
        out[pkg] = scenario(rt, san, pkg)
    assert out["port"] == out["jax"]
    assert out["port"] not in (False, (False, False))


def test_async_writer_scenario_matches_jax(tmp_path, monkeypatch):
    out = {pkg: sc_async_writer_thread_exits_after_wedged_close(
        rt, san, pkg, tmp_path, monkeypatch)
        for pkg, (rt, san) in _pkgs().items()}
    assert out == {"jax": False, "port": False}


# -- Thread.start chaining -----------------------------------------------------


def _start_from_port_frame():
    """A thread started by code of the port's tree (the sanitizer's
    ``spawn`` path minus its registration: a plain ``Thread.start`` whose
    caller lies in ``ray_tpu_torch``)."""
    release = threading.Event()
    code = compile("t = threading.Thread(target=release.wait)\nt.start()\n",
                   P._PKG_DIR + "/somepkg/mod.py", "exec")
    ns = {"threading": threading, "release": release}
    exec(code, ns)
    return ns["t"], release


@pytest.mark.parametrize("order", ["jax_first", "port_first"])
def test_thread_start_chaining_keeps_the_other_package(order):
    _ray_tpu, j_san = _jax()
    P.uninstall()
    j_san.uninstall()
    real = threading.Thread.start
    try:
        first, second = (j_san, P) if order == "jax_first" else (P, j_san)
        first.install()
        second.install()
        both_top = threading.Thread.start
        t, release = _start_from_port_frame()
        try:
            # The wrapper on top records the port's thread: the port's
            # when it installed last; the JAX package's (which counts any
            # path under ray_tpu*) when it did.  (JAX's install wraps the
            # start in force at its import, so beneath it the port's
            # wrapper runs only if the port installed before that import.)
            if order == "jax_first":
                assert P._state.threads[t]["site"].startswith(
                    "ray_tpu_torch/")
            else:
                assert t in j_san._state.threads
        finally:
            release.set()
            t.join(5)
        P.uninstall()
        if order == "jax_first":
            # The port's wrapper was on top: JAX's is back in force.
            assert threading.Thread.start is j_san._recording_start
        else:
            # JAX wrapped over the port's: left alone.
            assert threading.Thread.start is both_top
        # A user thread started now is recorded by neither.
        ev = threading.Event()
        u = threading.Thread(target=ev.wait)
        u.start()
        assert u not in P._state.threads and u not in j_san._state.threads
        ev.set()
        u.join(5)
        P.install()
        j_san.uninstall()
        P.uninstall()
        # Both off: whatever stays in the chain (the JAX package restores
        # the start it found at its import) records nothing.
        t, release = _start_from_port_frame()
        release.set()
        t.join(5)
        assert t not in P._state.threads and t not in j_san._state.threads
    finally:
        j_san.uninstall()
        P.uninstall()
        threading.Thread.start = real
        j_san.install()
        P.install()
    assert P.is_enabled() and j_san.is_enabled()


def test_port_wrapper_frame_is_not_a_site_for_jax():
    """With the port's wrapper on top of JAX's, a user thread is not
    taken for a framework thread by the JAX sanitizer (the wrapper's
    frames carry a file name outside the package)."""
    _ray_tpu, j_san = _jax()
    assert getattr(threading.Thread.start, "_rtt_sanitizer_prev", None) \
        is not None or threading.Thread.start is j_san._recording_start
    ev = threading.Event()
    u = threading.Thread(target=ev.wait)
    u.start()
    try:
        assert u not in j_san._state.threads and u not in P._state.threads
    finally:
        ev.set()
        u.join(5)


def test_tracked_open_and_checkpoint_writer(tmp_path):
    from ray_tpu_torch.checkpoint import format as fmt
    rtt.init(num_cpus=2)
    fmt.write_bytes_atomic(str(tmp_path / "a.bin"), b"x" * 10)
    f = P.tracked_open(str(tmp_path / "b.txt"), "w")
    msg = _leak_of(rtt, P, PLeakError)
    assert "[file]" in msg and "b.txt" in msg and "a.bin" not in msg
    f.close()
    assert (tmp_path / "a.bin").read_bytes() == b"x" * 10


def test_framework_named_actor_is_recorded_from_a_subsystem_frame():
    code = compile("san.note_named_actor('fw-holder', 'default', 'H')\n",
                   P._PKG_DIR + "/serve/somemod.py", "exec")
    exec(code, {"san": P})
    try:
        rec = P._state.named_actors["default/fw-holder"]
        assert rec["site"].startswith("ray_tpu_torch/serve/somemod.py:")
    finally:
        _drop_named(P, "fw-holder")
    # From the private tiers (a user's own named actor): not recorded.
    code = compile("san.note_named_actor('user-holder', 'default')\n",
                   P._PKG_DIR + "/_actor.py", "exec")
    exec(code, {"san": P})
    assert "default/user-holder" not in P._state.named_actors


# -- fault 12 ------------------------------------------------------------------


def test_nested_ref_outlives_its_submitter():
    """ROADMAP Queue 3 fault 12: the outer task submits an inner one and
    returns ``[inner_ref]``; the driver reads it after the outer task has
    ended and its bookkeeping is collected.  A shared-memory inner value
    (an inline one never had a segment to lose) in both packages, and a
    clean shutdown of each under the sanitizer."""
    out = {}
    for pkg, (rt, _san) in _pkgs().items():
        rt.init(num_cpus=2)
        try:
            outer = outer_jax if pkg == "jax" else outer_port
            ref = rt.remote(outer).remote()
            (inner_ref,) = rt.get(ref, timeout=TIMEOUT)
            del ref
            gc.collect()
            out[pkg] = float(rt.get(inner_ref, timeout=TIMEOUT).sum())
            del inner_ref
            gc.collect()
        finally:
            rt.shutdown()
    assert out["port"] == out["jax"] == float(np.arange(200_000).sum())


def test_clean_shutdown_costs_no_grace(monkeypatch):
    """A clean shutdown leaves no framework thread alive, so the gate
    finds nothing at its first look and waits none of its grace."""
    looks = []
    real = P._leaked_now
    monkeypatch.setattr(P, "_leaked_now",
                        lambda: looks.append(1) or real())
    rtt.init(num_cpus=2)
    h = rtt.remote(Holder).remote()
    assert rtt.get([rtt.remote(echo).remote(1), h.ping.remote()]) == \
        [1, "ok"]
    rtt.shutdown()
    assert looks == [1]

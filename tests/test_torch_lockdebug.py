"""The port's runtime lock instrumentation (``ray_tpu_torch.devtools.
lockdebug``) against the JAX package's.

- The same AB/BA ordering and the same sleep under a lock give the same
  finding kinds in both packages' order detectors.
- ``contention_report`` over a scripted two-thread wait (the waiter is
  seen blocked in the wrapper's contended path before the holder lets go:
  gated on that, not on time) gives the same site and counts.
- Both packages patch ``threading.Lock``/``RLock`` and ``time.sleep``:
  installing and uninstalling the port's instrumentation leaves the JAX
  package's wrappers, or the real primitives, in place, in either order.
- ``RAY_TPU_LOCK_PROFILE=1`` / ``RAY_TPU_DEBUG_LOCKS=1`` install it at
  ``import ray_tpu_torch``; its sampled observations land in the port's
  telemetry catalog series.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import pytest

# Imported before anything patches: each module keeps the primitives in
# force at its import as its fallbacks.
from ray_tpu.devtools import lockdebug as J  # noqa: E402
from ray_tpu_torch.devtools import lockdebug as P  # noqa: E402

REAL = (threading.Lock, threading.RLock, time.sleep)
PKGS = {"jax": J, "port": P}


@pytest.fixture(autouse=True)
def _restore():
    assert (threading.Lock, threading.RLock, time.sleep) == REAL
    yield
    for mod in (P, J):
        mod.uninstall()
        mod.uninstall_profile()
        mod.clear()
    threading.Lock, threading.RLock, time.sleep = REAL


def _order_scenario(mod):
    mod.install()
    mod.clear()
    a, b = threading.Lock(), threading.RLock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    with a:
        time.sleep(0.001)
    kinds = [f["kind"] for f in mod.findings()]
    cycle = [f for f in mod.findings() if f["kind"] == "lock_cycle"]
    mod.uninstall()
    return kinds, len(cycle[0]["cycle"]) if cycle else 0


def test_order_detector_matches_jax():
    want = _order_scenario(J)
    got = _order_scenario(P)
    assert got == want == (["lock_cycle", "blocking_under_lock"], 3)


def _waiting_in_contended_path(t: threading.Thread) -> bool:
    """Is ``t`` blocked on the wrapped lock's contended path (its
    ``acquire`` frame has started the wait clock)?"""
    f = sys._current_frames().get(t.ident)
    while f is not None:
        if f.f_code.co_name == "acquire" and "t0" in f.f_locals:
            return True
        f = f.f_back
    return False


def _contention_scenario(mod):
    mod.install_profile()
    mod.clear_contention()
    lk = threading.Lock()  # the site both reports name
    held, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            held.set()
            release.wait(30)

    h = threading.Thread(target=holder)
    h.start()
    assert held.wait(30)
    w = threading.Thread(target=lambda: lk.acquire() and lk.release())
    w.start()
    deadline = time.monotonic() + 30
    while not _waiting_in_contended_path(w):
        assert time.monotonic() < deadline
        time.sleep(0.001)
    release.set()
    h.join(30)
    w.join(30)
    rows = [r for r in mod.contention_report()["sites"]
            if r["site"].startswith("test_torch_lockdebug.py:")]
    mod.uninstall_profile()
    return [(r["site"], r["kind"], r["locks"], r["acquires"],
             r["contended"], sum(r["wait_hist"]),
             r["wait_total_s"] > 0.0) for r in rows], rows


def test_contention_report_matches_jax():
    want, _ = _contention_scenario(J)
    got, rows = _contention_scenario(P)
    assert got == want
    assert got[0][3:5] == (2, 1)
    # The port's quantiles: half the acquires waited, the other did not.
    r = rows[0]
    assert r["contended_wait_p50_s"] > 0.0
    assert r["wait_p99_s"] == r["contended_wait_p99_s"] > 0.0
    assert "contention" in P.format_contention(P.contention_report())


@pytest.mark.parametrize("mode", ["debug", "profile"])
@pytest.mark.parametrize("order", ["jax_first", "port_first"])
def test_install_order_keeps_the_other_package(order, mode):
    on = "install" if mode == "debug" else "install_profile"
    off = "uninstall" if mode == "debug" else "uninstall_profile"
    first, second = (J, P) if order == "jax_first" else (P, J)
    getattr(first, on)()
    getattr(second, on)()
    j_lock = J._DebugLock if mode == "debug" else J._ProfileLock
    getattr(P, off)()
    if order == "jax_first":
        # The port's wrappers were on top: uninstall restores JAX's.
        assert threading.Lock is j_lock
    else:
        # JAX patched over the port's: uninstall leaves JAX's alone.
        assert threading.Lock is j_lock
    if mode == "debug":
        assert time.sleep is J._debug_sleep
    lk = threading.Lock()
    with lk:
        pass
    getattr(J, off)()
    assert (threading.Lock, threading.RLock, time.sleep) == REAL


def test_port_lock_built_over_jax_wrapper_feeds_both():
    """Installed over the JAX package's profiler, the port's locks wrap
    JAX's: both see the acquires."""
    J.install_profile()
    J.clear_contention()
    P.install_profile()
    P.clear_contention()
    lk = threading.Lock()
    assert isinstance(lk._inner, J._ProfileLock)
    for _ in range(3):
        with lk:
            pass
    assert lk._stats.acquires == 3 and lk._inner._stats.acquires == 3


def test_samples_published_to_port_telemetry():
    from ray_tpu_torch.util import telemetry
    telemetry._reset_for_tests()
    P.install_profile()
    lk = threading.Lock()
    for _ in range(128):
        with lk:
            pass
    P.uninstall_profile()
    hold = telemetry.samples("ray_tpu_lock_hold_seconds")
    assert hold and all(k[0][0] == "site" for k in hold)
    assert telemetry.samples("ray_tpu_lock_wait_seconds")


@pytest.mark.parametrize("var,check", [
    ("RAY_TPU_LOCK_PROFILE", "lockdebug.profile_installed() and "
     "not lockdebug.is_installed() and "
     "threading.Lock is lockdebug._ProfileLock"),
    ("RAY_TPU_DEBUG_LOCKS", "lockdebug.is_installed() and "
     "threading.Lock is lockdebug._DebugLock"),
])
def test_env_var_installs_at_import(var, check):
    code = ("import threading, ray_tpu_torch\n"
            "from ray_tpu_torch.devtools import lockdebug\n"
            f"assert {check}\n"
            "assert 'jax' not in __import__('sys').modules\n")
    env = dict(os.environ, **{var: "1"})
    env.pop("RAY_TPU_SANITIZE", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

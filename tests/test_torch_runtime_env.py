"""Runtime envs, isolation and the OOM monitor of the port's task tier,
held to the JAX package's cases: ``tests/test_runtime_env.py``
(``TestRuntimeEnv``), ``tests/test_isolation.py`` and ``tests/test_oom.py``.

Each JAX case runs here on the port (its tasks and actors are module-level
functions and classes: the port's workers import them by reference).  The
pure helpers (``prepare_runtime_env``, ``pip_env_signature``,
``select_victim``, ``MemorySnapshot``, ``CgroupManager``) run on both
packages with the same inputs and must agree.  Isolation writes only under
a fake cgroupfs in ``tmp_path``; the pip env installs a package made under
``tmp_path`` with ``--no-index`` (nothing is downloaded).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as rtt
from ray_tpu_torch import _cgroup, _memory_monitor, _runtime_env
from ray_tpu_torch._config import Config

TIMEOUT = 60


# -- task functions and actors (module-level) -----------------------------------


def read_payload():
    with open("payload.txt") as f:
        return f.read()


def use_module():
    import shipped_pkg
    return shipped_pkg.MAGIC


def probe_pip():
    import tinypkg_rtenv
    return tinypkg_rtenv.MAGIC, sys.executable


def plain_import():
    try:
        import tinypkg_rtenv  # noqa: F401
        return "leaked"
    except ImportError:
        return "clean"


def one():
    return 1


def hog(n):
    time.sleep(n)
    return "survived"


def quick():
    time.sleep(0.5)
    return "ok"


def rlimit_of_worker():
    import resource
    return resource.getrlimit(resource.RLIMIT_AS)[0]


class Reader:
    def __init__(self):
        with open("conf.json") as f:
            self.conf = json.load(f)

    def x(self):
        return self.conf["x"]


@pytest.fixture(scope="module")
def rt():
    session = rtt.init(num_cpus=4)
    yield session
    rtt.shutdown()


# -- TestRuntimeEnv -----------------------------------------------------------------


def test_working_dir_ships_files(rt, tmp_path):
    (tmp_path / "payload.txt").write_text("hello from working_dir")
    f = rtt.remote(runtime_env={"working_dir": str(tmp_path)})(read_payload)
    assert rtt.get(f.remote(), timeout=TIMEOUT) == "hello from working_dir"


def test_py_modules_importable(rt, tmp_path):
    (tmp_path / "shipped_pkg").mkdir()
    (tmp_path / "shipped_pkg" / "__init__.py").write_text("MAGIC = 1234\n")
    f = rtt.remote(runtime_env={"py_modules": [str(tmp_path)]})(use_module)
    assert rtt.get(f.remote(), timeout=TIMEOUT) == 1234


def test_working_dir_actor(rt, tmp_path):
    (tmp_path / "conf.json").write_text(json.dumps({"x": 7}))
    a = rtt.remote(Reader).options(
        runtime_env={"working_dir": str(tmp_path)},
        env_vars={"OMP_NUM_THREADS": "1"}).remote()
    assert rtt.get(a.x.remote(), timeout=TIMEOUT) == 7
    rtt.kill(a)


def test_conda_and_container_rejected_clearly(rt):
    for key in ("conda", "container"):
        with pytest.raises(NotImplementedError, match=key):
            rtt.remote(runtime_env={key: "myenv"})(one).remote()


def test_pip_env_installs_local_package(rt, tmp_path):
    """A worker under a venv layering a local package over the system
    site-packages; the package does not leak into plain workers."""
    pkg = tmp_path / "tinypkg"
    (pkg / "tinypkg_rtenv").mkdir(parents=True)
    (pkg / "tinypkg_rtenv" / "__init__.py").write_text(
        "MAGIC = 'pip-env-works'\n")
    (pkg / "pyproject.toml").write_text(
        '[project]\nname = "tinypkg-rtenv"\nversion = "0.1"\n'
        '[build-system]\nrequires = ["setuptools"]\n'
        'build-backend = "setuptools.build_meta"\n'
        '[tool.setuptools]\npackages = ["tinypkg_rtenv"]\n')
    f = rtt.remote(runtime_env={"pip": ["--no-index", "--no-build-isolation",
                                        str(pkg)]})(probe_pip)
    magic, exe = rtt.get(f.remote(), timeout=600)
    assert magic == "pip-env-works"
    assert "venv_" in exe
    assert rtt.get(rtt.remote(plain_import).remote(),
                   timeout=TIMEOUT) == "clean"


@pytest.mark.parametrize("pkg_name", ["ray_tpu", "ray_tpu_torch"])
def test_pip_dict_form_and_unknown_keys(pkg_name):
    if pkg_name == "ray_tpu":
        from ray_tpu._private.runtime_env import prepare_runtime_env
    else:
        prepare_runtime_env = _runtime_env.prepare_runtime_env
    out = prepare_runtime_env({"pip": {"packages": ["a", "b"]}})
    assert out["pip"] == ["a", "b"]
    with pytest.raises(NotImplementedError, match="env_overrides"):
        prepare_runtime_env({"pip": {"env_overrides": {}}})


def test_pip_local_path_edit_invalidates_cache(tmp_path):
    from ray_tpu._private.runtime_env import pip_env_signature as jax_sig
    pkg = tmp_path / "p"
    pkg.mkdir()
    (pkg / "f.py").write_text("x = 1\n")
    s1 = _runtime_env.pip_env_signature(["--no-index", str(pkg)])
    assert s1 == jax_sig(["--no-index", str(pkg)])
    time.sleep(0.01)
    (pkg / "f.py").write_text("x = 2\n")
    assert _runtime_env.pip_env_signature(["--no-index", str(pkg)]) != s1


def test_pip_env_failure_surfaces(rt):
    f = rtt.remote(runtime_env={"pip": [
        "--no-index", "definitely-not-a-real-package-xyz"]})(one)
    with pytest.raises(rtt.RuntimeEnvSetupError,
                       match="pip runtime_env setup failed"):
        rtt.get(f.remote(), timeout=600)


def test_missing_dir_raises(rt):
    with pytest.raises(ValueError, match="not found"):
        rtt.remote(runtime_env={"working_dir": "/no/such/dir"})(one).remote()


# -- isolation (JAX's test_isolation.py) ------------------------------------------


@pytest.fixture
def isolation_on():
    Config.initialize()
    Config.set("enable_resource_isolation", True)
    Config.set("worker_memory_limit_bytes", 512 * 1024 * 1024)
    yield
    Config.set("enable_resource_isolation", False)
    Config.set("worker_memory_limit_bytes", 0)


def test_isolation_disabled_by_default():
    Config.initialize()
    m = _cgroup.CgroupManager()
    assert m.mode == "off"
    assert m.spawn_env() == {}
    assert not m.add_process(os.getpid())


def test_fake_cgroupfs_tier(isolation_on, tmp_path):
    m = _cgroup.CgroupManager(root=str(tmp_path))
    assert m.mode == "cgroup"
    workers = tmp_path / f"ray_tpu_{os.getpid()}" / "workers"
    assert (workers / "memory.max").read_text() == str(512 * 1024 * 1024)
    assert m.add_process(1234)
    assert (workers / "cgroup.procs").read_text() == "1234"
    assert m.spawn_env() == {}
    m.cleanup()


def test_rlimit_fallback_tier(isolation_on, tmp_path):
    # An unusable root (a plain file: nothing can be made under it, even
    # as root, where JAX's read-only directory would not stop a write)
    # falls back to the rlimit env tier.
    root = tmp_path / "not-a-cgroupfs"
    root.write_text("")
    m = _cgroup.CgroupManager(root=str(root))
    assert m.mode == "rlimit"
    assert m.spawn_env()[_cgroup.WORKER_MEM_ENV] == str(512 * 1024 * 1024)


def test_worker_respects_rlimit():
    env = dict(os.environ, **{_cgroup.WORKER_MEM_ENV: str(256 * 1024 * 1024)})
    code = ("from ray_tpu_torch._cgroup import apply_worker_rlimits\n"
            "apply_worker_rlimits()\n"
            "try:\n"
            "    x = bytearray(1 << 30)\n"
            "    print('ALLOCATED')\n"
            "except MemoryError:\n"
            "    print('MEMORY-CAPPED')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert "MEMORY-CAPPED" in out.stdout


def test_session_workers_boot_with_the_rlimit_tier(tmp_path):
    """With isolation on and no writable cgroupfs, a session's task
    workers apply ``RLIMIT_AS`` at boot (the rlimit tier end to end)."""
    code = ("import ray_tpu_torch as rt\n"
            "from ray_tpu_torch import _cgroup\n"
            "from ray_tpu_torch._config import Config\n"
            "from test_torch_runtime_env import rlimit_of_worker\n"
            "Config.set('enable_resource_isolation', True)\n"
            "Config.set('worker_memory_limit_bytes', 3 << 30)\n"
            f"_cgroup.CGROUP_ROOT = {str(tmp_path / 'file')!r}\n"
            "s = rt.init(num_cpus=1)\n"
            "print('mode', s.pool.cgroup.mode)\n"
            "print('limit', rt.get(rt.remote(rlimit_of_worker).remote(),"
            " timeout=60))\n"
            "rt.shutdown()\n")
    (tmp_path / "file").write_text("")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(__file__),
         os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "mode rlimit" in out.stdout
    assert f"limit {3 << 30}" in out.stdout


# -- the OOM monitor (JAX's test_oom.py) ------------------------------------------


@pytest.mark.parametrize("pkg_name", ["ray_tpu", "ray_tpu_torch"])
def test_oom_policy(pkg_name):
    if pkg_name == "ray_tpu":
        from ray_tpu._private import memory_monitor as mm
    else:
        mm = _memory_monitor
    snap = mm.system_memory()
    assert snap.total_bytes > 0
    assert 0 <= snap.used_bytes <= snap.total_bytes
    assert 0.0 <= snap.fraction <= 1.0
    a, b, c = "old-nonretriable", "old-retriable", "new-retriable"
    rows = [(a, False, 1.0), (b, True, 2.0), (c, True, 3.0)]
    assert mm.select_victim(rows) == c
    assert mm.select_victim([rows[0], rows[1]]) == b
    assert mm.select_victim([rows[0]]) == a
    assert mm.select_victim([]) is None
    assert mm.MemorySnapshot(50, 100).fraction == 0.5
    assert mm.MemorySnapshot(0, 0).fraction == 0.0


@pytest.fixture
def oom_session():
    session = rtt.init(num_cpus=2)
    yield session
    Config.set("memory_monitor_test_fraction", 0.0)
    rtt.shutdown()


def _wait_running(pool, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if any(w.busy for w in pool.workers):
            return
        time.sleep(0.05)
    raise AssertionError("no task started")


def test_threshold_kill_fails_nonretriable_task(oom_session):
    mon = oom_session.pool.memory_monitor
    # The idle prestarted workers go first (killing them fails nothing).
    mon._min_interval_s = 0.0
    ref = rtt.remote(max_retries=0)(hog).remote(30)
    _wait_running(oom_session.pool)
    Config.set("memory_monitor_test_fraction", 0.99)
    victim = None
    for _ in range(8):
        victim = mon.check_once()
        if victim is not None and victim.busy:
            break
    assert victim is not None and victim.busy
    with pytest.raises(rtt.OutOfMemoryError, match="OOM-killed"):
        rtt.get(ref, timeout=20)


def test_retriable_task_is_retried_after_oom(oom_session):
    ref = rtt.remote(max_retries=2)(quick).remote()
    _wait_running(oom_session.pool)
    Config.set("memory_monitor_test_fraction", 0.99)
    oom_session.pool.memory_monitor.check_once()
    Config.set("memory_monitor_test_fraction", 0.0)
    assert rtt.get(ref, timeout=30) == "ok"


def test_below_threshold_never_kills(oom_session):
    Config.set("memory_monitor_test_fraction", 0.10)
    assert oom_session.pool.memory_monitor.check_once() is None


def test_kill_interval_backoff(oom_session):
    mon = oom_session.pool.memory_monitor
    # An idle victim (JAX's test prestarts two): a prestarted worker whose
    # process is up.
    deadline = time.monotonic() + 10
    while not any(w.proc is not None for w in oom_session.pool.workers) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    Config.set("memory_monitor_test_fraction", 0.99)
    first = mon.check_once()
    assert first is not None and not first.busy   # an idle worker
    assert mon.check_once() is None

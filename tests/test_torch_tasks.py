"""The port's task tier (``ray_tpu_torch._tasks``) against the JAX package's
tasks.

Each case of ``tests/test_tasks_actors.py``'s ``TestTasks``,
``TestFaultTolerance`` (the two task cases) and ``TestStreamingGenerators``
runs as one scenario through both packages: the JAX side under the
conftest ``ray_start`` runtime, the port's under ``ray_tpu_torch.init``
(one module-scoped session, 4 CPU slots), and the two results must be
equal; ``nested_tasks`` gives 201 on both.  Then what only the port has:
the by-reference rule, the scheduler's options accepted on both packages,
the refusals, a ref's payload crossing from worker to worker without the
driver mapping it, workers that never import torch, and no segment of a
session left after ``shutdown()``.

The task functions are plain module-level functions that each package's
``remote`` wraps (the port pickles them by reference, so every worker
imports this file: it imports neither torch nor JAX at the top).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest

import ray_tpu_torch as rtt
from ray_tpu_torch import _tasks

TIMEOUT = 60


# -- the task functions (both packages wrap them) ------------------------------


def double(x):
    return x * 2


def add(a, b):
    return a + b


def three():
    return 1, 2, 3


def norm(x, scale=1.0):
    return float(np.sum(x)) * scale


def boom():
    raise ValueError("kaboom")


def upstream():
    raise RuntimeError("upstream")


def unwrap(refs):
    return _pkg_of(refs[0]).get(refs[0]) + 1


def slow(t):
    time.sleep(t)
    return t


def sleepy():
    time.sleep(10)


def flaky(marker):
    # Crash on the first attempt only, keyed off a file.
    if not os.path.exists(marker):
        open(marker, "w").close()
        os._exit(1)
    return "recovered"


def die():
    os._exit(1)


def squares(n):
    for i in range(n):
        yield i * i


def gated_gen(gate):
    """Item 0, then item 1 only once the consumer has opened ``gate`` (a
    file) after reading item 0: item 1 is True when it did, False when
    the wait ran out."""
    yield 0
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(gate) and time.monotonic() < deadline:
        time.sleep(0.01)
    yield os.path.exists(gate)
    yield 2


def bad_gen():
    yield 1
    yield 2
    raise ValueError("boom")


def big_gen():
    for i in range(3):
        yield np.full(100_000, float(i))


def outer_jax():
    import ray_tpu
    return ray_tpu.get(ray_tpu.remote(double).remote(100)) + 1


def outer_port():
    return rtt.get(rtt.remote(double).remote(100)) + 1


def make_big(n):
    return np.arange(n, dtype=np.float64)


def total(x):
    return float(x.sum())


def add_total(t, x):
    return t + float(x.sum())


def torch_loaded():
    return "torch" in sys.modules


def env_of(key):
    return os.environ.get(key)


def _pkg_of(ref):
    """The package whose ref this is (``unwrap`` runs under both)."""
    if type(ref).__module__.startswith("ray_tpu_torch"):
        return rtt
    import ray_tpu
    return ray_tpu


# -- the scenarios: (package) -> what it observed ------------------------------


def sc_basic(rt):
    return rt.get(rt.remote(double).remote(21))


def sc_chained_dependencies(rt):
    d = rt.remote(double)
    return rt.get(rt.remote(add).remote(d.remote(1), d.remote(2)))


def sc_many_tasks(rt):
    d = rt.remote(double)
    return rt.get([d.remote(i) for i in range(50)])


def sc_multiple_returns(rt):
    a, b, c = rt.remote(num_returns=3)(three).remote()
    return rt.get([a, b, c])


def sc_kwargs_and_large_args(rt):
    big = np.ones(500_000, dtype=np.float32)  # 2 MB: the shm path
    return rt.get(rt.remote(norm).remote(big, scale=2.0))


def sc_error_propagation(rt):
    with pytest.raises(rt.TaskError) as ei:
        rt.get(rt.remote(boom).remote())
    return (type(ei.value.cause).__name__, "kaboom" in str(ei.value))


def sc_error_through_dependency(rt):
    with pytest.raises(rt.TaskError) as ei:
        rt.get(rt.remote(double).remote(rt.remote(upstream).remote()))
    # The dependent's error wraps the upstream task's.
    cause = ei.value.cause
    return (ei.value.task_name, type(cause).__name__, cause.task_name,
            type(cause.cause).__name__, str(cause.cause))


def sc_put_get(rt):
    data = {"arr": np.arange(100), "s": "x"}
    out = rt.get(rt.put(data))
    return out["arr"].tolist(), out["arr"].dtype.str, out["s"]


def sc_ref_passed_inside_container(rt):
    return rt.get(rt.remote(unwrap).remote([rt.put(5)]))


def sc_wait(rt):
    s = rt.remote(slow)
    fast, never = s.remote(0.01), s.remote(5)
    ready, not_ready = rt.wait([fast, never], num_returns=1, timeout=3)
    return ready == [fast], not_ready == [never]


def sc_get_timeout(rt):
    with pytest.raises(rt.GetTimeoutError):
        rt.get(rt.remote(sleepy).remote(), timeout=0.2)
    return "timed out"


def sc_options_name(rt):
    return rt.get(rt.remote(double).options(name="renamed").remote(1))


def sc_task_retry_on_worker_crash(rt, tmp):
    marker = os.path.join(tmp, "flaky_" + uuid.uuid4().hex)
    return rt.get(rt.remote(max_retries=2)(flaky).remote(marker),
                  timeout=TIMEOUT)


def sc_worker_crash_no_retry_raises(rt):
    with pytest.raises(rt.WorkerCrashedError):
        rt.get(rt.remote(max_retries=0)(die).remote(), timeout=TIMEOUT)
    return "crashed"


def sc_stream_yields_refs_in_order(rt):
    return [rt.get(r) for r in
            rt.remote(num_returns="streaming")(squares).remote(5)]


def sc_stream_consumed_while_producing(rt, tmp):
    # Items arrive before the stream ends: the producer holds its next
    # item until the consumer has read the first one.
    gate = os.path.join(tmp, "gate_" + uuid.uuid4().hex)
    it = iter(rt.remote(num_returns="streaming")(gated_gen).remote(gate))
    first = rt.get(next(it))
    open(gate, "w").close()
    rest = [rt.get(r) for r in it]
    return first, rest


def sc_stream_error_raises_at_position(rt):
    it = iter(rt.remote(num_returns="streaming")(bad_gen).remote())
    got = [rt.get(next(it)), rt.get(next(it))]
    with pytest.raises(Exception, match="boom"):
        rt.get(next(it))
    return got


def sc_large_streamed_items(rt):
    vals = [rt.get(r) for r in
            rt.remote(num_returns="streaming")(big_gen).remote()]
    return [float(v[0]) for v in vals], [v.shape for v in vals]


SCENARIOS = [sc_basic, sc_chained_dependencies, sc_many_tasks,
             sc_multiple_returns, sc_kwargs_and_large_args,
             sc_error_propagation, sc_error_through_dependency, sc_put_get,
             sc_ref_passed_inside_container, sc_wait, sc_get_timeout,
             sc_options_name, sc_task_retry_on_worker_crash,
             sc_worker_crash_no_retry_raises,
             sc_stream_yields_refs_in_order,
             sc_stream_consumed_while_producing,
             sc_stream_error_raises_at_position, sc_large_streamed_items]


_TAKES_TMP = (sc_task_retry_on_worker_crash,
              sc_stream_consumed_while_producing)


@pytest.fixture(scope="module")
def port():
    session = rtt.init(num_cpus=4)
    yield session
    rtt.shutdown()


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_scenario_matches_jax(scenario, ray_start, port, tmp_path):
    import ray_tpu
    extra = ((str(tmp_path),) if scenario in _TAKES_TMP else ())
    want = scenario(ray_tpu, *extra)
    got = scenario(rtt, *extra)
    assert got == want


def test_nested_tasks_give_201_on_both(ray_start, port):
    """JAX's ``test_nested_tasks``: the inner ``.remote()`` goes to the
    driver's scheduler, and both packages give 201."""
    import ray_tpu
    assert ray_tpu.get(ray_tpu.remote(outer_jax).remote(),
                       timeout=TIMEOUT) == 201
    assert rtt.get(rtt.remote(outer_port).remote(), timeout=TIMEOUT) == 201


def test_lambda_and_nested_function_refused_at_remote(port):
    def local():
        return 1

    for fn in (lambda: 1, local):
        with pytest.raises(ValueError, match="lambdas and nested functions"):
            rtt.remote(fn).remote()
    # Inside the arguments too.
    with pytest.raises(ValueError, match="top level of a module"):
        rtt.remote(double).remote([local])
    # A RemoteFunction is not called directly (JAX: the same TypeError).
    with pytest.raises(TypeError, match="use .remote"):
        rtt.remote(double)(1)


def _scheduler_option(pkg, opt):
    """(options, expected value of ``env_of(key)``, key) exercising one
    scheduler option on ``pkg``'s session (4 CPUs, no cards asked for)."""
    if opt == "num_tpus":
        return {"num_tpus": 0}, None, "RTT_UNSET"
    if opt == "resources":
        return {"resources": {"CPU": 2}}, None, "RTT_UNSET"
    if opt == "memory":
        return {"memory": 1 << 20}, None, "RTT_UNSET"
    if opt == "placement_group":
        pg = pkg.placement_group([{"CPU": 2}])
        assert pg.ready(timeout=TIMEOUT)
        return {"placement_group": pg}, None, "RTT_UNSET"
    if opt == "scheduling_strategy":
        return {"scheduling_strategy": "SPREAD"}, None, "RTT_UNSET"
    return ({"runtime_env": {"env_vars": {"RTT_PROBE": "rt"}}}, "rt",
            "RTT_PROBE")


@pytest.mark.parametrize("opt", ["num_tpus", "resources", "memory",
                                 "placement_group", "scheduling_strategy",
                                 "runtime_env"])
def test_scheduler_option_runs_as_on_jax(opt, ray_start, port):
    """Each option of the scheduler tier, on ``remote`` and on
    ``.options``, books and runs the task on both packages with the same
    result; ``test_torch_sched.py`` holds each to JAX's decisions."""
    import ray_tpu
    got = {}
    for pkg in (ray_tpu, rtt):
        opts, want, key = _scheduler_option(pkg, opt)
        out = pkg.get([pkg.remote(**opts)(env_of).remote(key),
                       pkg.remote(env_of).options(**opts).remote(key)],
                      timeout=TIMEOUT)
        assert out == [want, want]
        got[pkg.__name__] = out
        if opt == "placement_group":
            pkg.remove_placement_group(opts["placement_group"])
    assert got["ray_tpu"] == got["ray_tpu_torch"]


def test_init_refusals_and_reinit(port):
    for kw, entry in (({"head_port": 0}, "item 13"),
                      ({"address": "h:1"}, "item 13"),
                      ({"cluster_token": b"t"}, "item 13"),
                      ({"state_dir": "/tmp"}, "item 13")):
        with pytest.raises(NotImplementedError, match=entry):
            rtt.init(**kw)
    assert rtt.init(num_cpus=2) is port       # ignore_reinit_error
    with pytest.raises(RuntimeError, match="already called"):
        rtt.init(ignore_reinit_error=False)
    # More CPUs than the node has: parked as infeasible, as JAX's
    # scheduler parks it (it never runs).
    parked = rtt.remote(num_cpus=8)(double).remote(1)
    deadline = time.monotonic() + TIMEOUT
    sched = port.node.scheduler
    while sched.queue_depths()["infeasible"] < 1 and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert sched.queue_depths()["infeasible"] >= 1
    assert not parked._fut.done()
    with pytest.raises(ValueError, match="unknown task options"):
        rtt.remote(num_gpus=1)(double)


def test_task_before_init_refused():
    """In a fresh interpreter: a task before ``init()`` raises (JAX's
    ``_require_runtime``); ``put`` then holds its value; importing the
    package imports no torch."""
    code = (
        "import sys, ray_tpu_torch as rt\n"
        "assert 'torch' not in sys.modules\n"
        "from test_torch_tasks import double\n"
        "try:\n"
        "    rt.remote(double).remote(1)\n"
        "except rt.RayTpuError as e:\n"
        "    print('refused:', e)\n"
        "assert not rt.is_initialized()\n"
        "assert rt.get(rt.put(3)) == 3\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(__file__), os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "refused: ray_tpu_torch.init() has not been called" in out.stdout


def test_ref_crosses_worker_to_worker_without_the_driver_mapping(port):
    """A 8 MB result passed to a second task: only its descriptor crosses;
    the driver maps nothing until it asks for a value itself."""
    big = rtt.remote(make_big).remote(1_000_000)
    desc = big._fut.result(timeout=TIMEOUT)
    assert desc[0] == "shm" and desc[2] > 8_000_000
    before = _tasks.stats().get("mapped_bytes", 0)
    assert rtt.get(rtt.remote(total).remote(big),
                   timeout=TIMEOUT) == 499999500000.0
    # ... and inside a container, as JAX's test_ref_passed_inside_container.
    assert rtt.get(rtt.remote(unwrap).remote([rtt.put(41)])) == 42
    assert _tasks.stats().get("mapped_bytes", 0) == before
    arr = rtt.get(big)
    assert _tasks.stats()["mapped_bytes"] - before == desc[2]
    assert arr[-1] == 999_999.0
    # The segment goes with the driver's last ref (the array read from
    # it keeps its mapping, not the file).
    path = os.path.join("/dev/shm", desc[1])
    assert os.path.exists(path)
    del big
    assert not os.path.exists(path)
    assert arr.sum() == 499999500000.0


def test_ref_dropped_while_its_task_runs_stays_readable(port):
    """The driver drops its only ref of a segment while a task that holds
    the descriptor (top level and inside a container) has yet to map it:
    the task's arguments keep it until the task ends."""
    before = _tasks.stats()
    big = rtt.remote(make_big).remote(1_000_000)
    path = os.path.join("/dev/shm", big._fut.result(timeout=TIMEOUT)[1])
    # The task waits for ``gate`` before it is sent, holding ``big``.
    gate = rtt.remote(slow).remote(3.0)
    out = rtt.remote(add_total).remote(gate, big)
    nested = rtt.remote(unwrap).remote([rtt.put(np.ones(200_000))])
    del big
    assert os.path.exists(path)
    assert rtt.get(out, timeout=TIMEOUT) == 3.0 + 499999500000.0
    # The put's only ref was inside the container: the task held it.
    assert rtt.get(nested, timeout=TIMEOUT).sum() == 400_000.0
    _wait_all_run(before)
    assert not os.path.exists(path)


def test_workers_do_not_import_torch(port):
    flags = rtt.get([rtt.remote(torch_loaded).remote() for _ in range(8)])
    assert flags == [False] * 8


def _wait_all_run(before, timeout=30):
    """Until every task submitted since ``before`` (a ``_tasks.stats()``)
    has ended."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        now = _tasks.stats()
        if now.get("tasks_run", 0) - before.get("tasks_run", 0) >= \
                now["tasks_submitted"] - before.get("tasks_submitted", 0):
            return
        time.sleep(0.02)
    raise AssertionError("tasks still running")


def test_stream_dropped_early_frees_its_items(port):
    before = _tasks.stats()
    gen = rtt.remote(num_returns="streaming")(big_gen).remote()
    first = next(gen)
    rtt.get(first)
    del gen, first
    # The stream runs on after its consumer let go; each later item is
    # freed as it arrives.
    _wait_all_run(before)
    assert _tasks.session_segments() == []


def test_concurrent_submitters_keep_slots_and_segments_balanced(port):
    """16 threads (more than the cores) submit tasks of 1 and 2 CPU slots
    returning shm-sized arrays, read and drop them, under a short switch
    interval: every result is right, the pool's slots all come back, and
    no segment outlives its refs."""
    import threading
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors = []

    def submitter(k):
        try:
            f1 = rtt.remote(make_big)
            f2 = rtt.remote(num_cpus=2)(make_big)
            for i in range(6):
                ref = (f2 if (k + i) % 3 == 0 else f1).remote(20_000 + k)
                arr = rtt.get(ref, timeout=TIMEOUT)
                if arr.shape != (20_000 + k,) or arr[-1] != 19_999 + k:
                    errors.append((k, i, arr.shape))
                del ref, arr
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append((k, repr(e)))
            raise

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    pool = port.pool
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and (
            pool.free != pool.capacity or _tasks.session_segments()):
        time.sleep(0.05)
    assert pool.free == pool.capacity
    assert _tasks.session_segments() == []


def test_other_signatures_run_when_the_pool_is_full():
    """In a fresh interpreter, ``init(num_cpus=1)``: while the one default
    worker runs a task, a ``device="cpu"`` task and an ``env_vars`` task
    come, each needing a worker of its own signature.  Each runs once a
    worker is free (the idle one retires to make room), in its own
    environment, and then a default task again; the pool never holds more
    than one worker."""
    code = (
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import _tasks\n"
        "from test_torch_tasks import slow, env_of\n"
        "s = rt.init(num_cpus=1)\n"
        "busy = rt.remote(slow).remote(1.0)\n"
        "cpu = rt.remote(device='cpu')(env_of).remote("
        "'CUDA_VISIBLE_DEVICES')\n"
        "env = rt.remote(env_vars={'RTT_PROBE': 7})(env_of).remote("
        "'RTT_PROBE')\n"
        "got = rt.get([busy, cpu, env], timeout=60)\n"
        "got.append(rt.get(rt.remote(env_of).remote('RTT_PROBE'), "
        "timeout=60))\n"
        "assert len(s.pool.workers) <= 1, s.pool.workers\n"
        "print('got:', got)\n"
        "rt.shutdown()\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(__file__), os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))]))
    env.pop("RTT_PROBE", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert "got: [1.0, '', '7', None]" in out.stdout


def test_no_segment_outlives_the_session(port):
    """Runs last: held refs, a pending task's result and a streamed item
    alive at ``shutdown()`` leave nothing in ``/dev/shm``."""
    keep = [rtt.put(np.ones(200_000)), rtt.remote(make_big).remote(300_000)]
    rtt.get(keep[1])
    pending = rtt.remote(slow).remote(3)
    gen = rtt.remote(num_returns="streaming")(big_gen).remote()
    next(gen)
    assert _tasks.session_segments()
    sid = port.id
    rtt.shutdown()
    assert not rtt.is_initialized()
    left = [p for p in os.listdir("/dev/shm") if p.startswith(f"rtt_{sid}_")]
    assert left == []
    with pytest.raises(rtt.RayTpuError, match="shut down"):
        rtt.get(pending, timeout=TIMEOUT)
    del keep, gen

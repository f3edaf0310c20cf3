"""The port's profiler (``ray_tpu_torch.profiler``: capture, merge,
``profile`` and ``recompile``) against the JAX package's
``ray_tpu.profiler``.

``merge_records`` of both packages on the same seeded capture records
(host samples only): the same trace events and process entries (each
package summarises its own device-profiler window in the entry: JAX's
``jax_profile``, the port's ``torch_profile``).  ``_signature`` of both
on the same seeded numpy arguments, static arguments included: equal
strings.  Then the port alone: a CPU ``torch.profiler`` window yields
events on the wall clock and the merge folds them in; ``profile()`` over
two CPU actors, one busy in a long call, answers with both pids (the
capture runs beside the call threads); a planted build event on a warm
site bumps ``ray_tpu_profiler_recompiles_total`` once and warns once,
naming the new shape; the hooks are one ``None`` check when nothing
listens.

The JAX package is imported inside functions: the actors import this
file.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np
import pytest

from ray_tpu_torch import _actor as A
from ray_tpu_torch.profiler import capture, merge, recompile

ONE_THREAD = {"num_cpus": 1, "env_vars": {"OMP_NUM_THREADS": "1"},
              "device": "cpu"}


class Busy:
    """An actor whose one call thread a long call can hold."""

    def pid(self):
        return os.getpid()

    def work(self, seconds):
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds:
            sum(i * i for i in range(1000))
        return seconds


def _records(seed):
    """Two seeded capture records (driver and one worker) of host samples:
    threads whose leaf frames change and pause."""
    rng = np.random.default_rng(seed)
    recs = []
    for w, is_driver in (("driver", True), ("ab12cd34ef", False)):
        t, samples = 1_700_000_000.0 + rng.uniform(0, 1), []
        for _ in range(40):
            t += float(rng.uniform(0.01, 0.03))
            threads = {}
            for tid in (11, 12, 13):
                if rng.uniform() < 0.8:
                    leaf = f"f{int(rng.integers(0, 3))} (m.py:{tid})"
                    threads[tid] = {"leaf": leaf,
                                    "stack": [leaf, "main (m.py:1)"],
                                    "name": f"thread-{tid}"}
            samples.append({"t": t, "threads": threads})
        recs.append({"worker_id": w, "pid": 100 + len(recs),
                     "is_driver": is_driver,
                     "clock_offset_s": float(rng.uniform(-0.01, 0.01)),
                     "duration_s": 1.0, "hz": 50.0, "samples": samples,
                     "memory": [], "error": None})
    recs.append({"worker_id": "dead0000", "pid": 7, "is_driver": False,
                 "error": "capture already running", "samples": []})
    return recs


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_records_matches_jax(seed):
    from ray_tpu.profiler.merge import merge_records as jax_merge
    recs = _records(seed)
    timeline = [{"name": "span", "ph": "X", "ts": recs[0]["samples"][3]["t"]
                 * 1e6, "dur": 5e4, "pid": "driver", "tid": 1},
                {"name": "old", "ph": "X", "ts": 1e6, "dur": 1.0,
                 "pid": "driver", "tid": 1}]
    window = (recs[0]["samples"][0]["t"], recs[0]["samples"][-1]["t"])
    want = jax_merge(recs, timeline_events=timeline, window=window,
                     meta={"profile_id": 3})
    got = merge.merge_records(recs, timeline_events=timeline,
                              window=window, meta={"profile_id": 3})
    assert got["traceEvents"] == want["traceEvents"]
    assert len(got["traceEvents"]) > 10
    strip = lambda ps: [{k: v for k, v in p.items()  # noqa: E731
                         if k not in ("jax_profile", "torch_profile")}
                        for p in ps]
    assert strip(got["otherData"]["processes"]) == \
        strip(want["otherData"]["processes"])
    assert got["otherData"]["profile_id"] == 3


def _signature_cases(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.integers(0, 9, (7,)).astype(np.int32)
    tree = {"w": a, "z": [b, None, (1.5, "s")], "k": np.bool_(True)}
    return [((a, b), {}, (), ()),
            ((tree, 3), {"mode": "x", "bias": b}, (1,), ("mode",)),
            ((None, [a] * 70), {}, (), ()),
            ((object(),), {"n": 4}, (), ("n",))]


@pytest.mark.parametrize("seed", [0, 3])
def test_signature_matches_jax(seed):
    from ray_tpu.profiler.recompile import _signature as jax_sig
    for args, kwargs, nums, names in _signature_cases(seed):
        assert recompile._signature(args, kwargs, nums, names) == \
            jax_sig(args, kwargs, nums, names)


def test_signature_names_torch_dtypes_like_numpy():
    import torch
    t = torch.zeros((2, 3), dtype=torch.bfloat16)
    assert recompile._signature((t,), {}) == "(bfloat16[2,3])"


def test_cpu_torch_window_yields_events_on_the_wall_clock():
    import torch
    stop = threading.Event()

    def load():
        x = torch.randn(64, 64)
        while not stop.is_set():
            x = torch.tanh(x @ x) * 0.5
            time.sleep(0.002)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    try:
        t0 = time.time()
        rec = capture.capture_profile("me", 0.5, hz=50.0,
                                      torch_profile=True,
                                      driver_wall_s=t0)
        t1 = time.time()
    finally:
        stop.set()
        t.join()
    tp = rec["torch_profile"]
    assert tp["attempted"] and tp["error"] is None and not tp["cuda"]
    assert tp["num_events"] > 0 and tp["bytes"] <= \
        capture.MAX_TORCH_ARTIFACT_BYTES
    assert rec["samples"]
    # The work around the window, timed by stage.
    assert set(tp["seconds"]) == {"start", "stop", "export", "read", "fit"}
    assert all(v >= 0 for v in tp["seconds"].values())
    doc = merge.merge_records([rec])
    torch_ev = [e for e in doc["traceEvents"]
                if str(e.get("tid", "")).startswith("torch ")]
    assert len(torch_ev) == tp["num_events"]
    assert {"cpu_op"} <= {e["cat"] for e in torch_ev}
    # On the driver's (here: this process's) wall clock, inside the call.
    for e in torch_ev:
        assert t0 * 1e6 - 2e6 < e["ts"] < t1 * 1e6 + 2e6
    (proc,) = doc["otherData"]["processes"]
    assert proc["torch_profile"]["num_events"] == tp["num_events"]


def test_fit_cap_drops_host_events_first():
    events = [{"name": "k", "cat": "kernel", "ph": "X", "ts": 1.0,
               "dur": 1.0, "tid": 7}] * 20 + \
        [{"name": "op" * 40, "cat": "cpu_op", "ph": "X", "ts": 1.0,
          "dur": 1.0, "tid": 1}] * 200
    import json
    blob, n, err = capture._fit_cap(events, 1 << 20)
    assert json.loads(blob) == events and n == 220 and err is None
    blob, n, err = capture._fit_cap(events, 4096)
    kept = json.loads(blob)
    assert len(kept) == n == 20 and {e["cat"] for e in kept} == {"kernel"}
    assert len(blob) <= 4096 and "cpu_op" in err
    # Kernel events alone over the cap: the earliest that fit.
    blob, n, err = capture._fit_cap(events, 200)
    kept = json.loads(blob)
    assert 0 < len(kept) == n < 20 and len(blob) <= 200 and "first" in err


def test_concurrent_capture_reports_busy():
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "a", capture.capture_profile("a", 0.6, hz=50.0)))
    t.start()
    time.sleep(0.2)
    second = capture.capture_profile("b", 0.1)
    t.join()
    assert second["error"] == "capture already running"
    assert out["a"]["error"] is None


def test_profile_over_two_actors_one_busy(tmp_path):
    from ray_tpu_torch import profiler
    cls = A.remote(Busy)
    a, b = (cls.options(**ONE_THREAD).remote() for _ in range(2))
    try:
        pids = A.get([a.pid.remote(), b.pid.remote()], timeout=300)
        busy = a.work.remote(6.0)      # holds a's only call thread
        time.sleep(0.3)
        res = profiler.profile(duration_s=1.0, hz=50.0, torch_profile=True,
                               profile_dir=str(tmp_path))
        assert A.get(busy, timeout=60) == 6.0
    finally:
        A.kill(a)
        A.kill(b)
    assert res["unresponsive"] == []
    procs = res["trace"]["otherData"]["processes"]
    assert {p["pid"] for p in procs} == set(pids) | {os.getpid()}
    assert os.path.dirname(res["path"]) == str(tmp_path)
    assert res["num_events"] == len(res["trace"]["traceEvents"]) > 0
    assert set(res["seconds"]) == {"capture", "collect", "merge"}
    # a's samples show the busy call running while it answered.
    names = {e["name"] for e in res["trace"]["traceEvents"]
             if str(e.get("pid", "")).endswith(f"pid={pids[0]}")}
    assert any("work" in n or "<genexpr>" in n for n in names), names


@pytest.fixture
def detector():
    from ray_tpu_torch.util import telemetry
    recompile._reset_for_tests()
    telemetry._reset_for_tests()
    yield recompile
    recompile._reset_for_tests()
    telemetry._reset_for_tests()


def _fake_site(events):
    """A site that, called with ``x``, plants the listener events queued
    for that call (a kernel build or a first launch)."""
    from ray_tpu_torch.ops import _build

    def serve(x):
        for kind, what in events.pop(0):
            _build.compile_listener(kind, what, 0.01)
        return x.shape
    return serve


def test_planted_build_on_warm_site_recompiles_once(detector, caplog):
    from ray_tpu_torch.util import telemetry
    plan = [[("build", "paged_decode"), ("launch", "paged_decode")],
            [], [("launch", "paged_decode")], [("launch", "paged_decode")]]
    site = detector.track(_fake_site(plan), name="serve_step")
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.profiler"):
        site(np.zeros((4, 8), np.float32))         # first pass: 2 events
        site(np.zeros((4, 8), np.float32))         # warm
        site(np.zeros((6, 8), np.float32))         # new batch size
        site(np.zeros((5, 8), np.float32))         # churn again
    rep = detector.report()["serve_step"]
    assert rep["compiles"] == 4 and rep["warm"] and rep["recompiles"] == 2
    assert rep["events"][:2] == ["build:paged_decode", "launch:paged_decode"]
    (rc,) = telemetry.samples("ray_tpu_profiler_recompiles_total").values()
    assert rc[1] == 2 and rc[0] == {"fn": "serve_step"}
    (ct,) = telemetry.samples("ray_tpu_profiler_compile_total").values()
    assert ct[1] == 4
    warns = [r for r in caplog.records if "post-warmup" in r.getMessage()]
    assert len(warns) == 1 and "float32[6,8]" in warns[0].getMessage()


def test_first_bump_is_exactly_one(detector):
    from ray_tpu_torch.util import telemetry
    plan = [[("launch", "paged_decode")], [], [("launch", "paged_decode")]]
    site = detector.track(_fake_site(plan), name="s")
    for n in (3, 3, 5):
        site(np.zeros((n,), np.int32))
    (rc,) = telemetry.samples("ray_tpu_profiler_recompiles_total").values()
    assert rc[1] == 1


def test_hooks_are_off_without_a_listener(detector):
    from ray_tpu_torch.ops import _build
    assert _build.compile_listener is None
    detector.install()
    assert _build.compile_listener is recompile._on_compile
    detector.uninstall()
    assert _build.compile_listener is None


def test_events_outside_a_tracked_call_are_not_charged(detector):
    from ray_tpu_torch.ops import _build
    detector.install()
    _build.compile_listener("launch", "paged_decode", 0.01)
    assert detector.report() == {}


def _worker_step_fn():
    """A train worker's loop over the port's step (``make_lm_train_step``)
    on a tiny llama; the step's first call plants a kernel library's first
    load, which the CPU never makes.  Reports the worker's recompile
    accounting and whether its step came back tracked."""
    import json

    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                        make_lm_train_step, spmd)
    real, calls = spmd.global_norm, []

    def first_load(grads):
        if not calls and _build.compile_listener is not None:
            _build.compile_listener("build", "planted", 0.0)
        calls.append(1)
        return real(grads)

    spmd.global_norm = first_load
    cfg = llama.LlamaConfig(vocab_size=64, hidden=32, layers=1, heads=2,
                            kv_heads=1, head_dim=16, mlp_dim=64,
                            max_seq_len=16, dtype=torch.float32,
                            remat=False)
    init_fn, step_fn, place = make_lm_train_step(
        cfg, build_mesh(MeshSpec(), device="cpu"))
    params, state = init_fn(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = {"tokens": rng.integers(0, 64, (2, 16)).astype(np.int32)}
        params, state, _m = step_fn(params, state, place(batch))
    train.report({"sites": json.dumps(recompile.report()),
                  "tracked": isinstance(step_fn, recompile.TrackedFunction)})


@pytest.mark.parametrize("detect", ["1", "0"])
def test_train_worker_charges_its_step(tmp_path, detect):
    """Train workers install the detector by default, and the port's train
    step is then a site of its own: the step's first kernel load is
    charged to ``lm_train_step`` and the site is warm after it.
    ``RAY_TPU_RECOMPILE_DETECT=0`` leaves the step untracked."""
    import json

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    res = TorchTrainer(
        _worker_step_fn,
        scaling_config=ScalingConfig(
            device="cpu", formation_timeout_s=60.0,
            env_per_worker={"RAY_TPU_RECOMPILE_DETECT": detect,
                            "OMP_NUM_THREADS": "1"}),
        run_config=RunConfig(name=f"detect{detect}",
                             storage_path=str(tmp_path))).fit()
    assert res.error is None
    (rep,) = [r["metrics"] for r in res.all_reports]
    sites = json.loads(rep["sites"])
    if detect == "0":
        assert sites == {} and rep["tracked"] is False
        return
    assert rep["tracked"] is True
    (site,) = sites.values()
    assert list(sites) == ["lm_train_step"]
    assert site["events"] == ["build:planted"] and site["compiles"] == 1
    assert site["warm"] and site["recompiles"] == 0
    assert len(site["signatures"]) == 1

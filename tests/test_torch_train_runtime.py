"""The port's train runtime mechanisms: the control plane (in one process,
across processes, after a client is killed), the failure budget with a
window, the crash-loop breaker, the watchdog's hang verdict and its bundle,
``MeshConfig`` (tests/test_train_mesh.py's ``TestMeshConfig`` cases, run on
both packages), the mesh status record, the data iterators and step-phase
attribution against the JAX package's, the MLP against JAX's, and the
telemetry copy.

JAX is imported inside functions: every spawned worker imports this file
to find its train fn.
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch._control import ControlPlane, _control, set_current
from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                 TorchTrainer)
from ray_tpu_torch.util import telemetry

FORM_S = 60.0


@pytest.fixture
def plane():
    """A served control plane, current in this process."""
    p = ControlPlane.serve()
    set_current(p)
    yield p
    set_current(None)


# -- control plane -------------------------------------------------------------


class TestControlPlane:
    def test_put_get_keys_del(self, plane):
        assert _control("kv_get", "train/r/report/0/a/1") is None
        for i in range(3):
            _control("kv_put", f"train/r/report/0/a/{i}", b"v%d" % i)
        _control("kv_put", "train/r/ckpt/00000001/0/n", b"ack")
        _control("kv_put", "diagnostics/mesh/last", b"{}")
        _control("kv_put", "train/r/report/0/a/1", b"again")
        assert _control("kv_get", "train/r/report/0/a/1") == b"again"
        assert _control("kv_keys", "train/r/report/") == [
            f"train/r/report/0/a/{i}" for i in range(3)]
        # A prefix shorter than a bucket reaches every bucket under it.
        assert sorted(_control("kv_keys", "train/r/")) == sorted(
            [f"train/r/report/0/a/{i}" for i in range(3)]
            + ["train/r/ckpt/00000001/0/n"])
        assert _control("kv_keys", "diagnostics/mesh/la") == [
            "diagnostics/mesh/last"]
        assert _control("kv_del", "train/r/report/0/a/0")
        assert _control("kv_get", "train/r/report/0/a/0") is None
        assert _control("kv_keys", "train/r/report/") == [
            "train/r/report/0/a/1", "train/r/report/0/a/2"]
        # The deleted key and the duplicate are compacted out of the index.
        raw = plane.kv_get("__index__/train/r/report/")
        assert raw.decode().split("\n")[:-1] == [
            "train/r/report/0/a/1", "train/r/report/0/a/2"]
        assert _control("kv_put", "empty/a/b/c", b"") is None
        assert _control("kv_get", "empty/a/b/c") == b""

    def test_events_and_unknown_verb(self, plane):
        _control("export_event", "EXPORT_TRAIN_WATCHDOG",
                 {"kind": "hang", "rank": 1})
        (ev,) = plane.events()
        assert ev["type"] == "EXPORT_TRAIN_WATCHDOG" and ev["rank"] == 1
        with pytest.raises(ValueError):
            _control("nodes")

    def test_across_processes_and_after_a_client_is_killed(self, plane):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        steady = ctx.Process(target=_client_puts,
                             args=(plane.port, "steady", 20, 0.05))
        doomed = ctx.Process(target=_client_puts,
                             args=(plane.port, "doomed", 10_000, 0.02))
        steady.start()
        doomed.start()
        deadline = time.monotonic() + 60
        while len(plane.kv_keys("train/x/doomed/")) < 3:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        os.kill(doomed.pid, signal.SIGKILL)
        doomed.join()
        left = plane.kv_keys("train/x/doomed/")
        assert len(left) >= 3
        assert plane.kv_get(left[0]) == b"doomed"
        steady.join(timeout=60)
        assert steady.exitcode == 0
        assert plane.kv_keys("train/x/steady/") == [
            f"train/x/steady/{i}" for i in range(20)]
        assert plane.kv_get("done/steady/x/y") == b"ok"
        plane.kv_put("train/x/after/0", b"alive")
        assert plane.kv_keys("train/x/after/") == ["train/x/after/0"]


def _client_puts(port, name, n, pause):
    c = ControlPlane.connect("127.0.0.1", port)
    for i in range(n):
        c.kv_put(f"train/x/{name}/{i}", name.encode())
        time.sleep(pause)
    c.kv_put(f"done/{name}/x/y", b"ok")


# -- failure handling ----------------------------------------------------------


def _always_dies(config):
    os._exit(1)


def _dies_first_times(config):
    """Dies on the first ``config["deaths"]`` incarnations."""
    marks = config["marks"]
    os.makedirs(marks, exist_ok=True)
    if len(os.listdir(marks)) < config["deaths"]:
        open(os.path.join(marks, str(time.monotonic_ns())), "w").close()
        os._exit(1)
    import ray_tpu_torch.train as train
    train.report({"step": 0})


def _fit(fn, tmp_path, name, config=None, **failure):
    failure.setdefault("restart_backoff_initial_s", 0.0)
    return TorchTrainer(
        fn, train_loop_config=config,
        scaling_config=ScalingConfig(device="cpu",
                                     formation_timeout_s=FORM_S),
        run_config=RunConfig(name=name, storage_path=str(tmp_path),
                             failure_config=FailureConfig(**failure))
    ).fit()


class TestFailureHandling:
    @pytest.mark.parametrize("window,failures,error", [
        (None, 2, True),        # lifetime budget: the 2nd failure ends it
        (0.5, 2, False)])       # each failure alone in its window
    def test_budget_with_a_window(self, tmp_path, window, failures, error):
        res = _fit(_dies_first_times, tmp_path, "budget",
                   {"marks": str(tmp_path / "marks"), "deaths": 2},
                   max_failures=1, failure_window_s=window)
        assert (res.error is not None) == error
        assert res.num_failures == failures
        assert res.world_size_history == [1] * (failures + (not error))

    def test_crash_loop_breaker(self, tmp_path):
        from ray_tpu_torch.train import CrashLoopError
        res = _fit(_always_dies, tmp_path, "loop", {}, max_failures=5,
                   crash_loop_threshold=2)
        assert isinstance(res.error, CrashLoopError)
        assert res.num_failures == 2 and res.error.count == 2
        assert "died" in res.error.signature
        with open(res.error.bundle_path) as f:
            bundle = json.load(f)
        assert bundle["crash_loop"]["signature"] == res.error.signature
        with open(tmp_path / "loop" / "events.jsonl") as f:
            events = [json.loads(line) for line in f]
        assert [e["kind"] for e in events] == ["crash_loop"]


def _hangs(config):
    import ray_tpu_torch.train as train
    train.report({"step": 0})
    train.report({"step": 1})
    time.sleep(config["hang_s"])
    train.report({"step": 2})


def test_watchdog_hang_verdict_and_bundle(tmp_path):
    from ray_tpu_torch.train import WatchdogConfig
    telemetry._reset_for_tests()
    res = TorchTrainer(
        _hangs, train_loop_config={"hang_s": 3.0},
        scaling_config=ScalingConfig(device="cpu",
                                     formation_timeout_s=FORM_S),
        run_config=RunConfig(
            name="hang", storage_path=str(tmp_path),
            watchdog=WatchdogConfig(hang_deadline_s=1.0,
                                    poll_interval_s=0.1))).fit()
    assert res.error is None
    (hang,) = telemetry.samples("ray_tpu_train_hang_total").values()
    assert hang[1] == 1
    diag = tmp_path / "hang" / "diagnostics"
    (bundle,) = [p for p in diag.iterdir()
                 if p.name.startswith("watchdog_hang_rank0")]
    data = json.loads(bundle.read_text())
    assert data["verdict"]["status"] == "hang"
    assert data["verdict"]["detail"]["silent_seconds"] > 1.0
    # The worker's stack, from its faulthandler: asleep in the train fn.
    assert "_hangs" in data["stacks"]["0"]
    with open(tmp_path / "hang" / "events.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["hang", "recovered"]


# -- MeshConfig on both packages ------------------------------------------------


def _pkg(name):
    if name == "jax":
        from ray_tpu.train import MeshConfig, ScalingConfig as Scaling
    else:
        from ray_tpu_torch.train import MeshConfig, ScalingConfig as Scaling
    return MeshConfig, Scaling


@pytest.mark.parametrize("pkg", ["jax", "torch"])
class TestMeshConfig:
    """tests/test_train_mesh.py's TestMeshConfig, on each package."""

    def test_parse(self, pkg):
        MeshConfig, _ = _pkg(pkg)
        mc = MeshConfig.parse("dp2xfsdp4")
        assert (mc.dp, mc.fsdp) == (2, 4)
        assert MeshConfig.parse("auto").auto
        mc = MeshConfig.parse("pp2xfsdp4")
        assert (mc.pp, mc.fsdp) == (2, 4)

    def test_parse_rejects_garbage(self, pkg):
        MeshConfig, _ = _pkg(pkg)
        with pytest.raises(ValueError):
            MeshConfig.parse("dp2xbogus4")
        with pytest.raises(ValueError):
            MeshConfig.parse("dp2xdp4")

    def test_spec_resolution_and_absorb(self, pkg):
        MeshConfig, _ = _pkg(pkg)
        spec = MeshConfig.parse("dp2xfsdp4").spec_for(8)
        assert (spec.dp, spec.fsdp) == (2, 4)
        spec = MeshConfig(dp=-1, fsdp=2).spec_for(6)
        assert (spec.dp, spec.fsdp) == (3, 2)
        with pytest.raises(ValueError):
            MeshConfig.parse("dp2xfsdp4").spec_for(6)

    def test_auto_factorization(self, pkg):
        MeshConfig, _ = _pkg(pkg)
        assert (lambda s: (s.dp, s.fsdp))(
            MeshConfig(auto=True).spec_for(8)) == (1, 8)
        assert (lambda s: (s.dp, s.fsdp))(
            MeshConfig(auto=True).spec_for(16)) == (2, 8)
        assert (lambda s: (s.dp, s.fsdp))(
            MeshConfig(auto=True).spec_for(12)) == (2, 6)
        assert MeshConfig(auto=True).spec_for(16, num_slices=2).dp % 2 == 0

    def test_valid_and_nearest_world(self, pkg):
        MeshConfig, _ = _pkg(pkg)
        mc = MeshConfig(dp=-1, fsdp=2)
        assert [w for w in range(1, 9) if mc.valid_world(w)] == [2, 4, 6, 8]
        assert mc.nearest_valid_world(3) == 2
        assert mc.nearest_valid_world(1, ceiling=4) == 2
        assert mc.nearest_valid_world(1) is None

    def test_devices_per_worker_scales_tiling(self, pkg):
        MeshConfig, _ = _pkg(pkg)
        mc = MeshConfig(fsdp=8, devices_per_worker=4)
        assert mc.valid_world(2)
        assert not mc.valid_world(3)

    def test_validate_scaling_fails_fast(self, pkg):
        MeshConfig, Scaling = _pkg(pkg)
        with pytest.raises(ValueError):
            MeshConfig(fsdp=8).validate_scaling(Scaling(num_workers=6))
        with pytest.raises(ValueError):
            MeshConfig(fsdp=8).validate_scaling(
                Scaling(min_workers=2, max_workers=5))
        MeshConfig(fsdp=4).validate_scaling(
            Scaling(min_workers=2, max_workers=5))

    def test_rules_overrides(self, pkg):
        MeshConfig, _ = _pkg(pkg)
        rules = MeshConfig(tp=4, rules={"embed": "tp",
                                        "heads": None}).sharding_rules()
        assert rules.axes_for("embed") == "tp"
        assert rules.axes_for("heads") is None
        assert rules.axes_for("mlp") == "tp"


def _reads_mesh_status():
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train.mesh.runtime import read_mesh_status
    train.report({"status": read_mesh_status(),
                  "mesh": train.get_mesh().shape})


def test_mesh_status_and_gauges_over_the_control_plane(tmp_path):
    """The controller publishes the formed mesh on the control plane; a
    worker reads it back; the axis gauges are JAX's."""
    from ray_tpu_torch.train import MeshConfig
    telemetry._reset_for_tests()
    res = TorchTrainer(
        _reads_mesh_status,
        scaling_config=ScalingConfig(num_workers=2, device="cpu",
                                     mesh_config=MeshConfig(fsdp=2),
                                     formation_timeout_s=FORM_S),
        run_config=RunConfig(name="status", storage_path=str(tmp_path))
    ).fit()
    assert res.error is None and res.mesh["fsdp"] == 2
    for r in res.all_reports:
        status = r["metrics"]["status"]
        assert status["descriptor"] == "fsdp2" and status["world"] == 2
        assert status["axes"]["fsdp"] == 2 and status["devices_per_worker"] == 1
        assert r["metrics"]["mesh"]["fsdp"] == 2
    sizes = {dict(k)["axis"]: v[1] for k, v in telemetry.samples(
        "ray_tpu_train_mesh_axis_size").items()}
    assert sizes == {"pp": 1, "dp": 1, "fsdp": 2, "ep": 1, "sp": 1,
                     "tp": 1}


def test_read_mesh_status_without_a_record(plane):
    from ray_tpu_torch.train.mesh.runtime import (publish_mesh_status,
                                                  read_mesh_status)
    assert read_mesh_status() is None
    publish_mesh_status("r", {"dp": 2, "fsdp": 2}, 4, 1)
    assert read_mesh_status()["descriptor"] == "dp2xfsdp2"


# -- data, attribution, MLP, telemetry ------------------------------------------


def _blocks(seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(n, 3)).astype(np.float32),
             "y": np.arange(n, dtype=np.int64) + 100 * i}
            for i, n in enumerate((5, 7, 1, 6))]


@pytest.mark.parametrize("batch_size,drop_last,seed", [
    (4, False, None), (4, True, None), (3, False, 7), (19, False, None)])
def test_iter_batches_matches_jax(monkeypatch, batch_size, drop_last, seed):
    from ray_tpu.data import iterator as j_iter

    from ray_tpu_torch.data import iter_batches
    monkeypatch.setattr(j_iter, "_blocks_of",
                        lambda ds, force_ordered=False: iter(ds))
    got = list(iter_batches(_blocks(), batch_size=batch_size,
                            drop_last=drop_last, shuffle_seed=seed))
    want = list(j_iter.iter_batches(_blocks(), batch_size=batch_size,
                                    drop_last=drop_last, shuffle_seed=seed))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_device_put_iterator_matches_jax_on_the_cpu():
    from ray_tpu.data import iterator as j_iter

    from ray_tpu_torch.data import device_put_iterator
    batches = _blocks(3)
    got = list(device_put_iterator(iter(batches), device="cpu"))
    want = list(j_iter.device_put_iterator(iter(batches)))
    assert len(got) == len(want) == len(batches)
    for g, w, b in zip(got, want, batches):
        for k in b:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
            # A copy that owns its bytes, not a view of the host batch.
            assert g[k].data_ptr() != b[k].ctypes.data


def test_device_put_iterator_places_onto_a_mesh():
    from ray_tpu_torch.data import device_put_iterator
    from ray_tpu_torch.parallel import build_mesh
    mesh = build_mesh(device="cpu")
    (out,) = device_put_iterator(iter(_blocks()[:1]), sharding=mesh)
    assert out["x"].device.type == "cpu" and out["x"].shape == (5, 3)


def test_device_put_iterator_refuses_a_missing_card(monkeypatch):
    from ray_tpu_torch.data import device_put_iterator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(device_put_iterator(iter(_blocks())))


def test_step_phases_match_jax():
    """The same phase sequence through both packages' attribution: nested
    time is charged to the inner phase, ckpt_block folded in, the
    remainder derived."""
    from ray_tpu.profiler import attribution as j_attr

    from ray_tpu_torch.profiler import attribution as t_attr
    out = {}
    for name, mod in (("jax", j_attr), ("torch", t_attr)):
        mod._reset_for_tests()
        clock = iter([0.0, 1.0, 1.5, 3.0, 3.5, 3.75])
        real = time.monotonic
        time.monotonic = lambda: next(clock)
        try:
            with mod.step_phase("data_wait"):
                with mod.step_phase("h2d"):
                    pass
            with mod.step_phase("compute"):
                pass
        finally:
            time.monotonic = real
        out[name] = mod.finalize_step_phases(mod.pop_phases(), 5.0, 0.25)
    assert out["torch"] == out["jax"] == {
        "data_wait": 2.5, "h2d": 0.5, "compute": 0.25, "ckpt_block": 0.25,
        "other": 1.5}


def test_fence_returns_its_value_and_skips_cpu_tensors():
    from ray_tpu_torch.train import fence
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), 3]}
    assert fence(tree) is tree


def test_mlp_matches_jax():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import MLPConfig as JCfg
    from ray_tpu.models import init_mlp as j_init
    from ray_tpu.models import mlp_loss as j_loss

    from ray_tpu_torch.models import (MLPConfig, init_mlp, mlp_loss,
                                      params_from_numpy)
    cfg = dict(in_dim=8, hidden=16, out_dim=4, layers=3)
    jp = j_init(JCfg(**cfg), jax.random.key(0))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    y = rng.integers(0, 4, 16).astype(np.int32)
    jl, jg = jax.value_and_grad(j_loss)(jp, {"x": jnp.asarray(x),
                                             "y": jnp.asarray(y)})
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu").items()}
    tl = mlp_loss(tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    grads = torch.autograd.grad(tl, list(tp.values()))
    assert abs(tl.item() - float(jl)) <= 1e-6
    for (k, _), g in zip(tp.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=0,
                                   atol=1e-6)
    port = init_mlp(MLPConfig(**cfg), torch.Generator().manual_seed(0),
                    device="cpu")
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}


class TestTelemetry:
    def test_record_merge_and_names(self):
        telemetry._reset_for_tests()
        telemetry.inc("ray_tpu_train_reports_total")
        telemetry.inc("ray_tpu_train_reports_total", 2)
        telemetry.observe("ray_tpu_train_step_phase_seconds", 0.2,
                          tags={"phase": "compute"})
        telemetry.set_gauge("ray_tpu_ckpt_inflight", 3)
        telemetry.inc("ray_tpu_not_in_the_catalog")   # records nothing
        telemetry.observe("ray_tpu_train_reports_total", 1.0)  # wrong type
        snap = telemetry.snapshot()
        telemetry.merge_remote("w1", pickle.loads(pickle.dumps(snap)))
        assert telemetry.emitted_names() == {
            "ray_tpu_train_reports_total", "ray_tpu_ckpt_inflight",
            "ray_tpu_train_step_phase_seconds"}
        (reports,) = telemetry.samples("ray_tpu_train_reports_total").values()
        assert reports[1] == 6.0                       # 3 here + 3 merged
        (hist,) = telemetry.samples(
            "ray_tpu_train_step_phase_seconds").values()
        assert hist[0] == {"phase": "compute"} and hist[1] == 2
        assert sum(hist[3]) == 2
        (gauge,) = telemetry.samples("ray_tpu_ckpt_inflight").values()
        assert gauge[1] == 3.0

    def test_catalog_names_are_jax_names(self):
        from ray_tpu.util import telemetry as j_tel
        for name, spec in telemetry.CATALOG.items():
            assert name in j_tel.CATALOG
            assert spec["type"] == j_tel.CATALOG[name]["type"]
            assert tuple(spec["tag_keys"]) == tuple(
                j_tel.CATALOG[name]["tag_keys"])
        train = {n for n in j_tel.CATALOG
                 if n.startswith(("ray_tpu_train_", "ray_tpu_ckpt_"))}
        assert train <= set(telemetry.CATALOG)

    def test_goodput_tracker_matches_jax(self, monkeypatch):
        from ray_tpu.util import telemetry as j_tel
        out = {}
        for name, mod in (("jax", j_tel), ("torch", telemetry)):
            clock = iter([0.0, 2.0, 6.0, 6.0, 7.0] + [7.0] * 20)
            monkeypatch.setattr(time, "monotonic", lambda: next(clock))
            t = mod.GoodputTracker(initial_phase="init",
                                   update_gauge=False)
            t.enter("step")
            t.reattribute("checkpoint", 1.5)
            t.enter("idle")
            out[name] = t.finish()
            monkeypatch.undo()
        assert out["torch"] == out["jax"]
        assert out["torch"]["phases_s"] == {"init": 2.0, "step": 2.5,
                                            "checkpoint": 1.5, "idle": 1.0}

    def test_checkpoint_seconds_and_spans(self):
        telemetry._reset_for_tests()
        telemetry.note_checkpoint_seconds(0.5)
        telemetry.note_checkpoint_seconds(0.25)
        assert telemetry.pop_checkpoint_seconds() == 0.75
        assert telemetry.pop_checkpoint_seconds() == 0.0
        with telemetry.profile_span("train_fit", "train", {"n": 1}):
            pass
        (span,) = telemetry.spans()
        assert span["name"] == "train_fit" and span["end"] >= span["start"]
        assert span["extra"] == {"n": 1}

"""TorchTrainer (ray_tpu_torch/train) held to JaxTrainer on the same inputs:
the four cases of tests/test_train.py (an MLP trained with legacy
checkpoints on one worker, a planted failure and its resume, an exhausted
failure budget, two-worker data parallelism), run under both trainers from
JAX's ``init_mlp`` weights carried through numpy; the metric names one fit
emits; and the options the port refuses.

JAX is imported inside functions: every spawned worker imports this file
to find its train fn.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.train import (FailureConfig, MeshConfig, RunConfig,
                                 ScalingConfig, TorchTrainer)

LOSS_TOL = 1e-6
#: Each fit's own limit: a formation that stalls fails the run instead of
#: the test's.
FORM_S = 60.0


def _jax_init():
    """JAX's init_mlp weights (test_train's key 0) as numpy."""
    import jax

    from ray_tpu.models import MLPConfig, init_mlp
    params = init_mlp(MLPConfig(in_dim=8, hidden=16, out_dim=4),
                      jax.random.key(0))
    return {k: np.asarray(v) for k, v in params.items()}


def _sgd_step(params, x, y):
    """One step of test_train's loop: loss and p - 0.05 * grad."""
    from ray_tpu_torch.models import mlp_loss
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = mlp_loss(p, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss, {k: (v - 0.05 * g).detach()
                  for (k, v), g in zip(p.items(), grads)}


def _port_mlp_train_fn(config):
    """tests/test_train.py's ``_mlp_train_fn`` in the port."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch.models import params_from_numpy
    from ray_tpu_torch.train import Checkpoint

    ctx = train.get_context()
    start_step = 0
    ckpt = ctx.get_checkpoint()
    if ckpt is not None:
        state = ckpt.load_pytree()
        params = state["params"]
        start_step = int(state["step"])
    else:
        params = params_from_numpy(config["init"], device="cpu")
    rng = np.random.default_rng(ctx.get_world_rank())
    for step in range(start_step, config["steps"]):
        x = rng.normal(size=(16, 8)).astype(np.float32)
        y = (x.sum(axis=1) > 0).astype(np.int32) % 4
        loss, params = _sgd_step(params, x, y)
        if ctx.get_world_rank() == 0:
            ckpt_dir = os.path.join(ctx.storage_path,
                                    ctx.get_experiment_name(),
                                    f"step_{step:04d}")
            cp = Checkpoint.from_pytree({"params": params, "step": step + 1},
                                        ckpt_dir)
            train.report({"loss": float(loss), "step": step}, checkpoint=cp)
        else:
            train.report({"loss": float(loss), "step": step})
        if config.get("die_at_step") is not None and \
                step == config["die_at_step"] and \
                not os.path.exists(config["die_marker"]):
            open(config["die_marker"], "w").close()
            os._exit(1)


def _hangs_once(config):
    import time

    import ray_tpu_torch.train as train
    train.report({"step": 0})
    train.report({"step": 1})
    time.sleep(config["hang_s"])
    train.report({"step": 2})


def _always_dies(config):
    os._exit(1)


def _port_ddp_train_fn(config):
    """tests/test_train.py's ``_ddp_train_fn`` in the port: replicated
    params, each rank's local rows, gradients of the global mean loss."""
    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch.models import params_from_numpy

    ctx = train.get_context()
    assert dist.get_world_size() == 2
    params = params_from_numpy(config["init"], device="cpu")
    rng = np.random.default_rng(ctx.get_world_rank())
    for i in range(config["steps"]):
        x = rng.normal(size=(8, 8)).astype(np.float32)
        y = (x.sum(axis=1) > 0).astype(np.int32) % 4
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        from ray_tpu_torch.models import mlp_loss
        loss = mlp_loss(p, {"x": torch.from_numpy(x),
                            "y": torch.from_numpy(y)})
        grads = torch.autograd.grad(loss, list(p.values()))
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1)])
        dist.all_reduce(flat)
        flat /= dist.get_world_size()
        out, off = {}, 0
        for (k, v) in p.items():
            out[k] = (v - 0.05 * flat[off:off + v.numel()].view_as(v)
                      ).detach()
            off += v.numel()
        params = out
        train.report({"loss": float(flat[-1]), "step": i})


def _fit_both(fn_name, tmp_path, config, workers=1, failures=0):
    """The same case under JaxTrainer (test_train's fn) and TorchTrainer
    (this file's twin): (jax result, port result)."""
    import test_train

    from ray_tpu.train import FailureConfig as JFailure
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train import RunConfig as JRun
    from ray_tpu.train import ScalingConfig as JScaling
    jax_fn, port_fn = {
        "mlp": (test_train._mlp_train_fn, _port_mlp_train_fn),
        "ddp": (test_train._ddp_train_fn, _port_ddp_train_fn),
        "dies": (_always_dies, _always_dies)}[fn_name]
    out = []
    for side, trainer, fn, scaling, run, fail in (
            ("jax", JaxTrainer, jax_fn, JScaling(num_workers=workers),
             JRun, JFailure),
            ("port", TorchTrainer, port_fn,
             ScalingConfig(num_workers=workers, device="cpu",
                           formation_timeout_s=FORM_S), RunConfig,
             FailureConfig)):
        cfg = dict(config)
        if "die_marker" in cfg:
            cfg["die_marker"] = str(tmp_path / f"{side}_died")
        out.append(trainer(
            fn, train_loop_config=cfg, scaling_config=scaling,
            run_config=run(name=f"{fn_name}_{side}",
                           storage_path=str(tmp_path),
                           failure_config=fail(max_failures=failures))
        ).fit())
    return out


def _losses(result, rank=0):
    return [(r["metrics"]["step"], r["metrics"]["loss"])
            for r in sorted(result.all_reports, key=lambda r: r["time"])
            if r["rank"] == rank]


def _assert_same_losses(jres, pres):
    got, want = _losses(pres), _losses(jres)
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=LOSS_TOL)


class TestTrainerVsJax:
    def test_single_worker_e2e(self, ray_start, tmp_path):
        jres, pres = _fit_both("mlp", tmp_path,
                               {"steps": 5, "init": _jax_init()})
        for res in (jres, pres):
            assert res.error is None
            assert res.metrics["step"] == 4
            assert res.checkpoint is not None
        _assert_same_losses(jres, pres)
        jstate = jres.checkpoint.load_pytree()
        pstate = pres.checkpoint.load_pytree()
        assert int(jstate["step"]) == int(pstate["step"]) == 5
        assert set(jstate["params"]) == set(pstate["params"])
        for k, v in jstate["params"].items():
            np.testing.assert_allclose(pstate["params"][k].numpy(),
                                       np.asarray(v), rtol=0, atol=LOSS_TOL)

    def test_failure_recovery_resumes_from_checkpoint(self, ray_start,
                                                      tmp_path):
        jres, pres = _fit_both(
            "mlp", tmp_path, {"steps": 6, "die_at_step": 3,
                              "die_marker": "", "init": _jax_init()},
            failures=1)
        for res in (jres, pres):
            assert res.error is None
        assert pres.num_failures == jres.num_failures == 1
        steps = [sorted(r["metrics"]["step"] for r in res.all_reports)
                 for res in (jres, pres)]
        assert steps[0] == steps[1] == [0, 1, 2, 3, 4, 5]
        assert pres.metrics["step"] == jres.metrics["step"] == 5
        _assert_same_losses(jres, pres)

    def test_failure_budget_exhausted(self, ray_start, tmp_path):
        jres, pres = _fit_both("dies", tmp_path, {}, failures=1)
        for res in (jres, pres):
            assert res.error is not None
        assert pres.num_failures == jres.num_failures == 2
        assert "died" in str(pres.error)

    def test_two_worker_ddp(self, ray_start, tmp_path):
        jres, pres = _fit_both("ddp", tmp_path,
                               {"steps": 3, "init": _jax_init()}, workers=2)
        for res in (jres, pres):
            assert res.error is None
            assert res.metrics["step"] == 2
        by_step = {}
        for r in pres.all_reports:
            by_step.setdefault(r["metrics"]["step"], []).append(
                r["metrics"]["loss"])
        for losses in by_step.values():
            assert len(losses) == 2 and losses[0] == losses[1]
        _assert_same_losses(jres, pres)


def test_fit_emits_jax_metric_names(ray_start, tmp_path):
    """The train and checkpoint metric names a fit with a failure and its
    resume emits (driver and workers merged) are JAX's."""
    import ray_tpu._private.runtime as rt_mod
    from ray_tpu.util import metrics as j_metrics

    from ray_tpu_torch.util import telemetry
    j_metrics._reset_for_tests()
    rt_mod.driver_runtime().metrics_snapshots.clear()
    telemetry._reset_for_tests()
    _fit_both("mlp", tmp_path, {"steps": 4, "die_at_step": 1,
                                "die_marker": "", "init": _jax_init()},
              failures=1)
    prefixes = ("ray_tpu_train_", "ray_tpu_ckpt_")
    jax_names = {s["name"] for s in j_metrics._merged_snapshots()
                 if s["samples"] and s["name"].startswith(prefixes)}
    port_names = {n for n in telemetry.emitted_names()
                  if n.startswith(prefixes)}
    assert "ray_tpu_train_worker_restarts_total" in jax_names
    assert port_names == jax_names


def _nested_fn_holder():
    def nested(config):
        pass
    return nested


class TestRefusals:
    @pytest.mark.parametrize("kw,entry", [
        ({"min_workers": 1, "max_workers": 2}, "elastic resize"),
        ({"num_slices": 2, "num_workers": 2}, "multi-slice"),
        ({"use_tpu": True}, "TPU scaling fields"),
        ({"topology": "2x2"}, "TPU scaling fields"),
        ({"chips_per_worker": 4}, "TPU scaling fields"),
        ({"resources_per_worker": {"CPU": 1}}, "resources_per_worker")])
    def test_scaling_options_raise_with_roadmap_entry(self, tmp_path, kw,
                                                      entry):
        kw = dict(dict(device="cpu"), **kw)
        trainer = TorchTrainer(_always_dies, scaling_config=ScalingConfig(
            **kw), run_config=RunConfig(storage_path=str(tmp_path)))
        with pytest.raises(NotImplementedError, match=entry):
            trainer.fit()

    def test_emergency_replica_raises(self, tmp_path):
        from ray_tpu_torch.train import CheckpointConfig
        run = RunConfig(storage_path=str(tmp_path),
                        checkpoint_config=CheckpointConfig(
                            emergency_replica=True))
        with pytest.raises(NotImplementedError, match="emergency replicas"):
            TorchTrainer(_always_dies, scaling_config=ScalingConfig(
                device="cpu"), run_config=run).fit()

    def test_watchdog_profile_raises(self, tmp_path):
        """Watchdog profiles are ported: ``bundle_profile_s`` > 0 no longer
        raises, and the hang bundle carries a capture of that length of
        the driver and the hung worker (answering on its own thread)."""
        import json
        from ray_tpu_torch.train import WatchdogConfig
        run = RunConfig(name="prof", storage_path=str(tmp_path),
                        watchdog=WatchdogConfig(hang_deadline_s=1.0,
                                                poll_interval_s=0.1,
                                                bundle_profile_s=0.5))
        res = TorchTrainer(_hangs_once, train_loop_config={"hang_s": 4.0},
                           scaling_config=ScalingConfig(device="cpu"),
                           run_config=run).fit()
        assert res.error is None
        diag = tmp_path / "prof" / "diagnostics"
        (bundle,) = [p for p in diag.iterdir()
                     if p.name.startswith("watchdog_hang_rank0")
                     and not p.name.endswith("-profile.json")]
        prof = json.loads(bundle.read_text())["profile"]
        assert prof["workers"] == ["driver", "rank0"]
        assert prof["unresponsive"] == [] and prof["num_events"] > 0
        trace = json.loads(open(prof["path"]).read())
        # The worker's samples: asleep in the train fn.
        assert any("_hangs_once" in str(e.get("args", {}).get("stack"))
                   for e in trace["traceEvents"])

    def test_devices_per_worker_must_be_one(self, tmp_path):
        scaling = ScalingConfig(num_workers=1, device="cpu",
                                mesh_config=MeshConfig(
                                    fsdp=2, devices_per_worker=2))
        with pytest.raises(ValueError, match="devices_per_worker"):
            TorchTrainer(_always_dies, scaling_config=scaling,
                         run_config=RunConfig(
                             storage_path=str(tmp_path))).fit()

    @pytest.mark.parametrize("fn", [_nested_fn_holder(),
                                    lambda config: None])
    def test_train_fn_must_be_module_level(self, tmp_path, fn):
        with pytest.raises(ValueError, match="module-level"):
            TorchTrainer(fn, scaling_config=ScalingConfig(device="cpu"),
                         run_config=RunConfig(
                             storage_path=str(tmp_path))).fit()

    def test_no_card_raises_before_spawning(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        spawned = []
        import torch.multiprocessing as mp
        monkeypatch.setattr(mp, "get_context",
                            lambda *a: spawned.append(a))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchTrainer(_always_dies, scaling_config=ScalingConfig(),
                         run_config=RunConfig(
                             storage_path=str(tmp_path))).fit()
        assert not spawned

    def test_mesh_that_does_not_tile_the_world_raises_at_fit(self,
                                                             tmp_path):
        scaling = ScalingConfig(num_workers=3, device="cpu",
                                mesh_config=MeshConfig(fsdp=2))
        with pytest.raises(ValueError):
            TorchTrainer(_always_dies, scaling_config=scaling,
                         run_config=RunConfig(
                             storage_path=str(tmp_path))).fit()

"""Checkpoints of the port's train runtime: an async save owns its bytes
(the optimizer updates params, mu and nu in place), a rank killed between
its shard write and its ack never moves ``latest``, a checkpoint committed
by a JaxTrainer run resumes in a TorchTrainer run and the reverse, a
reshape resume from fsdp2 on 2 workers to fsdp4 on 4 reads only each
rank's block, the legacy ``pytree.pkl`` layout both ways with its
refusals, and the commit protocol of ``CheckpointManager`` against the JAX
package's.

JAX is imported inside functions: every spawned worker imports this file
to find its train fn.
"""

from __future__ import annotations

import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch._control import ControlPlane, set_current
from ray_tpu_torch.checkpoint import format as F
from ray_tpu_torch.checkpoint.manager import (CheckpointManager,
                                              WorkerCheckpointClient,
                                              ack_prefix)
from ray_tpu_torch.train import (FailureConfig, MeshConfig, RunConfig,
                                 ScalingConfig, TorchTrainer)

FORM_S = 60.0
LOSS_TOL = 1e-6


def _fit(fn, tmp_path, name, config, workers=1, mesh=None, failures=0):
    return TorchTrainer(
        fn, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=workers, device="cpu",
                                     mesh_config=mesh,
                                     formation_timeout_s=FORM_S),
        run_config=RunConfig(name=name, storage_path=str(tmp_path),
                             failure_config=FailureConfig(
                                 max_failures=failures,
                                 restart_backoff_initial_s=0.0))).fit()


# -- an async save owns its bytes ----------------------------------------------


@pytest.fixture
def plane():
    p = ControlPlane.serve()
    set_current(p)
    yield p
    set_current(None)


def test_async_save_then_step_restores_the_pre_step_values(
        tmp_path, plane, monkeypatch):
    """Save asynchronously, take an adamw step (in place), restore: the
    values of before the step.  The write is delayed past the step, so an
    uncloned CPU snapshot would have written the step's values."""
    from ray_tpu_torch import optim
    monkeypatch.setenv("RAY_TPU_CKPT_TEST_WRITE_DELAY_S", "0.3")
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(16, 8, generator=gen),
              "b": torch.randn(8, generator=gen)}
    opt = optim.adamw(1e-2)
    state = opt.init(params)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    state = opt.update(dict(grads), state, params)
    before = {"params": {k: v.clone() for k, v in params.items()},
              "mu": {k: v.clone() for k, v in state.mu.items()},
              "nu": {k: v.clone() for k, v in state.nu.items()}}
    client = WorkerCheckpointClient(
        run_id="r", rank=0, world_size=1,
        run_root=str(tmp_path / "exp"), experiment="exp", async_save=True)
    path = client.save({"params": params, "mu": state.mu, "nu": state.nu,
                        "step": 1})
    state = opt.update(dict(grads), state, params)   # the next step
    assert not torch.equal(params["w"], before["params"]["w"])
    client.flush()
    mgr = CheckpointManager(str(tmp_path), "exp")
    for key in plane.kv_keys(ack_prefix("r")):
        mgr.note_ack(pickle.loads(plane.kv_get(key)))
    (manifest,) = mgr.commit_ready()
    assert mgr.latest() == path and manifest["step"] == 0
    got = F.restore_tree(path)
    for part in ("params", "mu", "nu"):
        for k, v in before[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    client.close()


def test_emergency_replica_raises_in_the_client(tmp_path):
    with pytest.raises(NotImplementedError, match="emergency replicas"):
        WorkerCheckpointClient(run_id="r", rank=0, world_size=1,
                               run_root=str(tmp_path), experiment="e",
                               emergency_replica=True)


# -- a rank killed between its shard write and its ack -------------------------


def _dies_before_ack(config):
    import ray_tpu_torch.train as train
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    state = train.load_checkpoint()
    if state is not None:
        train.report({"resumed_step": int(state["step"]),
                      "w": state["w"].numpy()})
        train.save_checkpoint({"w": state["w"] + 1, "step": 2}, step=2,
                              sync=True)
        return
    w = torch.arange(4.0)
    path = train.save_checkpoint({"w": w, "step": 0}, step=0, sync=True)
    while not F.is_committed(path):
        time.sleep(0.01)
    client = ctx.checkpoint_client()
    if rank == 1:
        def dying_ack(job, index, *rest):
            # The shard is written; the ack never leaves.
            with open(config["marker"], "w") as f:
                json.dump(sorted(os.listdir(job.dirpath)), f)
            os._exit(1)
        client._ack = dying_ack
    train.save_checkpoint({"w": w * 10, "step": 1}, step=1, sync=True)
    time.sleep(60)          # rank 0: acked; the teardown kills it


def test_rank_killed_between_shard_write_and_ack(tmp_path):
    marker = tmp_path / "rank1_wrote.json"
    res = _fit(_dies_before_ack, tmp_path, "ack", {"marker": str(marker)},
               workers=2, failures=1)
    assert res.error is None and res.num_failures == 1
    # Rank 1 had published its shard pair of step 1 when it died.
    assert "shard-00001-of-00002.index.json" in json.loads(
        marker.read_text())
    # latest stayed at step 0: the restarted group resumed from it.
    resumed = [r["metrics"] for r in res.all_reports]
    assert [m["resumed_step"] for m in resumed] == [0, 0]
    for m in resumed:
        np.testing.assert_array_equal(m["w"], np.arange(4.0))
    run = tmp_path / "ack"
    with open(run / "checkpoints.json") as f:
        assert [e["step"] for e in json.load(f)] == [0, 2]
    # Step 2's commit reaped the dead step's directory.
    assert not (run / "checkpoint_000001").exists()
    assert F.is_committed(str(run / "checkpoint_000002"))
    assert res.checkpoint.path == str(run / "checkpoint_000002")


# -- JaxTrainer checkpoints resume in TorchTrainer, and the reverse -------------


def _batch(step):
    rng = np.random.default_rng(100 + step)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    return x, (x.sum(axis=1) > 0).astype(np.int32) % 4


def _jax_resume_fn(config):
    import jax
    import jax.numpy as jnp

    import ray_tpu.train as train
    from ray_tpu.models import mlp_loss
    state = train.load_checkpoint()
    if state is None:
        params, start = dict(config["init"]), 0
    else:
        params, start = state["params"], int(state["step"])
    params = {k: jnp.asarray(np.asarray(v)) for k, v in params.items()}
    grad_fn = jax.jit(jax.value_and_grad(mlp_loss))
    for step in range(start, config["steps"]):
        x, y = _batch(step)
        loss, grads = grad_fn(params, {"x": jnp.asarray(x),
                                       "y": jnp.asarray(y)})
        params = jax.tree.map(lambda p, g: p - 0.05 * g, params, grads)
        if step < config["save_until"]:
            train.save_checkpoint({"params": params, "step": step + 1})
        train.report({"loss": float(loss), "step": step})


def _port_resume_fn(config):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.models import mlp_loss, params_from_numpy
    state = train.load_checkpoint()
    if state is None:
        params, start = params_from_numpy(config["init"], device="cpu"), 0
    else:
        params, start = state["params"], int(state["step"])
    for step in range(start, config["steps"]):
        x, y = _batch(step)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = mlp_loss(p, {"x": torch.from_numpy(x),
                            "y": torch.from_numpy(y)})
        grads = torch.autograd.grad(loss, list(p.values()))
        params = {k: (v - 0.05 * g).detach()
                  for (k, v), g in zip(p.items(), grads)}
        if step < config["save_until"]:
            train.save_checkpoint({"params": params, "step": step + 1})
        train.report({"loss": float(loss), "step": step})


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(ray_start, tmp_path, first):
    """One package trains 6 steps, committing checkpoints after steps 1-3;
    the other resumes the latest (after step 3) in the same run directory
    and its steps 3-5 equal the first run's."""
    import jax

    from ray_tpu.models import MLPConfig, init_mlp
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train import RunConfig as JRun
    from ray_tpu.train import ScalingConfig as JScaling
    init = {k: np.asarray(v) for k, v in init_mlp(
        MLPConfig(in_dim=8, hidden=16, out_dim=4), jax.random.key(0)).items()}

    def run(side, steps, save_until):
        cfg = {"init": init, "steps": steps, "save_until": save_until}
        if side == "jax":
            return JaxTrainer(_jax_resume_fn, train_loop_config=cfg,
                              scaling_config=JScaling(num_workers=1),
                              run_config=JRun(name="x",
                                              storage_path=str(tmp_path))
                              ).fit()
        return _fit(_port_resume_fn, tmp_path, "x", cfg)

    second = "port" if first == "jax" else "jax"
    full = run(first, 6, 3)
    resumed = run(second, 6, 0)
    for res in (full, resumed):
        assert res.error is None
    want = {r["metrics"]["step"]: r["metrics"]["loss"]
            for r in full.all_reports}
    got = {r["metrics"]["step"]: r["metrics"]["loss"]
           for r in resumed.all_reports}
    assert sorted(got) == [3, 4, 5]
    for step, loss in got.items():
        assert abs(loss - want[step]) <= LOSS_TOL, (step, loss, want[step])


# -- reshape resume: fsdp2 on 2 workers -> fsdp4 on 4 ---------------------------

_RESHAPE_LOGICAL = {"w": ("embed", None), "b": (None,)}


def _reshape_fn(config):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.parallel.sharding import dtensor_index
    if config["phase"] == "save":
        tree = train.shard({"w": np.arange(64, dtype=np.float32)
                            .reshape(8, 8),
                            "b": np.arange(8, dtype=np.float32)},
                           _RESHAPE_LOGICAL)
        tree["step"] = 7
        train.save_checkpoint(tree)
        train.report({"w_local": tuple(tree["w"].to_local().shape)})
        return
    reads = []
    plain_read = F._FileShardSource.read

    def counted(self, offset, nbytes):
        reads.append((os.path.basename(self._path), nbytes))
        return plain_read(self, offset, nbytes)

    F._FileShardSource.read = counted
    out = train.load_sharded(dict(_RESHAPE_LOGICAL, step=None))
    train.report({"w": out["w"].to_local().numpy(),
                  "w_index": dtensor_index(out["w"]),
                  "b": out["b"].to_local().numpy(), "step": out["step"],
                  "reads": reads})


def test_reshape_resume_fsdp2_to_fsdp4(tmp_path):
    saved = _fit(_reshape_fn, tmp_path, "reshape", {"phase": "save"},
                 workers=2, mesh=MeshConfig(fsdp=2))
    assert saved.error is None
    assert [r["metrics"]["w_local"] for r in saved.all_reports] == \
        [(4, 8)] * 2
    assert saved.checkpoint.manifest()["metrics"] == {"mesh": "fsdp2"}
    res = _fit(_reshape_fn, tmp_path, "reshape", {"phase": "load"},
               workers=4, mesh=MeshConfig(fsdp=4))
    assert res.error is None and res.mesh["fsdp"] == 4
    full = np.arange(64, dtype=np.float32).reshape(8, 8)
    for r in res.all_reports:
        rank, m = r["rank"], r["metrics"]
        np.testing.assert_array_equal(m["w"], full[2 * rank:2 * rank + 2])
        assert m["w_index"] == ((2 * rank, 2 * rank + 2), (0, 8))
        np.testing.assert_array_equal(m["b"], np.arange(8.0))
        assert m["step"] == 7
        # w's chunks are 4 rows (128 B): the rank read only the one that
        # holds its 2 rows, from the saver that held them.
        w_reads = [f for f, n in m["reads"] if n == 128]
        assert w_reads == [f"shard-{rank // 2:05d}-of-00002.bin"]


# -- the legacy single-pickle layout -------------------------------------------


def _tree_np():
    return {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "i": np.arange(3, dtype=np.int32)}, "step": 5}


def test_legacy_pytree_both_ways(tmp_path):
    from ray_tpu.checkpoint import format as JF
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    JF.save_pytree(_tree_np(), str(jdir))
    got = F.load_pytree(str(jdir))
    assert int(got["step"]) == 5
    for k, v in _tree_np()["params"].items():
        assert got["params"][k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(got["params"][k].numpy(), v)
    F.save_pytree({"params": {k: torch.from_numpy(v) for k, v in
                              _tree_np()["params"].items()}, "step": 5},
                  str(pdir))
    back = JF.load_pytree(str(pdir))
    assert int(back["step"]) == 5
    for k, v in _tree_np()["params"].items():
        np.testing.assert_array_equal(np.asarray(back["params"][k]), v)
        assert np.asarray(back["params"][k]).dtype == v.dtype


def test_legacy_pytree_refuses_bf16_and_orbax(tmp_path):
    import jax.numpy as jnp

    from ray_tpu.checkpoint import format as JF
    JF.save_pytree({"w": np.asarray(jnp.ones((2,), jnp.bfloat16))},
                   str(tmp_path))
    with pytest.raises(F.CheckpointError, match="save_checkpoint"):
        F.load_pytree(str(tmp_path))
    with pytest.raises(F.CheckpointError, match="save_checkpoint"):
        F.save_pytree({"w": torch.ones(2, dtype=torch.bfloat16)},
                      str(tmp_path))
    for call in (lambda: F.save_pytree({}, str(tmp_path), use_orbax=True),
                 lambda: F.load_pytree(str(tmp_path), use_orbax=True)):
        with pytest.raises(F.CheckpointError, match="save_checkpoint"):
            call()


def test_checkpoint_from_pytree_roundtrip(tmp_path):
    from ray_tpu_torch.train import Checkpoint
    cp = Checkpoint.from_pytree({"w": torch.arange(3.0), "step": 2},
                                str(tmp_path / "c"))
    got = cp.load_pytree()
    assert torch.equal(got["w"], torch.arange(3.0)) and int(got["step"]) == 2
    assert cp.manifest() is None and cp.validate() != []


# -- the commit protocol against the JAX package's manager ---------------------


def _acks_and_shards(root):
    """Shards of steps 0-3 over 2 ranks, and their acks (step 1 lacks rank
    1's: that rank died between write and ack)."""
    acks = []
    for step in range(4):
        d = os.path.join(root, f"checkpoint_{step:06d}")
        for rank in range(2):
            snap = F.snapshot_tree({"w": torch.full((2,), float(step))})
            index, blob = F.build_shard(snap, rank, 2, step)
            F.write_shard(d, index, blob, skeleton_pkl=snap.skeleton_pkl
                          if rank == 0 else None)
            if (step, rank) != (1, 1):
                acks.append({"step": step, "rank": rank, "world": 2,
                             "dir": d, "nbytes": len(blob),
                             "crc32": index["crc32"], "write_s": 0.0,
                             "replica": False,
                             "metrics": {"loss": 4.0 - step if step != 3
                                         else 9.0},
                             "generation": None})
    return acks


def test_manager_commit_protocol_matches_jax(tmp_path):
    from ray_tpu.checkpoint.manager import CheckpointManager as JManager
    from ray_tpu.checkpoint.manager import scan_run_dir as j_scan

    from ray_tpu_torch.checkpoint.manager import scan_run_dir
    seen = {}
    for side, cls, scan in (("jax", JManager, j_scan),
                            ("port", CheckpointManager, scan_run_dir)):
        mgr = cls(str(tmp_path / side), "exp", num_to_keep=2)
        committed = []
        for ack in _acks_and_shards(mgr.root):
            mgr.note_ack(ack)
            committed += [m["step"] for m in mgr.commit_ready()]
        seen[side] = {
            "committed": committed,
            "entries": [e["step"] for e in mgr.all_entries()],
            "dirs": sorted(n for n in os.listdir(mgr.root)
                           if n.startswith("checkpoint_")),
            "latest": os.path.basename(mgr.latest()),
            "best": os.path.basename(mgr.best("loss")),
            "scan": [(r["step"], r["committed"], r["valid"])
                     for r in scan(mgr.root, deep=True)]}
    assert seen["port"] == seen["jax"]
    assert seen["port"]["committed"] == [0, 2, 3]
    assert seen["port"]["dirs"] == ["checkpoint_000002",
                                    "checkpoint_000003"]
    assert seen["port"]["best"] == "checkpoint_000002"


# -- Checkpoint.to_directory (twin of tests/test_checkpoint.py) ----------------


@pytest.mark.parametrize("side", ["jax", "port"])
def test_to_directory_replaces_existing_dest_atomically(tmp_path, side):
    """A committed checkpoint written by the port, copied over a stale
    ``dest`` by each package's ``Checkpoint.to_directory``: the same files
    land, the stale one is gone, no staging or retired tree is left beside
    ``dest``, and the copy restores to the saved tree."""
    from ray_tpu_torch.checkpoint.manager import step_dir
    if side == "jax":
        from ray_tpu.train import Checkpoint
    else:
        from ray_tpu_torch.train import Checkpoint
    tree = {"params": {"w": torch.arange(32.0).reshape(8, 4),
                       "emb": torch.arange(12, dtype=torch.int32)},
            "step": 7, "name": "run-a"}
    d = step_dir(str(tmp_path / "run"), 0)
    snap = F.snapshot_tree(tree)
    index, blob = F.build_shard(snap, 0, 1, 0)
    F.write_shard(d, index, blob, skeleton_pkl=snap.skeleton_pkl)
    F.commit_manifest(d, F.build_manifest(d, 0, 1))
    dest = str(tmp_path / "copy")
    os.makedirs(dest)
    with open(os.path.join(dest, "stale_garbage"), "w") as f:
        f.write("from an interrupted previous copy")
    assert Checkpoint(d).to_directory(dest) == dest
    assert sorted(os.listdir(dest)) == sorted(os.listdir(d))
    assert not os.path.exists(os.path.join(dest, "stale_garbage"))
    got = F.restore_tree(dest)
    for k, v in tree["params"].items():
        assert torch.equal(got["params"][k], v)
    assert got["step"] == 7 and got["name"] == "run-a"
    assert [n for n in os.listdir(str(tmp_path))
            if ".tmp" in n or ".old" in n] == []
    # No dest: a fresh directory; dest == the checkpoint itself: no copy.
    fresh = Checkpoint(d).to_directory()
    try:
        assert sorted(os.listdir(fresh)) == sorted(os.listdir(d))
    finally:
        import shutil
        shutil.rmtree(fresh, ignore_errors=True)
    assert Checkpoint(d).to_directory(d) == d

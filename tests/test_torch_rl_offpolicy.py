"""The port's twins of the JAX package's off-policy and offline RL tests
(``tests/test_rl.py::TestDQN``, ``tests/test_rl_breadth.py``: SAC, TQC,
BC, MARWIL, CQL, IQL on ``.npz`` shards), on the CPU, at the JAX tests'
own learning thresholds.  The parquet twins are refusals here
(``test_torch_rl_algos.py``: the port has no data pipeline yet).
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from ray_tpu_torch.rl import (BCConfig, CQLConfig, DQNConfig, IQLConfig,
                              MARWILConfig, OfflineData, SACConfig,
                              StatelessGuess, TQCConfig, collect_from_env,
                              make_env)

from _torch_rl import one_thread  # noqa: F401  (autouse)

DEV = "cpu"


class TestDQN:
    def test_learns_stateless_guess(self):
        algo = (DQNConfig()
                .environment(lambda: StatelessGuess(2))
                .env_runners(rollout_fragment_length=256)
                .training(lr=5e-3, learning_starts=64, buffer_size=4096,
                          target_update_freq=128, epsilon_decay_steps=1024,
                          train_batch_size=32)
                .debugging(seed=0).resources(device=DEV)
                .build_algo())
        for _ in range(8):
            last = algo.train()
        ret = last["env_runners"]["episode_return_mean"]
        assert ret > 0.7, f"DQN failed to learn: return={ret}"
        assert last["epsilon"] < 0.2
        assert last["buffer_size"] > 0

    def test_prioritized_replay_path(self):
        algo = (DQNConfig()
                .environment(lambda: StatelessGuess(2))
                .env_runners(rollout_fragment_length=128)
                .training(learning_starts=32, prioritized_replay=True,
                          train_batch_size=16)
                .resources(device=DEV).build_algo())
        res = algo.train()
        assert np.isfinite(res["learner"].get("loss", 0.0))


def _target_errors(algo):
    return [abs(float(algo.compute_single_action(
        np.array([t], np.float32))[0]) - t)
        for t in np.linspace(-0.8, 0.8, 9)]


class TestSAC:
    def test_learns_target_reach(self):
        cfg = (SACConfig().environment("TargetReach")
               .training(lr=3e-3, learning_starts=200, train_batch_size=64)
               .env_runners(rollout_fragment_length=200)
               .debugging(seed=0).resources(device=DEV))
        algo = cfg.build_algo()
        for _ in range(10):
            r = algo.train()
        assert r["env_runners"]["episode_return_mean"] > -0.15
        assert max(_target_errors(algo)) < 0.25
        assert r["learner"]["alpha"] != pytest.approx(0.2, abs=1e-4)

    def test_rejects_discrete_env(self):
        with pytest.raises(ValueError, match="continuous"):
            (SACConfig().environment("CartPole-v1")
             .resources(device=DEV)).build_algo()

    def test_checkpoint_roundtrip(self, tmp_path):
        cfg = (SACConfig().environment("TargetReach")
               .training(learning_starts=50)
               .env_runners(rollout_fragment_length=60).debugging(seed=0)
               .resources(device=DEV))
        algo = cfg.build_algo()
        algo.train()
        path = algo.save(str(tmp_path / "ck"))
        algo2 = cfg.copy().build_algo()
        algo2.restore(path)
        obs = np.array([0.5], np.float32)
        np.testing.assert_allclose(algo.compute_single_action(obs),
                                   algo2.compute_single_action(obs))


class TestTQC:
    def test_learns_target_reach(self):
        cfg = (TQCConfig().environment("TargetReach")
               .training(lr=3e-3, learning_starts=200, train_batch_size=64,
                         num_critics=2, num_quantiles=11,
                         top_quantiles_to_drop=2)
               .env_runners(rollout_fragment_length=200)
               .debugging(seed=0).resources(device=DEV))
        algo = cfg.build_algo()
        for _ in range(10):
            r = algo.train()
        assert r["env_runners"]["episode_return_mean"] > -0.15
        assert max(_target_errors(algo)) < 0.25


@pytest.fixture(scope="module")
def offline_dataset(tmp_path_factory):
    """Mixed expert/random behavior data on StatelessGuess."""
    d = tmp_path_factory.mktemp("offline")

    def behavior(obs, rng):
        if rng.random() < 0.3:
            return int(rng.integers(4))
        return int(np.argmax(obs))

    return collect_from_env("StatelessGuess", behavior, 4000,
                            os.path.join(str(d), "shard-0.npz"), seed=0)


def _greedy_accuracy(algo, n: int = 100) -> int:
    env = make_env("StatelessGuess")
    acc = 0
    for i in range(n):
        obs, _ = env.reset(seed=i)
        acc += int(algo.compute_single_action(obs) == int(np.argmax(obs)))
    return acc


class TestOffline:
    def test_dataset_io(self, offline_dataset, tmp_path):
        data = OfflineData(offline_dataset)
        assert data.size == 4000
        assert set(data.columns) >= {"obs", "actions", "rewards",
                                     "next_obs", "terminateds",
                                     "returns_to_go"}
        assert data.sample(32)["obs"].shape == (32, 4)
        shutil.copy(offline_dataset, tmp_path / "shard-1.npz")
        shutil.copy(offline_dataset, tmp_path / "shard-2.npz")
        assert OfflineData(str(tmp_path / "shard-*.npz")).size == 8000

    @pytest.mark.parametrize("cfg_cls,extra", [
        (BCConfig, {}),
        (MARWILConfig, {"beta": 1.0}),
        (CQLConfig, {"cql_alpha": 0.5}),
        (IQLConfig, {"expectile": 0.8, "awr_beta": 3.0})])
    def test_recovers_expert(self, offline_dataset, cfg_cls, extra):
        algo = (cfg_cls().environment("StatelessGuess")
                .offline_data(input_path=offline_dataset,
                              updates_per_iteration=100)
                .training(lr=1e-2, **extra).debugging(seed=0)
                .resources(device=DEV)).build_algo()
        for _ in range(3):
            r = algo.train()
        assert _greedy_accuracy(algo) >= 95
        if cfg_cls is CQLConfig:
            assert r["learner"]["cql_penalty"] >= 0.0
        if cfg_cls is IQLConfig:
            assert np.isfinite(r["learner"]["adv_mean"])
            assert r["learner"]["w_mean"] > 0.0
